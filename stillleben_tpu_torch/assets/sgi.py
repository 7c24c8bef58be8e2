"""SGI (``.sgi .rgb .rgba .bw``): encode as Pillow's ``save`` writes it,
decode as Pillow reads it (``SgiImagePlugin``).

- ``encode_sgi`` gives the bytes of Pillow 12's ``save`` of an L, RGB or
  RGBA image to ``path``: a 512-byte header (magic 474, no compression:
  Pillow writes no run-length SGI, 1 byte per sample, ``dimension`` 1 for a
  one-row L image, 2 for another L image and 3 for colour, the path's base
  name without its extension in ASCII, cut at 79 bytes), then each channel
  as a plane, rows bottom-up. Pillow refuses I;16 ("Unsupported SGI image
  mode") and a side over 65535.
- ``decode_sgi`` gives ``Image.open(p).convert("RGBA")``: Pillow's
  ``MODES`` table (1 or 2 bytes per sample, ``dimension`` 1 or 2 for one
  channel and 3 for three or four), planes uncompressed or run-length
  (native, ``sl_sgi_rle_decode``, with the offset and length tables of
  ``SgiRleDecode.c``), rows bottom-up. Two-byte samples keep their high
  byte (the modes are ``L;16B``, ``RGB;16B``, ``RGBA;16B``). A compression
  byte other than 0 and 1 raises ``OSError`` as Pillow's ``load`` does.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import native_image
from .image_limits import check_size

MAGIC = 474
HEADER = 512
# (bytes per sample, dimension, channels) -> Pillow's mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def is_sgi(data: bytes) -> bool:
    return len(data) >= 2 and struct.unpack(">H", data[:2])[0] == MAGIC


def encode_sgi(pixels: np.ndarray, path: str) -> bytes:
    """The SGI file Pillow writes for (H, W), (H, W, 3) or (H, W, 4) uint8
    pixels saved to ``path``."""
    a = np.asarray(pixels)
    if not (a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4)))):
        raise ValueError("Unsupported SGI image mode")
    h, w = a.shape[:2]
    if w > 0xFFFF or h > 0xFFFF:
        raise ValueError(f"SGI: {w}x{h} does not fit the header's 16-bit sizes")
    planes = a[..., None] if a.ndim == 2 else a
    z = planes.shape[2]
    dimension = (1 if h == 1 else 2) if a.ndim == 2 else 3
    name = os.path.splitext(os.path.basename(path))[0].encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll", MAGIC, 0, 1, dimension, w, h, z, 0, 255) + bytes(4)
            + struct.pack("79s", name) + bytes(1) + struct.pack(">l", 0) + bytes(404))
    return head + np.ascontiguousarray(planes[::-1].transpose(2, 0, 1)).tobytes()


def decode_sgi(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not is_sgi(data) or len(data) < HEADER:
        raise ValueError(f"{name}: not an SGI file")
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">HHHH", data, 4)
    mode = MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError(f"{name}: Unsupported SGI image mode (bpc {bpc}, dimension "
                         f"{dimension}, zsize {zsize})")
    check_size(xsize, ysize, name, "SGI")
    bands = len(mode)
    if compression == 0:
        n = xsize * ysize * bands * bpc
        if len(data) < HEADER + n:
            raise OSError(f"{name}: image file is truncated")
        planes = np.frombuffer(data, np.uint8, n, HEADER).reshape(bands, ysize, xsize, bpc)
        pix = planes[..., 0].transpose(1, 2, 0)  # the high byte of a 2-byte sample
    elif compression == 1:
        rows = native_image.sgi_rle_decode(data, xsize, ysize, bands, bpc, name)
        pix = rows.reshape(ysize, xsize, bands, bpc)[..., 0]
    else:
        raise OSError(f"{name}: cannot load this image (SGI compression {compression})")
    pix = pix[::-1]
    out = np.empty((ysize, xsize, 4), np.uint8)
    out[..., :3] = pix[..., :3] if bands >= 3 else pix[..., :1]
    out[..., 3] = pix[..., 3] if bands == 4 else 255
    return out
