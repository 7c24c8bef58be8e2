"""QOI ("Quite OK Image"): encode as Pillow's ``save`` writes it, decode as
Pillow reads it (``QoiImagePlugin``).

- ``encode_qoi`` gives the bytes of Pillow 12's ``save`` of an RGB or
  RGBA image: the 14-byte header (``qoif``, width, height, channels and
  colorspace byte 1, as Pillow writes it unless ``colorspace="sRGB"``),
  then the chunks of Pillow's encoder (native, ``sl_qoi_encode``). Pillow
  refuses every other mode ("Unsupported QOI image mode").
- ``decode_qoi`` gives ``Image.open(p).convert("RGBA")``: a channels byte
  of 3 is RGB, any other RGBA; the colorspace byte is not read.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size

MAGIC = b"qoif"


def encode_qoi(pixels: np.ndarray) -> bytes:
    """The QOI file Pillow writes for (H, W, 3) or (H, W, 4) uint8 pixels."""
    a = np.asarray(pixels)
    if not (a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in (3, 4)):
        raise ValueError("Unsupported QOI image mode")
    h, w, c = a.shape
    return MAGIC + struct.pack(">IIBB", w, h, c, 1) + native_image.qoi_encode(a)


def decode_qoi(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not data.startswith(MAGIC) or len(data) < 14:
        raise ValueError(f"{name}: not a QOI file")
    w, h, channels = struct.unpack_from(">IIB", data, 4)
    check_size(w, h, name, "QOI")
    bands = 3 if channels == 3 else 4
    pix = native_image.qoi_decode(data[14:], w, h, bands, name)
    if bands == 4:
        return pix
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = pix
    return out
