"""PCX (and DCX, a table of PCX frames): encode as Pillow's ``save`` writes
it, decode as Pillow reads it (``PcxImagePlugin``, ``DcxImagePlugin``).

- ``encode_pcx`` gives the bytes of Pillow 12's ``save`` of an L or RGB
  image: the 128-byte header (version 5, 8 bits, 1 or 3 planes, 100 dpi, a
  stride rounded up to even), the run-length rows of ``PcxEncode.c``
  (native, ``sl_pcx_encode``: runs end at 63 and at each plane's line, a
  byte of 0xC0 or more is always a run) and, after an L image, the 0x0C
  marker and a grey palette. Pillow refuses RGBA and I;16 ("Cannot save
  RGBA images as PCX").
- ``decode_pcx`` gives ``Image.open(p).convert("RGBA")``: 1 bit in 1
  plane; 1 bit in 2 or 4 planes with the header's 16-colour palette; 8
  bits in 1 plane (version 5), which is L where the file's last 769 bytes
  are 0x0C and the grey ramp and P with that palette otherwise; 8 bits in
  3 planes (version 5). The rows are run-length decoded as ``PcxDecode.c``
  does (native, ``sl_pcx_decode``), then unpacked as Pillow unpacks them:
  its stride is recomputed from the width (and made even where the
  header's differs); at 8 bits the planes of a row are moved together
  where the row is not a whole number of widths and then taken a width
  apart, at 1 bit they are taken a stride apart.
- ``decode_dcx`` gives frame 0 of a DCX file (Pillow reads the palette of
  an 8-bit frame from the end of the whole file).
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size

DCX_MAGIC = 0x3ADE68B1
GREY_PALETTE = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))


def is_pcx(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def is_dcx(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack("<I", data[:4])[0] == DCX_MAGIC


def encode_pcx(pixels: np.ndarray) -> bytes:
    """The PCX file Pillow writes for (H, W) or (H, W, 3) uint8 pixels."""
    a = np.asarray(pixels)
    if a.dtype == np.uint8 and a.ndim == 2:
        planes, rows = 1, a
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        planes, rows = 3, a.transpose(0, 2, 1).reshape(a.shape[0], -1)  # RGB;L: R, G, B lines
    else:
        mode = "RGBA" if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 4 else "I;16"
        raise ValueError(f"Cannot save {mode} images as PCX")
    h, w = a.shape[:2]
    stride = w + w % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100, 100) + bytes(24)
            + b"\xff" * 24 + bytes(1) + struct.pack("<BHHHH", planes, stride, 1, w, h) + bytes(54))
    body = native_image.pcx_encode(rows, planes)
    return head + body + (GREY_PALETTE if planes == 1 else b"")


def _unpack_bits(rows: np.ndarray, width: int, offset: int = 0) -> np.ndarray:
    """Bits MSB first from byte ``offset`` of each row: (H, width) of 0/1."""
    nbytes = (width + 7) // 8
    return np.unpackbits(rows[:, offset: offset + nbytes], axis=1)[:, :width]


def _decode_frame(data: bytes, pos: int, name: str) -> np.ndarray:
    s = data[pos: pos + 68]
    if len(s) < 68 or not is_pcx(s):
        raise ValueError(f"{name}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    width, height = x1 + 1 - x0, y1 + 1 - y0
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    (provided_stride,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        kind = "1"
    elif bits == 1 and planes in (2, 4):
        kind = "P;%dL" % planes
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        kind = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12 and tail != GREY_PALETTE:
            kind = "P"
            palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        kind = "RGB;L"
    else:
        raise OSError(f"{name}: unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    check_size(width, height, name, "PCX")
    stride = (width * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    rows = native_image.pcx_decode(data[pos + 128:], row_bytes, height, name)
    if bits == 8 and row_bytes % width and row_bytes > width:  # the planes moved together
        bands = row_bytes // width
        band_stride = row_bytes // bands
        for i in range(1, bands):
            rows[:, i * width: (i + 1) * width] = rows[:, i * band_stride: i * band_stride + width]
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if kind == "1":
        out[..., :3] = (_unpack_bits(rows, width) * 255)[..., None]
    elif kind.startswith("P;"):
        index = sum(_unpack_bits(rows, width, p * stride).astype(np.int64) << p
                    for p in range(planes))
        out[..., :3] = palette[index]
    elif kind == "RGB;L":
        out[..., :3] = rows[:, : 3 * width].reshape(height, 3, width).transpose(0, 2, 1)
    else:
        grey = rows[:, :width]
        out[..., :3] = palette[grey] if kind == "P" else grey[..., None]
    return out


def decode_pcx(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    return _decode_frame(data, 0, name)


def decode_dcx(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Frame 0 of a DCX file, (H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not is_dcx(data) or len(data) < 8:
        raise ValueError(f"{name}: not a DCX file")
    (offset,) = struct.unpack_from("<I", data, 4)
    if not offset:
        raise EOFError(f"{name}: a DCX file without frames")
    return _decode_frame(data, offset, name)
