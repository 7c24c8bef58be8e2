"""PIXAR raster (``.pxr``), read as Pillow reads it (``PixarImagePlugin``):
a 512-byte header whose width and height are the little-endian words at
418 and 416, opened only where the channel and depth words at 424 and 426
are (14, 2) (RGB), then uncompressed RGB rows at byte 1024.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

MAGIC = b"\x80\xe8\x00\x00"


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def decode_pixar(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not accept(data):
        raise NotThisFormat("not a PIXAR file")
    s = data[:512]
    if len(s) < 428:
        raise NotThisFormat("unpack_from requires a buffer of at least 428 bytes")
    h, w = struct.unpack_from("<HH", s, 416)
    if struct.unpack_from("<HH", s, 424) != (14, 2) or w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "PIXAR")
    return to_rgba("RGB", raw_rows(data, 1024, w, h, 24).reshape(h, w, 3))
