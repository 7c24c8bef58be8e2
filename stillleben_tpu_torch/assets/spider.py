"""SPIDER 2-D images, read as Pillow reads them (``SpiderImagePlugin``).

Pillow has no magic test for SPIDER: it tries the format on every file no
earlier plugin took (after PSD, QOI and SGI, before Sun raster and TGA)
and takes it where ``isSpiderHeader`` accepts the first 23 of 27 header
floats, big-endian first, then little-endian: the header fields 1, 2, 5,
12, 13, 22 and 23 integral, an ``iform`` of 1, 3, -11, -12, -21 or -22 and
``labbyt == labrec * lenbyt``. Only ``iform`` 1 (a 2-D image) opens; the
pixels are float32 in the header's byte order after ``labbyt`` bytes (for
a stack, image 0 after twice that), converted to RGBA as Pillow converts
F (``_f2l``).
"""

from __future__ import annotations

import struct

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def spider_header(t: tuple) -> int:
    """``isSpiderHeader``: the header's length in bytes, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def decode_spider(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")`` of image 0."""
    f = data[:108]
    if len(f) < 108:
        raise NotThisFormat("not a valid Spider file")
    order = ">"
    t = struct.unpack(">27f", f)
    hdrlen = spider_header(t)
    if hdrlen == 0:
        order = "<"
        t = struct.unpack("<27f", f)
        hdrlen = spider_header(t)
    if hdrlen == 0:
        raise NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a Spider 2D image")
    size = int(h[12]), int(h[2])  # ValueError, OverflowError as Pillow's
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        int(h[26])  # the stack's count, read (and failing) as Pillow reads it
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:  # Pillow needs the stack's offset here
        raise AttributeError("'SpiderImageFile' object has no attribute 'stkoffset'")
    else:
        raise NotThisFormat("inconsistent stack header values")
    w, hgt = size
    if w <= 0 or hgt <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, hgt, name, "SPIDER")
    rows = raw_rows(data, offset, w, hgt, 32)
    return to_rgba("F", rows.view(order + "f4").reshape(hgt, w))
