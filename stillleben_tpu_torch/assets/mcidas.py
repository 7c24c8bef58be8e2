"""McIdas area files, read as Pillow reads them (``McIdasImagePlugin``).

A 256-byte directory of 64 big-endian words: word 11 is the bytes a pixel
(1: L, 2: I;16B, 4: I from 32-bit big-endian), words 10 and 9 the width
and height, the pixels at word 34 + word 15 with rows word 15 + width x
word 11 x word 14 bytes apart. The conversion to RGBA clips the values to
0..255, as Pillow's does.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
# word 11 -> (mode, dtype of the samples)
KINDS = {1: ("L", np.uint8), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def decode_mcidas(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    s = data[:256]
    if not accept(s) or len(s) != 256:
        raise NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack(">64i", s)
    if w[11] not in KINDS:
        raise NotThisFormat("unsupported McIdas format")
    mode, dtype = KINDS[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(width, height, name, "McIdas")
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    if offset < 0:  # Pillow's mapped modes check the offset, the others seek to it
        if mode == "I":
            raise OSError(22, "Invalid argument")
        raise ValueError("Tile offset cannot be negative")
    rows = raw_rows(data, offset, width, height, 8 * w[11], stride,
                    mapped=from_file and mode != "I")
    return to_rgba(mode, rows.view(dtype).reshape(height, width).astype(np.int64))
