"""XV thumbnails (``P7 332``), read as Pillow reads them
(``XVThumbImagePlugin``): the rest of the magic's line and the ``#``
comment lines skipped, the width and height from the next line, then
8-bit indices into Pillow's 3-3-2 palette (red and green in 8 steps of
255 / 7, blue in 4 of 255 / 3, each truncated).
"""

from __future__ import annotations

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

MAGIC = b"P7 332"
_R, _G, _B = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
PALETTE = np.stack([_R * 255 // 7, _G * 255 // 7, _B * 255 // 3], -1).reshape(256, 3).astype(
    np.uint8)


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def _readline(data: bytes, pos: int) -> tuple[bytes, int]:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not accept(data):
        raise NotThisFormat("not an XV thumbnail file")
    _, pos = _readline(data, len(MAGIC))
    while True:
        s, pos = _readline(data, pos)
        if not s:
            raise NotThisFormat("Unexpected EOF reading XV thumbnail file")
        if s[0] != ord("#"):
            break
    w, h = (int(v) for v in s.strip().split(maxsplit=2)[:2])  # ValueError as Pillow's
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "XV thumbnail")
    return to_rgba("P", raw_rows(data, pos, w, h, 8, mapped=from_file), PALETTE)
