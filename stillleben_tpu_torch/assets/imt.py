"""IM Tools images, read as Pillow reads them (``ImtImagePlugin``).

No magic: Pillow tries IMT after IM on any file with a newline in its
first 100 bytes, reading ``key value`` lines (``width``, ``height``,
``pixel n8`` for L; ``*`` lines are comments) up to a form feed, where the
8-bit pixels begin. A line Pillow cannot parse ends the header; without a
form feed the file opens but does not load ("cannot load this image").
"""

from __future__ import annotations

import re

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    buffer, pos = data[:100], min(len(data), 100)
    if b"\n" not in buffer:
        raise NotThisFormat("not an IM file")
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos: pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[pos: pos + 100]
            pos = min(len(data), pos + 100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            w = int(v)
        elif k == b"height":
            h = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "IMT")
    if offset is None:
        raise OSError("cannot load this image")
    return to_rgba("L", raw_rows(data, offset, w, h, 8, mapped=from_file))
