"""X11 pixmap (``.xpm``), read as Pillow reads it (``XpmImagePlugin``).

Line by line as Pillow's plugin reads it: the first line matching
``"W H N K`` after the ``/* XPM */`` magic, then N colour lines whose first
K characters after the quote are a pixel's key and whose ``c`` entry is
``#rrggbb`` (kept as ``int(..., 16)``'s three low bytes) or ``None`` (the
image's transparency, which names no palette entry), then the pixel lines
(the text between a line's first and last quote, K characters a pixel; a
``/* pixels */`` line skipped once). At most 256 colours give a palette
image, more an RGB one. Pillow's failures are kept: a named colour or a
line without ``c`` raises ``ValueError``, a key the palette does not hold
``ValueError`` (palette) or ``KeyError`` (RGB), too few pixels "not enough
image data"; ``None`` sets the alpha of the first entries to its key's
bytes (``putpalettealphas``), and on an RGB image raises ``TypeError``
(``NoRGBA``, which carries what ``convert("RGB")`` reads).
"""

from __future__ import annotations

import re

import numpy as np

from .image_limits import check_size
from .pillow_open import NoRGBA, NotThisFormat, to_rgba

MAGIC = b"/* XPM */"
HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """``readline`` from ``pos`` on: (line with its newline, next pos)."""
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        yield data[pos:end]
        pos = end


def decode_xpm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not data.startswith(MAGIC):
        raise NotThisFormat("not an XPM file")
    lines = _lines(data, len(MAGIC))
    for line in lines:
        m = HEAD.match(line)
        if m:
            break
    else:
        raise NotThisFormat("broken XPM file")
    w, h, ncolours, bpp = (int(g) for g in m.groups())  # ValueError on "" as Pillow's
    palette, transparency = {}, None
    for _ in range(ncolours):
        line = next(lines, b"").rstrip()
        key = line[1: bpp + 1]
        s = line[bpp + 1: -2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise NotThisFormat("list index out of range")
                rgb = s[i + 1]
                if rgb == b"None":
                    transparency = key
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "XPM")
    rgb = ncolours > 256
    index = {k: i for i, k in enumerate(palette)}
    need = w * h
    out, header = [], False
    for line in lines:
        if len(out) >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            k = line[i: i + bpp]
            if rgb:
                out.append(palette[k])  # KeyError as Pillow's
            elif k in index:
                out.append(index[k])
            else:
                raise ValueError("tuple.index(x): x not in tuple")
    if len(out) < need:
        raise ValueError("not enough image data")
    if rgb:
        pixels = np.array(out[:need], np.uint8).reshape(h, w, 3)
        if transparency is not None:
            raise NoRGBA("'bytes' object cannot be interpreted as an integer", pixels)
        return to_rgba("RGB", pixels)
    pal = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    rgba = to_rgba("P", np.array(out[:need], np.uint8).reshape(h, w), pal)
    if transparency is not None:
        alpha = np.full(256, 255, np.uint8)
        t = np.frombuffer(transparency, np.uint8)[:256]
        alpha[: len(t)] = t
        rgba[..., 3] = alpha[np.array(out[:need], np.uint8).reshape(h, w)]
    return rgba
