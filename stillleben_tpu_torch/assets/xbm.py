"""X11 bitmap (``.xbm``), read as Pillow reads it (``XbmImagePlugin``).

The header is Pillow's regular expression over the first 512 bytes (the
``_width`` and ``_height`` defines, an optional hot spot, then anything up
to ``_bits[]``); the data is what Pillow's ``xbm`` decoder (XbmDecode.c)
takes from there: the two characters after each ``x`` as a hex byte (any
other character as 0), rows of ceil(width / 8) bytes, bits least
significant first, a set bit white. A file that ends first raises
``ImageFile``'s "image file is truncated".
"""

from __future__ import annotations

import re

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, to_rgba, truncated

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _i
for _i, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _i


def accept(data: bytes) -> bool:
    """Pillow's ``_accept``, which sees the first 16 bytes."""
    return data[:16].lstrip().startswith(b"#define")


def _hex_bytes(body: bytes, count: int) -> tuple[np.ndarray, int]:
    """The first ``count`` bytes the decoder reads, or as many as there
    are and the characters it left unprocessed."""
    xs, pos, out = [], 0, []
    buf = np.frombuffer(body, np.uint8)
    at = np.flatnonzero(buf == ord("x"))
    # a byte is an x and the two characters after it; an x inside those two
    # is a digit, so keep only the xs at least three after the last one taken
    if len(at) and (np.diff(at) >= 3).all():
        xs = at
    else:
        for p in at:
            if p >= pos:
                xs.append(p)
                pos = p + 3
        xs = np.asarray(xs, np.int64)
    whole = xs[xs + 3 <= len(buf)][:count]
    out = (_HEX[buf[whole + 1]] << 4) + _HEX[buf[whole + 2]]
    if len(whole) == count:
        return out.astype(np.uint8), 0
    left = len(buf) - int(xs[len(whole)]) if len(xs) > len(whole) else 0
    return out.astype(np.uint8), left


def decode_xbm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    m = HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "XBM")
    line = (w + 7) // 8
    vals, left = _hex_bytes(data[m.end():], line * h)
    if len(vals) < line * h:
        raise truncated(left)
    bits = np.unpackbits(vals.reshape(h, line), axis=1, bitorder="little")[:, :w]
    return to_rgba("1", bits)
