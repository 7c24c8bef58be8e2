"""Encapsulated PostScript: written as Pillow 12.1.0's ``save`` writes it
(``EpsImagePlugin._save`` with ``eps=1``, for ``.eps`` and ``.ps`` alike).

The header comments (``%%BoundingBox``, Pillow's ``%ImageData`` line), the
``image`` (L) or ``false 3 colorimage`` (RGB) program, then the samples in
lowercase hex as Pillow's ``eps`` encoder dumps them: 39 bytes (78 hex
digits) to a line, the lines running on across the image's rows, and
after the last one the ``%%%%EndBinary`` line Pillow writes literally.
Every other mode (RGBA, I;16) fails as in Pillow: "image mode is not
supported".
"""

from __future__ import annotations

import numpy as np

LINE_BYTES = 79 // 2  # EpsEncode.c: a newline after every 39 bytes


def encode_eps(pixels: np.ndarray) -> bytes:
    """The file Pillow writes for uint8 (H, W) L or (H, W, 3) RGB pixels."""
    a = np.asarray(pixels)
    if a.dtype == np.uint8 and a.ndim == 2:
        operator = (8, 1, b"image")
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        operator = (8, 3, b"false 3 colorimage")
    else:
        raise ValueError("image mode is not supported")
    h, w = a.shape[:2]
    size = (w, h)
    out = [b"%!PS-Adobe-3.0 EPSF-3.0\n", b"%%Creator: PIL 0.1 EpsEncode\n",
           b"%%%%BoundingBox: 0 0 %d %d\n" % size, b"%%Pages: 1\n", b"%%EndComments\n",
           b"%%Page: 1 1\n", b"%%ImageData: %d %d " % size, b'%d %d 0 1 1 "%s"\n' % operator,
           b"gsave\n", b"10 dict begin\n", b"/buf %d string def\n" % (w * operator[1]),
           b"%d %d scale\n" % size, b"%d %d 8\n" % size, b"[%d 0 0 -%d 0 %d]\n" % (w, h, h),
           b"{ currentfile buf readhexstring pop } bind\n", operator[2] + b"\n"]
    digits = np.ascontiguousarray(a).tobytes().hex().encode()
    step = 2 * LINE_BYTES
    out.append(b"\n".join(digits[i: i + step] for i in range(0, len(digits), step)))
    out += [b"\n%%%%EndBinary\n", b"grestore end\n"]
    return b"".join(out)
