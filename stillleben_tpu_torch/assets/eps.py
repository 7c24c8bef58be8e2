"""Encapsulated PostScript: written as Pillow 12.1.0's ``save`` writes it
(``EpsImagePlugin._save`` with ``eps=1``, for ``.eps`` and ``.ps`` alike).

The header comments (``%%BoundingBox``, Pillow's ``%ImageData`` line), the
``image`` (L) or ``false 3 colorimage`` (RGB) program, then the samples in
lowercase hex as Pillow's ``eps`` encoder dumps them: 39 bytes (78 hex
digits) to a line, the lines running on across the image's rows, and
after the last one the ``%%%%EndBinary`` line Pillow writes literally.
Every other mode (RGBA, I;16) fails as in Pillow: "image mode is not
supported".

``decode_eps`` is Pillow's reading on a host without Ghostscript (Pillow
renders EPS through it): the header parsed as ``EpsImageFile._open``
parses it (a file it does not take falls through to the next format,
``NotThisFormat``; "bad EPS header" and "cannot determine EPS bounding
box" raise ``OSError``), then the load's ``OSError`` "Unable to locate
Ghostscript on paths".
"""

from __future__ import annotations

import re
import struct

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat

LINE_BYTES = 79 // 2  # EpsEncode.c: a newline after every 39 bytes
SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}


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


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"%!PS") or (len(prefix) >= 4
                                          and struct.unpack("<I", prefix[:4])[0] == 0xC6D3D0C5)


def _size(data: bytes) -> tuple[int, int]:
    """``EpsImageFile._open``'s size: the ``%ImageData`` columns and rows, or
    the bounding box's extent."""
    if data[:4] == b"%!PS":
        pos = 0
    elif len(data) >= 4 and struct.unpack("<I", data[:4])[0] == 0xC6D3D0C5:
        if len(data) < 12:
            raise NotThisFormat("unpack_from requires a buffer of at least 4 bytes")
        pos = struct.unpack_from("<I", data, 4)[0]
    else:
        raise NotThisFormat("not an EPS file")
    info: dict[str, str] = {}
    box, imagedata = None, None
    line = bytearray()
    header, trailer_comments, trailer = True, False, False

    def required():
        if "PS-Adobe" not in info:
            raise NotThisFormat('EPS header missing "%!PS-Adobe" comment')
        if "BoundingBox" not in info:
            raise NotThisFormat('EPS header missing "%%BoundingBox" comment')

    def comment(s: str) -> bool:
        nonlocal box, trailer_comments
        m = SPLIT.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer_comments = True
            elif not box or (trailer and trailer_comments):
                try:
                    box = [int(float(i)) for i in v.split()]
                except Exception:  # noqa: BLE001  (Pillow ignores a bad box)
                    pass
        return True

    while True:
        byte = data[pos: pos + 1]
        pos += 1
        if byte == b"":
            if not line:
                if header:
                    required()
                break
        elif byte in b"\r\n":
            if not line:
                continue
        else:
            if len(line) >= 255:
                if line[0] == ord("%"):
                    raise NotThisFormat("not an EPS file")
                if header:
                    required()
                    header = False
                line = bytearray()
            line += byte
            continue
        if header:
            if line[:1] != b"%" or line[:13] == b"%%EndComments":
                required()
                header = False
                line = bytearray()
                continue
            s = line.decode("latin-1")
            if not comment(s):
                m = FIELD.match(s)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = ""
                elif s[0] != "%":
                    raise OSError("bad EPS header")
        elif line[:11] == b"%ImageData:":
            if imagedata:
                line = bytearray()
                continue
            columns, rows, bits, mode_id = (int(v) for v in line[11:].split(None, 7)[:4])
            if bits == 8 and mode_id not in MODES:
                raise NotThisFormat(str(mode_id))
            if bits not in (1, 8):
                break
            imagedata = columns, rows
        elif line[:5] == b"%%EOF":
            break
        elif trailer and trailer_comments:
            comment(line.decode("latin-1"))
        elif line[:9] == b"%%Trailer":
            trailer = True
        elif line[:14] == b"%%BeginBinary:":
            pos += int(line[14:])
        line = bytearray()
    if not box:
        raise OSError("cannot determine EPS bounding box")
    return imagedata or (box[2] - box[0], box[3] - box[1])


def decode_eps(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Pillow's reading without Ghostscript: raises (see the module)."""
    w, h = _size(data)
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "EPS")
    raise OSError("Unable to locate Ghostscript on paths")
