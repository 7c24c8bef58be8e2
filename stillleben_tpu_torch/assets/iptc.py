"""IPTC/NAA records (``.iim``), read as Pillow reads them
(``IptcImagePlugin``).

No magic: Pillow tries IPTC on any file no earlier plugin took. Fields are
``0x1C``, a record and dataset number, and a length (two bytes, or 1 to 4
more for lengths over 32767); the fields before the first object data
field (8, 10) give the layers and components (3, 60), the band (3, 65),
the size (3, 20 and 3, 30) and the compression (3, 120: 1 raw, 5 JPEG).
The object data fields are joined and opened as an image of their own:
raw data behind a P5 header of the record's size (the port's Netpbm
reader), JPEG data through the port's JPEG decoder (any image the joined
bytes hold is read, as Pillow's ``Image.open`` reads it). A one-layer image
without components is that image; otherwise it is the band (3, 65) of an
RGB (3 layers) or CMYK (4) image whose other bands are black. Pillow's
failures are kept: an unknown compression, a field longer than 132 length
bytes (``OSError``), no image data ("cannot load this image").
"""

from __future__ import annotations

import struct

import numpy as np

from . import im as im_module
from .image_limits import check_size
from .jpeg import MAGIC as JPEG_MAGIC
from .pillow_open import NotThisFormat, to_rgba

COMPRESSION = {1: "raw", 5: "jpeg"}
RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(data: bytes, pos: int):
    """``IptcImageFile.field``: (tag, size, next position), raising what
    Pillow's raises."""
    s = data[pos: pos + 5]
    pos += len(s)
    if not s.strip(b"\0"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in RECORDS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        c = data[pos: pos + size - 128]
        pos += len(c)
        size = _i(c)
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _open(data: bytes):
    """``IptcImageFile._open``: (mode, band, size, compression, offset of
    the first object data field or None)."""
    info, pos = {}, 0
    while True:
        offset = pos
        tag, size, pos = _field(data, pos)
        if not tag or tag == (8, 10):
            break
        tagdata = data[pos: pos + size] if size else None
        pos += len(tagdata or b"")
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except KeyError as e:
        raise OSError("Unknown IPTC image compression") from e
    return mode, band, size, compression, offset if tag == (8, 10) else None


def decode_iptc(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    from .image import decode_image

    try:
        mode, band, size, compression, offset = _open(data)
    except (SyntaxError, IndexError, TypeError, KeyError, struct.error) as e:
        raise NotThisFormat(str(e)) from e
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(*size, name, "IPTC")
    if offset is None:
        raise OSError("cannot load this image")
    # load: the object data fields, joined and opened as an image
    body = [b"P5\n%d %d\n255\n" % size] if compression == "raw" else []
    pos = offset
    while True:
        kind, n, pos = _field(data, pos)
        if kind != (8, 10):
            break
        chunk = data[pos: pos + n]
        pos += len(chunk)
        body.append(chunk)
    embedded = b"".join(body)
    rgba = decode_image(embedded, "<_io.BytesIO object>")
    if band is None:
        return rgba
    grey = embedded[:2] == b"P5" or (embedded.startswith(JPEG_MAGIC)
                                     and _jpeg_components(embedded) == 1)
    if not grey:
        raise ValueError("mode mismatch")
    bands = np.zeros(rgba.shape[:2] + (len(mode),), np.uint8)
    bands[..., band] = rgba[..., 0]
    if mode == "CMYK":
        return to_rgba("RGB", im_module._cmyk_to_rgb(bands))
    return to_rgba(mode, bands)


def _jpeg_components(data: bytes) -> int:
    from . import native_image

    return native_image.jpeg_info(data)["components"]
