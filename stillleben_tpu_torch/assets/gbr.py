"""GIMP brush (``.gbr``), read as Pillow reads it (``GbrImagePlugin``).

Version 1 (a 20-byte header and a comment) and version 2 (28 bytes with
the ``GIMP`` magic and the spacing), of 1 byte a pixel (L) or 4 (RGBA),
the pixels after the header's size. Pillow's ``_accept`` is weak (a
header size of at least 20, then version 1 or 2): a file that passes it
but is no brush falls through to the next format (``NotThisFormat``) as in
Pillow; too few pixels raise "not enough image data" (``ValueError``).
"""

from __future__ import annotations

import struct

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, file_read, to_rgba


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and struct.unpack(">I", prefix[:4])[0] >= 20
            and struct.unpack(">I", prefix[4:8])[0] in (1, 2))


def decode_gbr(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if len(data) < 8:
        raise NotThisFormat("unpack_from requires a buffer of at least 4 bytes")
    header_size, version = struct.unpack(">II", data[:8])
    if header_size < 20:
        raise NotThisFormat("not a GIMP brush")
    if version not in (1, 2):
        raise NotThisFormat(f"Unsupported GIMP brush version: {version}")
    if len(data) < 20:
        raise NotThisFormat("unpack_from requires a buffer of at least 4 bytes")
    width, height, depth = struct.unpack(">III", data[8:20])
    if width == 0 or height == 0:
        raise NotThisFormat("not a GIMP brush")
    if depth not in (1, 4):
        raise NotThisFormat(f"Unsupported GIMP brush color depth: {depth}")
    pos = 20
    if version == 1:
        comment = header_size - 20
    else:
        comment = header_size - 28
        if data[20:24] != b"GIMP":
            raise NotThisFormat("not a GIMP brush, bad magic number")
        if len(data) < 28:
            raise NotThisFormat("unpack_from requires a buffer of at least 4 bytes")
        pos = 28
    pos += len(file_read(data, pos, comment, from_file))
    check_size(width, height, name, "GBR")
    n = width * height * depth
    if len(data) - pos < n:
        raise ValueError("not enough image data")
    px = np.frombuffer(data, np.uint8, n, pos)
    if depth == 1:
        return to_rgba("L", px.reshape(height, width))
    return to_rgba("RGBA", px.reshape(height, width, 4))
