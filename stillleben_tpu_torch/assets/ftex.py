"""FTEX (``.ftc .ftu``, Independence War 2), read as Pillow reads it
(``FtexImagePlugin``): one mip level's data, DXT1 blocks (``.ftc``; the
``bcn`` decoder DDS uses, native ``sl_bcn_decode``) as RGBA or raw RGB
(``.ftu``). Pillow's failures are kept: a format count other than 1 fails
its ``assert``, another texture format raises ``ValueError``, a mip level
cut short "image file is truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size
from .pillow_open import NotThisFormat, file_read, raw_rows, to_rgba, truncated

MAGIC = b"FTEX"


def accept(prefix: bytes) -> bool:
    return prefix.startswith(MAGIC)


def _ints(data: bytes, pos: int, n: int) -> tuple:
    if len(data) < pos + 4 * n:
        raise NotThisFormat(f"unpack requires a buffer of {4 * n} bytes")
    return struct.unpack_from(f"<{n}i", data, pos)


def decode_ftex(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not accept(data):
        raise NotThisFormat("not an FTEX file")
    _ints(data, 4, 1)  # the version
    w, h = _ints(data, 8, 2)
    _, format_count = _ints(data, 16, 2)
    if format_count != 1:
        raise AssertionError()
    fmt, where = _ints(data, 24, 2)
    if where < 0:
        raise OSError(22, "Invalid argument")
    (size,) = _ints(data, where, 1)
    mip = file_read(data, where + 4, size, from_file)
    if fmt not in (0, 1):
        raise ValueError(f"Invalid texture compression format: {fmt!r}")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "FTEX")
    if fmt == 1:
        return to_rgba("RGB", raw_rows(mip, 0, w, h, 24).reshape(h, w, 3))
    need = ((w + 3) // 4) * ((h + 3) // 4) * 8
    if len(mip) < need:
        raise truncated(len(mip) % 8)
    return native_image.bcn_decode(mip[:need], 1, False, w, h, name)
