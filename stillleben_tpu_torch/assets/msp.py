"""Microsoft Paint (``.msp``), read as Pillow reads it (``MspImagePlugin``).

A 32-byte header whose 16-bit words XOR to zero; version 1 (``DanM``, what
Pillow's ``save`` writes) is raw 1-bit rows, most significant bit first,
a set bit white; version 2 (``LinS``) has a map of each row's encoded
length, then the rows run-length coded (native ``sl_msp_rle_decode``:
Pillow's ``MspDecoder``, a row of length 0 white), the concatenated output
read as the raw rows. Pillow's failures: "Truncated MSP file in row map",
"Truncated MSP file, expected N bytes on row Y", "Corrupted MSP file in
row Y" (``OSError``), too little output "not enough image data"
(``ValueError``).
"""

from __future__ import annotations

import numpy as np

from . import native_image
from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba, unpack_bits


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def decode_msp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    s = data[:32]
    if not accept(s):
        raise NotThisFormat("not an MSP file")
    if len(s) < 32:
        raise NotThisFormat("unpack_from requires a buffer of at least 2 bytes")
    words = np.frombuffer(s, "<u2")
    if np.bitwise_xor.reduce(words) != 0:
        raise NotThisFormat("bad MSP checksum")
    w, h = int(words[2]), int(words[3])
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "MSP")
    line = (w + 7) // 8
    if s.startswith(b"DanM"):
        rows = raw_rows(data, 32, w, h, 1)
    else:
        if len(data) < 32 + 2 * h:
            raise OSError("Truncated MSP file in row map")
        rowmap = np.frombuffer(data, "<u2", h, 32)
        out, rc, row = native_image.msp_rle_decode(data[32 + 2 * h:], rowmap, line)
        if rc == 1:
            raise OSError(f"Truncated MSP file, expected {int(rowmap[row])} bytes on row {row}")
        if rc == 2:
            raise OSError(f"Corrupted MSP file in row {row}")
        if len(out) < line * h:
            raise ValueError("not enough image data")
        rows = np.frombuffer(out, np.uint8, line * h).reshape(h, line)
    return to_rgba("1", unpack_bits(rows, w))
