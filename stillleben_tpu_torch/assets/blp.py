"""Blizzard Mipmap (``.blp``), BLP1 and BLP2, read as Pillow reads them
(``BlpImagePlugin``).

- BLP1: a JPEG mip level (the shared JPEG header, then the level's data,
  decoded by the port's JPEG decoder, its RGB read as BGR as Pillow
  reads it, CMYK without Pillow's inversion), or 8-bit palette indices
  (encodings 4 and 5) into a 256-entry BGRA palette read right after the
  header, the indices right after the palette.
- BLP2: palette indices at the level's offset (the palette after the
  header), or DXT1, DXT3 and DXT5 blocks decoded as Pillow's Python
  decoders decode them (native ``sl_blp_dxt_decode``: 565 endpoints
  shifted without replicating bits, the interpolations floored; DXT1's
  alpha only where the header's alpha flag is set). Not BcnDecode.c, which
  the DDS and FTEX readers share. The decoded rows are whole blocks, and
  Pillow reads them as a raw image of the header's size, so a width that
  is not a multiple of 4 shears the image, as it does in Pillow.

The image is RGBA where the header's alpha flag is set, else RGB. Pillow's
failures are kept: an unknown compression or encoding raises
``NotImplementedError`` (``BLPFormatError``), data cut short "Truncated
File Read" (``OSError``), too few pixels "not enough image data".
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size
from .jpeg import MAGIC as JPEG_MAGIC
from .jpeg import decode_jpeg
from .pillow_open import NotThisFormat, to_rgba

DXT = {0: 1, 1: 3, 7: 5}  # alpha encoding -> DXT kind


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"BLP1", b"BLP2"))


class BLPFormatError(NotImplementedError):
    pass


def _read(data: bytes, pos: int, n: int) -> tuple[bytes, int]:
    """``ImageFile._safe_read``."""
    if n <= 0:
        return b"", pos
    if len(data) < pos + n:
        raise OSError("Truncated File Read")
    return data[pos: pos + n], pos + n


def _palette(data: bytes, pos: int) -> tuple[np.ndarray, int]:
    """256 BGRA entries as RGBA."""
    raw, pos = _read(data, pos, 1024)
    return np.frombuffer(raw, np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]], pos


def _jpeg_rgb(data: bytes, name: str) -> np.ndarray:
    """``JpegImageFile(...).convert("RGB")``, CMYK read uninverted."""
    if not data.startswith(JPEG_MAGIC):
        raise SyntaxError("not a JPEG file")
    px = native_image.jpeg_decode(data, name)
    if px.ndim == 3 and px.shape[2] == 4:
        return native_image.cmyk_convert(255 - px, opencv=False)[..., :3]
    return decode_jpeg(data, name)[..., :3]


def decode_blp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    magic = data[:4]
    if not accept(magic):
        raise BLPFormatError(f"Bad BLP magic {magic!r}")
    if len(data) < (28 if magic == b"BLP1" else 20):
        raise NotThisFormat("unpack requires a buffer of 4 bytes")
    (compression,) = struct.unpack_from("<i", data, 4)
    if magic == b"BLP1":
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        offset = 28
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = struct.unpack_from("<II", data, 12)
        offset = 20
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "BLP")
    mode = "RGBA" if alpha else "RGB"
    bpp = len(mode)
    head, pos = _read(data, offset, 128)
    offsets = struct.unpack_from("<16I", head)
    (length,) = struct.unpack_from("<I", head, 64)
    if magic == b"BLP1":
        if compression == 0:
            size_raw, pos = _read(data, pos, 4)
            jpeg_header, pos = _read(data, pos, struct.unpack("<I", size_raw)[0])
            _, pos = _read(data, pos, offsets[0] - pos)
            body, pos = _read(data, pos, length)
            rgb = _jpeg_rgb(jpeg_header + body, name)
            check_size(rgb.shape[1], rgb.shape[0], name, "JPEG")
            flat = np.ascontiguousarray(rgb[..., ::-1]).reshape(-1, 3)
            if bpp == 4:
                flat = np.concatenate([flat, np.full((len(flat), 1), 255, np.uint8)], 1)
        elif compression == 1:
            if encoding not in (4, 5):
                raise BLPFormatError(f"Unsupported BLP encoding {encoding!r}")
            palette, pos = _palette(data, pos)
            idx, pos = _read(data, pos, length)
            flat = palette[np.frombuffer(idx, np.uint8)][:, :bpp]
        else:
            raise BLPFormatError(f"Unsupported BLP compression {encoding!r}")
    else:
        palette, pos = _palette(data, pos)
        pos = offsets[0]
        if compression != 1:
            raise BLPFormatError(f"Unknown BLP compression {compression!r}")
        if encoding == 1:
            idx, pos = _read(data, pos, length)
            flat = palette[np.frombuffer(idx, np.uint8)][:, :bpp]
        elif encoding == 2:
            if alpha_encoding not in DXT:
                raise BLPFormatError(f"Unsupported alpha encoding {alpha_encoding!r}")
            kind = DXT[alpha_encoding]
            blocks, block_rows = (w + 3) // 4, (h + 3) // 4
            line = blocks * (8 if kind == 1 else 16)
            if block_rows and len(data) < pos + line * block_rows:
                raise OSError("Truncated File Read")
            px = native_image.blp_dxt_decode(data[pos: pos + line * block_rows], kind, alpha,
                                             blocks, block_rows)
            flat = px.reshape(-1)
        else:
            raise BLPFormatError(f"Unknown BLP encoding {encoding!r}")
    flat = np.ascontiguousarray(flat).reshape(-1)
    if len(flat) < w * h * bpp:
        raise ValueError("not enough image data")
    return to_rgba(mode, flat[: w * h * bpp].reshape(h, w, bpp))
