"""Sun raster (``.ras``), read as Pillow reads it (``SunImagePlugin``) and
as OpenCV reads it (``grfmt_sunras.cpp``): two different readings.

- ``decode_sun`` gives ``Image.open(p).convert("RGBA")``: depths 1 (black
  where a bit is 0), 4 and 8 (grey, or palette indices when the file has
  an RGB palette of at most 1024 bytes, stored plane after plane; entries
  past its end are black), 24 and 32 (BGR and BGRX, RGB and RGBX for type
  3: Pillow's raw modes, the fourth byte dropped); rows padded to 16 bits;
  type 2 is run-length coded (native ``sl_sun_rle_decode``,
  SunRleDecode.c: rows unpadded, runs carry over into the next row). Another depth or type, a palette over 1024 bytes or
  of another kind is not Pillow's Sun raster (``NotThisFormat``); a 1-bit
  image with a palette raises ``ValueError`` as Pillow's conversion does.
- ``decode_sun_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)``: OpenCV 5 reads types 0 and 1 only (its test of the
  run-length and RGB types never passes) at depths 1, 8, 24 and 32, with no
  palette or an RGB palette of 1 to 3 x 2^depth bytes (depths 1 and 8):
  BGR rows, the first byte of a 32-bit pixel dropped, palettes expanded to
  BGR unless every entry is grey, which gives one channel of the palette's
  values; grey without a palette reads as zeros (OpenCV fills no grey
  table then). Anything else, and a file shorter than its rows, gives None;
a size over OpenCV's limits raises ``ValueError`` where ``imread`` raises.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba, truncated, unpack_bits, unpack_nibbles

MAGIC = 0x59A66A95


def is_sun(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack(">I", data[:4])[0] == MAGIC


def _header(data: bytes) -> tuple:
    if len(data) < 32:
        raise NotThisFormat("not an SUN raster file")
    return struct.unpack(">8I", data[:32])


def decode_sun(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not is_sun(data):
        raise NotThisFormat("not an SUN raster file")
    _, w, h, depth, _, ftype, ptype, plen = _header(data)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat("Unsupported Mode/Bit Depth")
    mode = "1" if depth == 1 else "L" if depth in (4, 8) else "RGB"
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise NotThisFormat("Unsupported Color Palette Length")
        if ptype != 1:
            raise NotThisFormat("Unsupported Palette Type")
        offset += plen
        raw = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(raw) // 3
        palette = raw[: 3 * n].reshape(3, n).T
        if mode == "L":
            mode = "P"
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("Unsupported Sun Raster file type")
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "Sun raster")
    if mode == "1" and palette is not None:
        raise ValueError("unrecognized image mode")
    if ftype == 2:
        line = (w * depth + 7) // 8
        rows, left = native_image.sun_rle_decode(data[offset:], line, h)
        if left is not None:
            raise truncated(left)
    else:
        rows = raw_rows(data, offset, w, h, depth, ((w * depth + 15) // 16) * 2)
    if depth == 1:
        v = 1 - unpack_bits(rows, w)
    elif depth == 4:
        v = unpack_nibbles(rows, w)
        v = v if mode == "P" else (v * 17).astype(np.uint8)
    elif depth == 8:
        v = rows[:, :w]
    else:
        px = rows[:, : w * depth // 8].reshape(h, w, depth // 8)
        px = px[..., :3]  # BGRX / RGBX: Pillow drops the last byte
        v = px if ftype == 3 else px[..., ::-1]
    return to_rgba(mode, v, palette)


def decode_sun_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """``cv2.imread``'s array, or None where OpenCV reads nothing."""
    if len(data) < 32 or not is_sun(data):
        return None
    _, w, h, bpp, _, ftype, maptype, maplen = _header(data)
    w, h = (v - (1 << 32) if v >= 1 << 31 else v for v in (w, h))  # OpenCV's ints
    pal_size = 3 * (1 << bpp) if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and ftype in (0, 1)
            and ((maptype == 0 and maplen == 0)
                 or (maptype == 1 and 0 < maplen <= pal_size and bpp <= 8))):
        return None
    check_size(w, h, name, "Sun raster", cv2=True)
    palette = np.zeros((256, 3), np.uint8)  # BGR
    grey = True
    if maplen:
        if len(data) < 32 + maplen:
            return None
        buf = np.frombuffer(data, np.uint8, maplen, 32)
        n = maplen // 3
        palette[:n] = np.stack([buf[2 * n: 3 * n], buf[n: 2 * n], buf[:n]], -1)
        used = palette[: 1 << bpp]
        grey = bool((used[:, 0] == used[:, 1]).all() and (used[:, 0] == used[:, 2]).all())
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    offset = 32 + maplen
    if len(data) < offset + pitch * h:
        return None
    rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
    if bpp == 24:
        return rows[:, : 3 * w].reshape(h, w, 3).copy()
    if bpp == 32:
        return rows[:, : 4 * w].reshape(h, w, 4)[..., 1:].copy()
    idx = unpack_bits(rows, w) if bpp == 1 else rows[:, :w]
    if grey:
        # the grey table: the palette's values with one, zeros without
        return palette[idx, 0] if maplen else np.zeros((h, w), np.uint8)
    return palette[idx]
