"""Windows icons and cursors: ICO written as Pillow 12.1.0's ``save``
writes it, ICO and CUR read as ``Image.open(p).convert("RGBA")`` reads
them.

Writing (``encode_ico``, Pillow's ``IcoImagePlugin._save`` with its
defaults): of the sizes 16, 24, 32, 48, 64, 128 and 256 squared, each that
fits the image becomes one entry, the image's LANCZOS thumbnail into that
square (``resample.thumbnail``; the image itself where it is that size),
stored as a PNG (``image.encode_png``). The directory gives each entry's
width and height (256 as 0), 32 bits, no colour count and no planes. An
image under 16 pixels on a side gets a directory with no entries, as
Pillow writes it.

Reading (``decode_ico``, Pillow's ``IcoFile``): the entries sorted by
colour depth, then by area, largest first (a stable sort, so of two
entries of one size the shallower comes first); the first is read. A PNG
entry is the PNG as Pillow holds it, without its ``tRNS`` (Pillow copies
the PNG's pixels and palette, not its transparency). A BMP entry is a DIB
whose height counts the image and its AND mask: the top half of the rows
is the image; at 32 bits in the directory, alpha is the fourth byte of
each pixel (rows bottom-up); otherwise alpha is the AND mask after the
image (1 bit a pixel, rows padded to 32 bits, bottom-up; a set bit is
transparent), found from the entry's end.

``decode_cur`` is Pillow's ``CurImageFile``: the entry that is wider and
taller than every one before it, its DIB's top half without the AND
mask; a 32-bit DIB keeps its fourth byte as alpha only where the entry
starts at byte 22 (a one-entry file), as Pillow's BMP reader decides.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np

from . import bmp, resample

MAGIC = b"\0\0\1\0"
CUR_MAGIC = b"\0\0\2\0"
SIZES = ((16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128), (256, 256))


def _mode_ok(a: np.ndarray) -> bool:
    return ((a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))))
            or (a.dtype == np.uint16 and a.ndim == 2))


def encode_ico(pixels: np.ndarray) -> bytes:
    """The ICO Pillow's ``save`` writes for uint8 (H, W) L, (H, W, 3) RGB,
    (H, W, 4) RGBA or uint16 (H, W) I;16."""
    from .image import encode_png

    a = np.asarray(pixels)
    if not _mode_ok(a):
        raise ValueError(f"cannot write a {a.dtype} array of shape {a.shape} as ICO")
    height, width = a.shape[:2]
    frames = []
    for size in SIZES:
        if size[0] > width or size[1] > height:
            continue
        frames.append(a if (width, height) == size else resample.thumbnail(a, size, resample.LANCZOS))
    head = MAGIC + struct.pack("<H", len(frames))
    offset = len(head) + 16 * len(frames)
    entries, bodies = [], []
    for frame in frames:
        h, w = frame.shape[:2]
        body = encode_png(frame)
        entries.append(struct.pack("<BBBBHHII", w if w < 256 else 0, h if h < 256 else 0, 0, 0,
                                   0, 32, len(body), offset))
        bodies.append(body)
        offset += len(body)
    return head + b"".join(entries) + b"".join(bodies)


def _has_entries(data: bytes, magic: bytes) -> bool:
    if len(data) < 6 or not data.startswith(magic):
        return False
    count = struct.unpack_from("<H", data, 4)[0]
    return count > 0 and len(data) >= 6 + 16 * count


def is_ico(data: bytes) -> bool:
    """Whether Pillow opens ``data`` as an ICO: the magic and a whole
    directory of at least one entry (else its plugin fails in a way
    ``Image.open`` catches, and the next format is tried)."""
    return _has_entries(data, MAGIC)


def is_cur(data: bytes) -> bool:
    """``is_ico`` for a cursor. An uncompressed truecolour TGA starts with
    the cursor's magic too, and is read as a TGA where its colour-map
    origin (the cursor's count) is 0."""
    return _has_entries(data, CUR_MAGIC)


class Entry(NamedTuple):
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    color_depth: int


def _unidentified(name: str) -> OSError:
    return OSError(f"cannot identify image file {name!r}")


def entries(data: bytes, name: str = "<bytes>") -> list[Entry]:
    """The directory as Pillow's ``IcoFile`` orders it (the one read first)."""
    if len(data) < 6 or not data.startswith(MAGIC):
        raise _unidentified(name)
    out = []
    for i in range(struct.unpack_from("<H", data, 4)[0]):
        s = data[6 + 16 * i: 22 + 16 * i]
        if len(s) < 16:
            raise _unidentified(name)
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        out.append(Entry(width, height, bpp, size, offset, depth))
    out.sort(key=lambda e: e.color_depth)
    out.sort(key=lambda e: e.width * e.height, reverse=True)
    if not out:
        raise _unidentified(name)
    return out


class _Dib(NamedTuple):
    width: int
    height: int  # as the header gives it (an icon's counts its AND mask)
    top_down: bool
    bits: int
    compression: int
    pixels: int  # where the pixel rows start


def _dib_info(data: bytes, at: int) -> _Dib:
    hsize = struct.unpack_from("<I", data, at)[0]
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", data, at + 4)
        return _Dib(width, height, False, bits, 0, at + 12 + (3 << bits if bits <= 8 else 0))
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise OSError(f"Unsupported BMP header type ({hsize})")
    width, raw_h, _, bits, comp = struct.unpack_from("<IIHHI", data, at + 4)
    colors = struct.unpack_from("<I", data, at + 32)[0] or (1 << bits)
    top_down = data[at + 11] == 0xFF
    pixels = at + hsize + (12 if comp == 3 and hsize < 52 else 0)
    pixels += 4 * colors if bits <= 8 else 0
    return _Dib(width, 2**32 - raw_h if top_down else raw_h, top_down, bits, comp, pixels)


def _decode_half(data: bytes, at: int, dib: _Dib, rows: int, name: str) -> np.ndarray:
    """The DIB at ``at`` read with its height set to ``rows`` (the image
    above an icon's mask), as Pillow's ``convert("RGBA")``."""
    head = bytearray(data[at:])
    if struct.unpack_from("<I", head, 0)[0] == 12:
        struct.pack_into("<H", head, 6, rows)
    else:
        struct.pack_into("<I", head, 8, (2**32 - rows) if dib.top_down else rows)
    return bmp.decode_dib(bytes(head), name)


def _rows(data: bytes, at: int, count: int) -> np.ndarray:
    if at < 0 or at + count > len(data):
        raise ValueError("not enough image data")
    return np.frombuffer(data, np.uint8, count=count, offset=at)


def decode_ico(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``Image.open(p).convert("RGBA")``."""
    from .image import PNG_MAGIC, _pil_rgba, decode_png_samples

    e = entries(data, name)[0]
    if data[e.offset: e.offset + 8] == PNG_MAGIC:
        png = decode_png_samples(data[e.offset:], name)
        return _pil_rgba(png._replace(trns=None))
    dib = _dib_info(data, e.offset)
    w, h = dib.width, int(dib.height / 2)
    out = _decode_half(data, e.offset, dib, h, name)
    if e.bpp == 32:
        alpha = _rows(data, dib.pixels, w * h * 4)[3::4].reshape(h, w)[::-1]
    else:
        stride = (w + 31) // 32 * 4
        mask = _rows(data, e.offset + e.size - stride * h, stride * h).reshape(h, stride)
        bits = np.unpackbits(mask, axis=1)[:, :w]
        alpha = np.where(bits[::-1] != 0, 0, 255).astype(np.uint8)
    out[..., 3] = alpha
    return out


def decode_cur(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``Image.open(p).convert("RGBA")`` of a
    cursor."""
    if len(data) < 6 or not data.startswith(CUR_MAGIC):
        raise _unidentified(name)
    m = b""
    for i in range(struct.unpack_from("<H", data, 4)[0]):
        s = data[6 + 16 * i: 22 + 16 * i]
        if len(s) < 16:
            raise _unidentified(name)
        if not m or (s[0] > m[0] and s[1] > m[1]):
            m = s
    if not m:  # Pillow's TypeError, caught by Image.open
        raise _unidentified(name)
    at = struct.unpack_from("<I", m, 12)[0]
    dib = _dib_info(data, at)
    h = dib.height // 2
    out = _decode_half(data, at, dib, h, name)
    if dib.bits == 32 and dib.compression == 0 and at == 22:  # Pillow's "BGRA" for .cur
        rows = _rows(data, dib.pixels, dib.width * h * 4).reshape(h, dib.width, 4)
        out[..., 3] = rows[..., 3] if dib.top_down else rows[::-1, :, 3]
    return out
