"""Windows BMP: decode as Pillow and as OpenCV read it, encode as Pillow writes it.

The RLE streams are decoded by the native codec core (``native_image``);
the rest here, in numpy. ``decode_bmp`` gives Pillow 12's
``Image.open(p).convert("RGBA")``: 1, 4 and 8-bit palettes (a palette that
is the grey ramp 0, 1, 2, ... is Pillow's mode "L", whose index is its
grey; at 1 and 4 bits, but for the black-and-white pair, Pillow cannot
unpack it and neither does ``decode_bmp``), RLE8 and RLE4 (Pillow's own
decoder, run for run), 16-bit 5-5-5 and BITFIELDS 5-6-5 (each field scaled
by ``255 // max``), 24-bit, 32-bit (alpha dropped unless BITFIELDS name an
alpha mask), bottom-up and top-down rows, the OS/2 and the Windows
headers. ``decode_bmp_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH)``: a grey palette as one channel of its grey values,
everything else BGR, 16-bit fields shifted left (``x << 3``, ``x << 2``);
the OS/2 header raises there. ``encode_bmp`` writes Pillow's ``save``
bytes: L as 8-bit with the grey palette, RGB as 24-bit, RGBA as 32-bit
(which Pillow then reads back as RGB), at 96 dpi; other modes raise
``OSError`` as Pillow does.

A DIB (``.dib``) is a BMP without its 14-byte file header: ``encode_dib``
writes Pillow's DIB ``save`` (``encode_bmp``'s bytes after that header)
and ``decode_dib`` reads one as ``Image.open`` does (the pixels right
after the header, masks and palette); OpenCV reads no DIB.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import native_image
from .image_limits import check_size

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# BITFIELDS layouts Pillow reads -> its raw mode's channel masks (R, G, B, A)
_MASKS_32 = ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
             (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
             (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
             (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0))
_MASKS_16 = ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))


class _Bmp(NamedTuple):
    index: np.ndarray | None  # (H, W) palette indices, rows top first
    palette: np.ndarray | None  # (N, 3) RGB
    grey: bool  # the palette is Pillow's grey ramp (mode "L" / "1")
    fields: np.ndarray | None  # (H, W, 4) int64 raw fields R, G, B, A of 16/24/32-bit
    bits: tuple  # each field's width
    alpha: bool  # Pillow keeps the alpha field
    pil_error: str | None  # why Pillow cannot read the file, when it cannot
    os2: bool  # the 12-byte OS/2 header


def _u16(d, p):
    return struct.unpack_from("<H", d, p)[0]


def _u32(d, p):
    return struct.unpack_from("<I", d, p)[0]


def _parse(data: bytes, name: str, cv2: bool = False) -> _Bmp:
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    offset, hsize = _u32(data, 10), _u32(data, 14)
    if hsize not in _HEADERS:
        raise NotImplementedError(f"{name}: BMP header of {hsize} bytes is not supported")
    h0 = 18
    if hsize == 12:
        width, height = _u16(data, h0), _u16(data, h0 + 2)
        bits, comp, pal_entry, colors, top_down = _u16(data, h0 + 6), 0, 3, 0, False
    else:
        width = _u32(data, h0)
        top_down = data[h0 + 7] == 0xFF
        height = 2**32 - _u32(data, h0 + 4) if top_down else _u32(data, h0 + 4)
        bits, comp = _u16(data, h0 + 10), _u32(data, h0 + 12)
        colors, pal_entry = _u32(data, h0 + 28), 4
    after = 14 + hsize  # where the palette or the masks start
    masks = None
    if hsize != 12 and comp == 3:  # BITFIELDS
        if hsize - 4 >= 48:
            masks = [_u32(data, h0 + 36 + 4 * i) for i in range(4 if hsize - 4 >= 52 else 3)]
        else:
            masks = [_u32(data, after + 4 * i) for i in range(3)]
            after += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
    colors = colors or (1 << bits if bits <= 16 else 0)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    elif offset == 0:  # no pixel offset (a DIB): the pixels follow the palette
        offset = after + (pal_entry * colors if bits <= 8 else 0)
    if bits not in (1, 4, 8, 16, 24, 32):
        raise NotImplementedError(f"{name}: BMP of {bits} bits per pixel is not supported")
    if comp not in (0, 1, 2, 3):
        raise NotImplementedError(f"{name}: BMP compression {comp} is not supported")
    if comp in (1, 2) and bits not in (8, 4):
        raise NotImplementedError(f"{name}: RLE BMP of {bits} bits is not supported")
    if comp == 3 and not ((bits == 32 and masks in _MASKS_32)
                          or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))
                          or (bits == 16 and masks[:3] in _MASKS_16)):
        raise NotImplementedError(f"{name}: BMP bitfields layout {masks} is not supported")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: BMP of size {width}x{height}")
    check_size(width, height, name, "BMP", cv2)

    index = palette = fields = pil_error = None
    grey, fbits, alpha = False, (8, 8, 8, 8), False
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise NotImplementedError(f"{name}: BMP palette of {colors} colours is not supported")
        raw = np.frombuffer(data, np.uint8, count=pal_entry * colors, offset=after)
        palette = raw.reshape(colors, pal_entry)[:, 2::-1].copy()
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = bool(np.array_equal(palette, np.repeat(np.asarray(ramp)[:, None], 3, 1)))
        if grey and bits < 8 and colors != 2 and comp == 0:
            pil_error = (f"a {bits}-bit BMP whose palette is the grey ramp is Pillow's mode L, "
                         "which its raw decoder cannot unpack")
        if comp in (1, 2):
            index = native_image.bmp_rle(data, offset, width, height, comp == 2, name)
        else:
            stride = ((width * bits + 31) >> 3) & ~3
            rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
            rows = rows.reshape(height, stride)
            index = np.unpackbits(rows, axis=1).reshape(height, -1, bits) if bits < 8 else rows
            if bits < 8:
                index = (index * (1 << np.arange(bits - 1, -1, -1))).sum(-1).astype(np.uint8)
            index = index[:, :width]
        if not top_down:
            index = index[::-1]
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
        rows = rows.reshape(height, stride)[:, : width * bits // 8]
        if bits == 16:
            v = rows.reshape(height, width, 2).view("<u2")[..., 0].astype(np.int64)
            five = masks is None or masks[:3] == (0x7C00, 0x3E0, 0x1F)
            if five:
                fields = np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31, v * 0], -1)
                fbits = (5, 5, 5, 0)
            else:
                fields = np.stack([(v >> 11) & 31, (v >> 5) & 63, v & 31, v * 0], -1)
                fbits = (5, 6, 5, 0)
        elif bits == 24 or (bits == 32 and masks is None):  # BGR, BGRX bytes
            k = bits // 8
            fields = np.zeros((height, width, 4), np.uint8)
            fields[..., :3] = rows.reshape(height, width, k)[..., 2::-1]
        else:  # 32-bit BITFIELDS
            v = rows.reshape(height, width, 4).view("<u4")[..., 0].astype(np.int64)
            m = masks if masks != (0, 0, 0, 0) else (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
            fields = np.stack([(v & k) >> (k & -k).bit_length() - 1 if k else v * 0 for k in m], -1)
            alpha = m[3] != 0
        if not top_down:
            fields = fields[::-1]
    return _Bmp(index, palette, grey, fields, fbits, alpha, pil_error, hsize == 12)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    b = _parse(data, name)
    if b.pil_error:
        raise ValueError(f"{name}: {b.pil_error}")
    if b.index is not None:
        h, w = b.index.shape
        out = np.full((h, w, 4), 255, np.uint8)
        if b.grey:  # mode "1" or "L": the index is the grey (0/255 at 1 bit)
            g = (b.index != 0) * 255 if len(b.palette) == 2 else b.index
            out[..., :3] = g.astype(np.uint8)[..., None]
        else:
            pal = np.zeros((max(256, len(b.palette)), 3), np.uint8)
            pal[: len(b.palette)] = b.palette
            out[..., :3] = pal[b.index]
        return out
    f, bits = b.fields, b.bits
    h, w = f.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    for c in range(3):
        top = (1 << bits[c]) - 1
        out[..., c] = f[..., c] if bits[c] == 8 else f[..., c] * 255 // top
    if b.alpha:
        out[..., 3] = f[..., 3]
    return out


def decode_bmp_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """As ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``."""
    b = _parse(data, name, cv2=True)
    if b.os2:
        raise NotImplementedError(f"{name}: a BMP with the OS/2 header is not read as OpenCV "
                                  "reads it")
    if b.index is not None:
        pal = np.zeros((256, 3), np.uint8)
        pal[: min(256, len(b.palette))] = b.palette[:256]
        if (b.palette == b.palette[:, :1]).all():  # every entry grey
            return pal[b.index, 0].copy()
        return np.ascontiguousarray(pal[b.index][..., ::-1])
    f, bits = b.fields, b.bits
    rgb = np.stack([f[..., c] << (8 - bits[c]) for c in range(3)], -1).astype(np.uint8)
    return np.ascontiguousarray(rgb[..., ::-1])


def is_dib(data: bytes) -> bool:
    """Pillow's DIB signature: the file starts with a BMP info header's size."""
    return len(data) >= 4 and _u32(data, 0) in _HEADERS


def decode_dib(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 of a headerless DIB as Pillow's ``convert("RGBA")``."""
    return decode_bmp(b"BM" + struct.pack("<III", 14 + len(data), 0, 0) + data, name)


def encode_dib(pixels: np.ndarray) -> bytes:
    """Pillow's DIB ``save``: ``encode_bmp`` without the file header."""
    return encode_bmp(pixels)[14:]


def encode_bmp(pixels: np.ndarray) -> bytes:
    """Pillow's ``save`` of uint8 (H, W) L, (H, W, 3) RGB or (H, W, 4) RGBA."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))):
        mode = "I;16" if a.dtype == np.uint16 else f"{a.dtype} {a.shape}"
        raise OSError(f"cannot write mode {mode} as BMP")
    height, width = a.shape[:2]
    if a.ndim == 2:
        bits, colors, body = 8, 256, a
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
        palette[:, 3] = 0
        palette = palette.tobytes()
    else:
        bits, colors, palette = 8 * a.shape[2], 0, b""
        body = a[..., [2, 1, 0, 3][: a.shape[2]]].reshape(height, -1)
    stride = ((width * bits + 7) // 8 + 3) & ~3
    rows = np.zeros((height, stride), np.uint8)
    rows[:, : body.shape[1]] = body[::-1]
    offset = 14 + 40 + 4 * colors
    image = stride * height
    ppm = int(96 * 39.3701 + 0.5)
    head = (b"BM" + struct.pack("<III", offset + image, 0, offset)
            + struct.pack("<IIIHHIIIIII", 40, width, height, 1, bits, 0, image, ppm, ppm,
                          colors, colors))
    return head + palette + rows.tobytes()
