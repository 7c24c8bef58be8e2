"""Truevision TGA: decode as Pillow reads it, encode as Pillow writes it.

Run-length packets are decoded by the native codec core
(``native_image``); the rest here, in numpy. ``decode_tga`` gives Pillow 12's
``Image.open(p).convert("RGBA")``: uncompressed and run-length (packets may
cross rows, repeat packets may not) images of types 1/9 (colour-mapped,
8-bit indices into a 16 or 24-bit map that starts at its first index;
Pillow reads no 32-bit map), 2/10 (16-bit 5-5-5 with
the top bit as inverted alpha, 24-bit, 32-bit) and 3/11 (1, 8-bit grey and
16-bit grey + alpha), the origin bits (bottom-up or top-down,
right-to-left). OpenCV reads no TGA: ``cv2.imread`` gives None, and so
does ``image.read_image_cv2``. ``encode_tga`` writes Pillow's ``save``
bytes for L, RGB and RGBA (bottom-up rows, no compression, the TGA 2.0
footer); other modes raise ``OSError`` as Pillow does.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size

FOOTER = b"\x00" * 8 + b"TRUEVISION-XFILE." + b"\x00"


def _rgba15(v: np.ndarray) -> np.ndarray:
    """Pillow's "BGRA;15Z": 5-bit fields scaled by 255 // 31, alpha 255
    where the top bit is clear."""
    v = v.astype(np.int64)
    out = np.stack([(v >> 10) & 31, (v >> 5) & 31, v & 31], -1) * 255 // 31
    a = np.where(v & 0x8000, 0, 255)
    return np.concatenate([out, a[..., None]], -1).astype(np.uint8)


def decode_tga(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if len(data) < 18:
        raise ValueError(f"{name}: not a TGA file")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_start, cmap_len, cmap_depth = struct.unpack_from("<HHB", data, 3)
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or width == 0 or height == 0 or depth not in (1, 8, 16, 24, 32):
        raise ValueError(f"{name}: not a TGA file")
    kind = itype & 7
    if itype not in (1, 2, 3, 9, 10, 11):
        raise NotImplementedError(f"{name}: TGA image type {itype} is not supported")
    known = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}
    if (kind, depth) not in known:
        raise NotImplementedError(f"{name}: TGA type {itype} at {depth} bits is not supported")
    check_size(width, height, name, "TGA")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        entry = {16: 2, 24: 3}.get(cmap_depth)
        if cmap_depth == 32:  # Pillow's palette has no "BGRA" raw mode
            raise ValueError(f"{name}: a TGA colour map of 32 bits is not read by Pillow")
        if entry is None:
            raise NotImplementedError(f"{name}: TGA colour map of {cmap_depth} bits")
        raw = np.frombuffer(data, np.uint8, count=entry * cmap_len, offset=pos)
        pos += entry * cmap_len
        palette = np.zeros((cmap_start + cmap_len, 4), np.uint8)
        palette[:, 3] = 255
        if entry == 2:
            palette[cmap_start:] = _rgba15(raw.view("<u2"))
        else:
            palette[cmap_start:, :3] = raw.reshape(cmap_len, entry)[:, 2::-1]
    bpp = max(1, depth // 8)
    npix = width * height
    if depth == 1:  # one bit per pixel, rows padded to bytes
        stride = (width + 7) // 8
        body = np.frombuffer(data, np.uint8, count=stride * height, offset=pos)
        if itype & 8:
            raise NotImplementedError(f"{name}: run-length TGA of 1 bit is not supported")
        px = np.unpackbits(body.reshape(height, stride), axis=1)[:, :width] * 255
    else:
        raw = (native_image.tga_rle(data, pos, npix, bpp, width, name) if itype & 8
               else data[pos: pos + npix * bpp])
        if len(raw) < npix * bpp:
            raise ValueError(f"{name}: TGA data is truncated")
        px = np.frombuffer(raw, np.uint8).reshape(height, width, bpp)
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if kind == 1:
        if palette is None:  # Pillow's mode "L" without a map
            out[..., :3] = px[..., :1]
        else:
            pal = np.zeros((256, 4), np.uint8)
            pal[:, 3] = 255
            pal[: min(256, len(palette))] = palette[:256]
            out[...] = pal[px[..., 0]]
    elif kind == 3:
        if depth == 1:
            out[..., :3] = px[..., None]
        else:
            out[..., :3] = px[..., :1]
            if depth == 16:
                out[..., 3] = px[..., 1]
    elif depth == 16:
        out[...] = _rgba15(px.view("<u2")[..., 0])
    else:
        out[..., :3] = px[..., 2::-1]
        if depth == 32:
            out[..., 3] = px[..., 3]
    if not flags & 0x20:  # bottom-up
        out = out[::-1]
    if flags & 0x10:  # right-to-left
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


def encode_tga(pixels: np.ndarray) -> bytes:
    """Pillow's ``save`` of uint8 (H, W) L, (H, W, 3) RGB or (H, W, 4) RGBA."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))):
        mode = "I;16" if a.dtype == np.uint16 else f"{a.dtype} {a.shape}"
        raise OSError(f"cannot write mode {mode} as TGA")
    height, width = a.shape[:2]
    if a.ndim == 2:
        itype, bits, flags, body = 3, 8, 0, a
    else:
        itype, bits = 2, 8 * a.shape[2]
        flags = 8 if a.shape[2] == 4 else 0
        body = a[..., [2, 1, 0, 3][: a.shape[2]]]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, itype, 0, 0, 0, 0, 0, width, height, bits, flags)
    return head + np.ascontiguousarray(body[::-1]).tobytes() + FOOTER
