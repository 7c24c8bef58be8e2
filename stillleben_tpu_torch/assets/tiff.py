"""TIFF, page 0: decode as Pillow and as OpenCV read it, encode as Pillow writes it.

LZW and PackBits strips and tiles are decoded by the native codec core
(``native_image``); Deflate by zlib; the horizontal predictor and the
layout here, in numpy. A page or a tile grid over Pillow's (or OpenCV's)
size limit raises before anything is decoded. Decoded: strips and tiles, no compression,
PackBits, LZW and Deflate (8 and 32946), predictor 2, both byte orders,
contiguous samples of 8 or 16 bits: grey (and 1, 2, 4-bit grey),
grey + alpha, RGB, RGBA (unassociated, or unspecified extra samples) and
palette. ``decode_tiff`` gives Pillow 12's ``Image.open(p).convert("RGBA")``:
16-bit colour keeps the high byte of each sample, 16-bit grey is clipped at
255 (as ``image._pil_rgba`` does for PNG), WhiteIsZero is inverted (but
not at 16 bits, as Pillow's table has it), a palette is the colour map's
high bytes. ``decode_tiff_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH)``: grey stays one channel, colour becomes BGR with alpha
dropped (8-bit RGBA goes through libtiff's RGBA reader, which multiplies
the colour by the alpha), 16-bit samples stay 16-bit, a palette is
expanded to BGR; 2 and 4-bit grey give None, and WhiteIsZero raises.
``encode_tiff`` writes Pillow's default ``save`` bytes: little-endian, one
uncompressed strip, its tags in Pillow's order, for L, RGB, RGBA and 16-bit
grey (``I;16``).
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

from . import native_image
from .image_limits import check_size

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 16: "Q"}
_COMPRESSION = (1, 5, 8, 32946, 32773)  # none, LZW, Deflate (Adobe's and the old code), PackBits


class _Tiff(NamedTuple):
    samples: np.ndarray  # (H, W, spp) uint8 or uint16 (native order)
    photometric: int
    bits: int
    extra: tuple
    colormap: np.ndarray | None  # (3, 2^bits) uint16


def _tags(data: bytes, name: str) -> tuple[str, dict]:
    if data[:4] == b"II*\x00":
        e = "<"
    elif data[:4] == b"MM\x00*":
        e = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        raise NotImplementedError(f"{name}: BigTIFF is not supported")
    else:
        raise ValueError(f"{name}: not a TIFF file")
    (off,) = struct.unpack_from(e + "I", data, 4)
    (n,) = struct.unpack_from(e + "H", data, off)
    tags = {}
    for i in range(n):
        tag, typ, count, _ = struct.unpack_from(e + "HHII", data, off + 2 + 12 * i)
        size = _TYPE_SIZE.get(typ)
        if size is None or typ not in _TYPE_FMT and typ not in (2, 7):
            continue  # rationals and floats: no tag read here has them
        at = off + 2 + 12 * i + 8
        if size * count > 4:
            (at,) = struct.unpack_from(e + "I", data, at)
        if typ in (2, 7):
            tags[tag] = data[at: at + count]
        else:
            tags[tag] = struct.unpack_from(f"{e}{count}{_TYPE_FMT[typ]}", data, at)
    return e, tags


def _parse(data: bytes, name: str, cv2: bool = False) -> _Tiff:
    e, t = _tags(data, name)
    one = lambda tag, default=None: t[tag][0] if tag in t else default  # noqa: E731
    width, height = one(256), one(257)
    spp = one(277, 1)
    bps = t.get(258, (1,) * spp)
    comp, photo = one(259, 1), one(262)
    planar, predictor = one(284, 1), one(317, 1)
    fmt = t.get(339, (1,))
    extra = tuple(t.get(338, ()))
    if comp not in _COMPRESSION:
        raise NotImplementedError(f"{name}: TIFF compression {comp} is not supported")
    if planar != 1:
        raise NotImplementedError(f"{name}: planar TIFF (PlanarConfiguration 2) is not supported")
    if photo not in (0, 1, 2, 3) or len(set(bps)) != 1 or set(fmt) != {1}:
        raise NotImplementedError(f"{name}: TIFF photometric {photo}, bits {bps}, "
                                  f"sample format {fmt} is not supported")
    bits = bps[0]
    if bits not in (8, 16) and not (bits in (1, 2, 4) and spp == 1 and photo in (0, 1, 3)):
        raise NotImplementedError(f"{name}: TIFF of {bits} bits per sample is not supported")
    if predictor not in (1, 2) or (predictor == 2 and bits < 8):
        raise NotImplementedError(f"{name}: TIFF predictor {predictor} is not supported")
    if width is None or height is None:
        raise ValueError(f"{name}: TIFF without its image size")
    check_size(width, height, name, "TIFF", cv2)
    if 322 in t:
        cw, ch = one(322), one(323)
        offsets, counts = t[324], t[325]
    else:
        cw, ch = width, min(one(278, height), height)
        offsets, counts = t[273], t.get(279, ())
    if not (cw and ch):
        raise ValueError(f"{name}: TIFF tiles of {cw}x{ch}")
    check_size(cw, ch, name, "TIFF tile", cv2)
    row_bytes = (cw * spp * bits + 7) // 8
    size = row_bytes * ch
    dtype = np.dtype(e + "u2") if bits == 16 else np.dtype(np.uint8)
    across = (width + cw - 1) // cw
    out = np.zeros((height, width, spp if bits >= 8 else 1), dtype if bits >= 8 else np.uint8)
    for k, off in enumerate(offsets):
        raw = data[off: off + counts[k]] if k < len(counts) else data[off:]
        if comp == 5:
            raw = native_image.tiff_lzw(raw, size, name)
        elif comp in (8, 32946):
            raw = zlib.decompressobj().decompress(raw, size)
        elif comp == 32773:
            raw = native_image.packbits(raw, size, name)
        raw = raw[:size].ljust(size, b"\x00")
        rows = np.frombuffer(raw, np.uint8).reshape(ch, row_bytes)
        if bits >= 8:
            chunk = rows.view(dtype).reshape(ch, cw, spp)
            if predictor == 2:
                chunk = np.cumsum(chunk.astype(np.int64), axis=1) & ((1 << bits) - 1)
        else:
            chunk = np.unpackbits(rows, axis=1).reshape(ch, -1, bits)[:, :cw]
            chunk = (chunk * (1 << np.arange(bits - 1, -1, -1))).sum(-1)[..., None]
        y, x = divmod(k, across)
        y, x = y * ch, x * cw
        if y >= height:
            break
        out[y: y + ch, x: x + cw] = chunk[: height - y, : width - x]
    cmap = np.asarray(t[320], np.uint16).reshape(3, -1) if photo == 3 and 320 in t else None
    if photo == 3 and cmap is None:
        raise ValueError(f"{name}: palette TIFF without a colour map")
    samples = out.astype(dtype.newbyteorder("="))
    return _Tiff(samples, photo, bits, extra, cmap)


def _grey8(g: np.ndarray, bits: int) -> np.ndarray:
    """Sub-byte and 8-bit grey on Pillow's 0..255 scale."""
    return (g.astype(np.int64) * (255 // ((1 << bits) - 1))).astype(np.uint8)


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 of page 0 as Pillow's ``convert("RGBA")``."""
    f = _parse(data, name)
    s, bits = f.samples, f.bits
    h, w, spp = s.shape
    out = np.full((h, w, 4), 255, np.uint8)
    if f.photometric == 3:
        pal = np.zeros((256, 3), np.uint8)
        n = min(256, f.colormap.shape[1])
        pal[:n] = (f.colormap[:, :n].T >> 8).astype(np.uint8)
        out[..., :3] = pal[s[..., 0]]
        return out
    if f.photometric in (0, 1):
        if bits == 16:
            if spp != 1:
                raise NotImplementedError(f"{name}: 16-bit grey + alpha TIFF is not supported")
            grey = np.minimum(s[..., 0], 255).astype(np.uint8)
        else:
            grey = _grey8(s[..., 0], bits)
            if f.photometric == 0:
                grey = 255 - grey
        out[..., :3] = grey[..., None]
        if spp == 2:
            if f.extra != (2,) or f.photometric != 1:
                raise NotImplementedError(f"{name}: grey TIFF with extra samples {f.extra}")
            out[..., 3] = s[..., 1]
        return out
    if spp < 3 or (spp > 3 and f.extra not in ((), (0,), (2,), (999,))) or spp > 4:
        raise NotImplementedError(f"{name}: RGB TIFF with extra samples {f.extra} is not supported")
    v = (s >> 8).astype(np.uint8) if bits == 16 else s
    out[..., :3] = v[..., :3]
    if spp == 4 and f.extra != (0,):
        out[..., 3] = v[..., 3]
    return out


def decode_tiff_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """As ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``; None for
    2 and 4-bit grey, as OpenCV reads none."""
    f = _parse(data, name, cv2=True)
    s, bits = f.samples, f.bits
    if f.photometric == 3:
        cmap = f.colormap
        if (cmap > 255).any():  # libtiff's 16-bit colour map check
            cmap = cmap >> 8
        pal = np.zeros((256, 3), np.uint8)
        n = min(256, cmap.shape[1])
        pal[:n] = cmap[:, :n].T.astype(np.uint8)
        return np.ascontiguousarray(pal[s[..., 0]][..., ::-1])
    if f.photometric in (0, 1):
        if f.photometric == 0:
            raise NotImplementedError(f"{name}: WhiteIsZero TIFF is not read as OpenCV reads it")
        if bits in (2, 4):
            return None
        g = s[..., 0]  # grey + alpha: the grey
        return np.ascontiguousarray(_grey8(g, bits) if bits < 8 else g)
    if bits == 8 and s.shape[2] == 4 and f.extra == (2,):
        # libtiff's RGBA reader associates the alpha: (a * v + 127) // 255
        a = s[..., 3:].astype(np.int64)
        return np.ascontiguousarray(((s[..., 2::-1] * a + 127) // 255).astype(np.uint8))
    return np.ascontiguousarray(s[..., 2::-1])


def encode_tiff(pixels: np.ndarray) -> bytes:
    """Pillow's default ``save`` of uint8 (H, W) L, (H, W, 3) RGB, (H, W, 4)
    RGBA or uint16 (H, W) ``I;16``."""
    a = np.asarray(pixels)
    if a.dtype == np.uint16 and a.ndim == 2:
        spp, bits, photo, body = 1, 16, 1, a.astype("<u2")
    elif a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))):
        spp = 1 if a.ndim == 2 else a.shape[2]
        bits, photo, body = 8, 1 if spp == 1 else 2, a
    else:
        raise OSError(f"cannot write mode {a.dtype} {a.shape} as TIFF")
    height, width = a.shape[:2]
    n_tags = 9 + (spp > 1) + (spp == 4)
    ifd_end = 8 + 2 + 12 * n_tags + 4
    bps_at = ifd_end
    data_at = ifd_end + (2 * spp if spp > 2 else 0)
    image = body.tobytes()
    entries = [(256, 4, 1, width), (257, 4, 1, height),
               (258, 3, spp, bps_at if spp > 2 else bits), (259, 3, 1, 1), (262, 3, 1, photo),
               (273, 4, 1, data_at)]
    if spp > 1:
        entries.append((277, 3, 1, spp))
    entries += [(278, 4, 1, height), (279, 4, 1, len(image)), (284, 3, 1, 1)]
    if spp == 4:
        entries.append((338, 3, 1, 2))
    out = bytearray(b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", n_tags))
    for tag, typ, count, value in entries:
        out += struct.pack("<HHI", tag, typ, count)
        out += struct.pack("<HH", value, 0) if typ == 3 and count == 1 else struct.pack("<I", value)
    out += b"\x00" * 4
    if spp > 2:
        out += struct.pack(f"<{spp}H", *([bits] * spp))
    return bytes(out) + image
