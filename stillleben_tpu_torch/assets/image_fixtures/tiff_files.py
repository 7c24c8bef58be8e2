"""A TIFF writer of the layouts neither Pillow's ``save`` nor OpenCV writes
(or writes only some of): numpy and the standard library only, so the
card's host, which has no Pillow, makes the same bytes.

``tiff_file`` writes strips or tiles, contiguous or planar samples, either
byte order, classic TIFF or BigTIFF, FillOrder 1 or 2, uncompressed,
Deflate, PackBits or LZMA, the horizontal (2) or floating-point (3)
predictor, samples of 1-64 bits (unsigned, signed or floating point from
the array's dtype) and any further tags. ``tiff_fixtures()`` are the
committed files this writer makes (WhiteIsZero, planar, BigTIFF and
predictor-3 files); the tests' sweep draws the writer's options from a
seed.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def packbits(raw: bytes, row: int) -> bytes:
    """PackBits, row by row of ``row`` bytes: runs of three or more equal
    bytes as repeat packets, the rest as literal packets (at most 128 bytes
    a packet)."""
    out = bytearray()
    a = np.frombuffer(raw, np.uint8)
    for r in range(0, len(a), row):
        v = a[r: r + row]
        starts = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
        lens = np.diff(np.append(starts, len(v)))
        lit = bytearray()
        for s, n in zip(starts.tolist() + [len(v)], lens.tolist() + [3]):
            if n < 3 and s < len(v):
                lit += v[s: s + n].tobytes()
                continue
            for i in range(0, len(lit), 128):
                chunk = lit[i: i + 128]
                out += bytes([len(chunk) - 1]) + chunk
            lit.clear()
            while s < len(v) and n:
                k = min(n, 128)
                out += bytes([257 - k if k > 1 else 0, v[s]])
                n -= k
    return bytes(out)


def _predict(part: np.ndarray, predictor: int, bits: int, endian: str) -> bytes:
    """The chunk's bytes, (rows, width, n) samples differenced as libtiff's
    encoder does for ``predictor`` 2 (per sample, modulo 2^bits) or 3 (each
    row's bytes in planes most significant first, then differenced bytewise
    ``n`` apart)."""
    rows, width, n = part.shape
    if predictor == 3:
        nb = part.dtype.itemsize
        be = part.astype(part.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, width * n, nb)
        planes = be.transpose(0, 2, 1).reshape(rows, -1, n).astype(np.int64)
        planes[:, 1:] -= planes[:, :-1].copy()
        return (planes & 255).astype(np.uint8).tobytes()
    u = part.view(np.dtype(f"u{part.dtype.itemsize}")).copy()
    if predictor == 2:  # unsigned arithmetic wraps modulo 2^bits
        u[:, 1:] = u[:, 1:] - part.view(u.dtype)[:, :-1]
    return u.astype(np.dtype(f"{endian}u{part.dtype.itemsize}")).tobytes()


def tiff_file(samples: np.ndarray, photometric: int, *, endian: str = "<", tile=None,
              rows: int = 0, compression: int = 1, predictor: int = 1, extra=(), colormap=None,
              bits: int = 0, planar: int = 1, bigtiff: bool = False, fill: int = 1,
              tags: dict | None = None, raw_chunks: list[bytes] | None = None) -> bytes:
    """A TIFF of (h, w, spp) samples (uint8/16/32/64, int8-64, float32/64;
    or sub-byte grey with ``bits``): strips of ``rows`` rows or tiles of
    ``tile`` = (w, h), samples contiguous or in planes (``planar`` 2),
    uncompressed (1), Deflate (8), PackBits (32773) or LZMA (34925), with
    the ``predictor``; ``tags`` adds (type, values) by tag number;
    ``raw_chunks`` are the strips or tiles as stored, already coded in
    ``compression`` (the samples then give only the image's shape)."""
    h, w, spp = samples.shape
    bits = bits or samples.dtype.itemsize * 8
    kind = samples.dtype.kind
    fmt = {"u": 1, "i": 2, "f": 3}[kind] if bits >= 8 else 1
    cw, ch = tile or (w, rows or h)
    planes = [samples] if planar == 1 else [samples[..., k: k + 1] for k in range(spp)]
    chunks = list(raw_chunks or ())
    for plane in planes if raw_chunks is None else ():
        n = plane.shape[2]
        for ty in range(0, h, ch):
            for tx in range(0, w if tile else 1, cw if tile else 1):
                src = plane[ty: ty + ch, tx: tx + cw]
                part = np.zeros((ch, cw, n), plane.dtype)
                part[: src.shape[0], : src.shape[1]] = src
                if not tile:
                    part = part[: src.shape[0]]
                if bits < 8:
                    per = 8 // bits
                    v = part[..., 0].astype(np.int64)
                    v = np.concatenate([v, np.zeros((v.shape[0], (-v.shape[1]) % per), np.int64)],
                                       1)
                    v = v.reshape(v.shape[0], -1, per)
                    raw = (v << (bits * np.arange(per - 1, -1, -1))).sum(-1).astype(
                        np.uint8).tobytes()
                else:
                    raw = _predict(part, predictor, bits, endian)
                if compression == 8:
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = packbits(raw, len(raw) // part.shape[0])
                elif compression == 34925:
                    raw = lzma.compress(raw, lzma.FORMAT_XZ, check=lzma.CHECK_NONE)
                if fill == 2:  # the stored bytes, compressed or not, bit-reversed
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    e = endian
    off_type = 16 if bigtiff else 4
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [spp])]
    if fill != 1:
        entries.append((266, 3, [fill]))
    if planar != 1:
        entries.append((284, 3, [planar]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap, np.uint16).reshape(-1))))
    if extra:
        entries.append((338, 3, list(extra)))
    if fmt != 1:
        entries.append((339, 3, [fmt] * spp))
    if tile:
        entries += [(322, 4, [cw]), (323, 4, [ch]), (324, off_type, None),
                    (325, off_type, [len(c) for c in chunks])]
    else:
        entries += [(273, off_type, None), (278, 4, [ch]),
                    (279, off_type, [len(c) for c in chunks])]
    for tag, (typ, vals) in (tags or {}).items():
        entries.append((tag, typ, list(vals)))
    entries.sort(key=lambda t: t[0])
    n = len(entries)
    fmt_of = {3: "H", 4: "I", 5: "I", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
    size_of = {3: 2, 4: 4, 5: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
    if bigtiff:
        head = (b"II+\x00" if e == "<" else b"MM\x00+") + struct.pack(e + "HHQ", 8, 0, 16)
        at, inline = 16 + 8 + 20 * n + 8, 8
    else:
        head = (b"II*\x00" if e == "<" else b"MM\x00*") + struct.pack(e + "I", 8)
        at, inline = 8 + 2 + 12 * n + 4, 4
    values, offsets_tag = [], None
    for tag, typ, vals in entries:
        if vals is None:
            vals = [0] * len(chunks)
            offsets_tag = len(values)
        values.append((tag, typ, vals))
    sizes = [len(v) * size_of[t] for _, t, v in values]
    out_of_line = sum(s for s in sizes if s > inline)
    pos, offs = at + out_of_line, []
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    values[offsets_tag] = (values[offsets_tag][0], values[offsets_tag][1], offs)
    ifd = struct.pack(e + ("Q" if bigtiff else "H"), n)
    blobs = bytearray()
    for (tag, typ, vals), size in zip(values, sizes):
        if typ == 5:  # rationals: (numerator, denominator) pairs
            packed = b"".join(struct.pack(e + "II", *v) for v in vals)
        else:
            packed = struct.pack(f"{e}{len(vals)}{fmt_of[typ]}", *vals)
        count = len(vals)
        head_ = struct.pack(e + ("HHQ" if bigtiff else "HHI"), tag, typ, count)
        if size > inline:
            ifd += head_ + struct.pack(e + ("Q" if bigtiff else "I"), at + len(blobs))
            blobs += packed
        else:
            ifd += head_ + packed.ljust(inline, b"\0")
    ifd += bytes(inline)
    return head + ifd + bytes(blobs) + b"".join(chunks)


def _pattern(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Integer uint8 (h, w, c) content, the same on every host."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    return np.stack([((x * (3 + k + seed) + y * (5 + 2 * k)) // 2 + ((x * y) >> (4 + k)) + 37 * k)
                     & 255 for k in range(c)], -1).astype(np.uint8)


def sky_float(h: int = 64, w: int = 128) -> np.ndarray:
    """float32 (h, w, 3) with a bright sun: exact binary fractions from
    integers, the same on every host."""
    p = _pattern(h, w, 3, 7).astype(np.float32) / np.float32(64)
    p[h // 4: h // 4 + 3, w // 3: w // 3 + 3] = np.float32(48.5)
    return p


def tiff_fixtures() -> dict[str, bytes]:
    """The committed files this writer makes: WhiteIsZero, planar, BigTIFF
    (both byte orders, LONG8 offsets, an SLONG8 and an IFD8 entry), the
    floating-point predictor and 32-bit integer samples."""
    rgb = _pattern(37, 53, 3, 0)
    rgba = _pattern(37, 53, 4, 1)
    grey = _pattern(37, 53, 1, 2)
    grey16 = (_pattern(37, 53, 1, 3).astype(np.uint16) * 257 + 11)
    fl = (_pattern(37, 53, 3, 4).astype(np.int64) - 100).astype(np.float32) / np.float32(8)
    i32 = (_pattern(37, 53, 1, 5).astype(np.int32) - 60) * 1000003
    wide = {65000: (17, (-5, 1 << 40)), 65001: (18, (0,))}  # SLONG8, IFD8
    return {
        "whiteiszero8.tif": tiff_file(grey, 0, rows=9),
        "whiteiszero16.tif": tiff_file(grey16, 0, compression=8, predictor=2),
        "planar_rgb.tif": tiff_file(rgb, 2, planar=2, rows=16, compression=32773),
        "planar_rgba_tiles.tif": tiff_file(rgba, 2, planar=2, tile=(16, 16), compression=8,
                                           extra=(2,)),
        "bigtiff_le.tif": tiff_file(rgb, 2, bigtiff=True, rows=10, compression=8, tags=wide),
        "bigtiff_be.tif": tiff_file(grey16, 1, endian=">", bigtiff=True, tile=(32, 16)),
        "pred3_float.tif": tiff_file(fl, 2, compression=8, predictor=3, rows=12),
        "pred3_float_be.tif": tiff_file(fl[..., :1], 1, endian=">", compression=8, predictor=3,
                                        tile=(32, 32)),
        "int32_be.tif": tiff_file(i32, 1, endian=">", compression=8, predictor=2),
    }
