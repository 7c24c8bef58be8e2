"""TIFF, page 0: decode as Pillow and as OpenCV read it, encode as Pillow writes it.

Read: classic TIFF and BigTIFF (``II+``/``MM+``: 8-byte offsets and
counts, 20-byte entries, types LONG8, SLONG8 and IFD8), both byte orders,
strips and tiles, contiguous or planar (PlanarConfiguration 2) samples,
FillOrder 1 and 2. Compression: none, LZW and PackBits (the native codec
core, ``native_image``), Deflate (8 and 32946, zlib), LZMA (34925, Python's
``lzma``), ZSTD (50000, the native ``csrc/sl_zstd.cpp``), JPEG (7: each
strip or tile behind the ``JPEGTables``, through the native JPEG decoder
as libtiff sets libjpeg up) and CCITT modified Huffman (2), Group 3 (3,
1-D and 2-D) and Group 4 (4) (the native ``csrc/sl_fax.cpp``). The
horizontal predictor (2) and the floating-point predictor (3). Samples of
1, 2, 4, 8, 16, 32 and 64 bits, unsigned, signed (SampleFormat 2) or
floating point (SampleFormat 3). Photometric: WhiteIsZero, BlackIsZero,
RGB, palette, CMYK (5), YCbCr (6, not subsampled outside JPEG) and CIELab
(8).

``decode_tiff`` gives Pillow 12.1.0's ``Image.open(p).convert("RGBA")``: a
file takes the mode Pillow's ``OPEN_INFO`` gives its byte order,
photometric, sample format, fill order, bits and extra samples (a file of
no mode there, a float32 RGB among them, raises Pillow's "cannot identify
image file"), then Pillow's conversion of that mode: 16-bit colour keeps
the high byte, 16-bit grey clips at 255, F truncates and clips, I clips,
WhiteIsZero is inverted below 16 bits, a palette takes the colour map's
high bytes, CMYK goes through ``cmyk2rgb``, premultiplied colour is
divided by its alpha, and a YCbCr file is libtiff's RGBA reading
(uncompressed, Pillow reads its samples as RGBX and runs out of data: its
"image file is truncated" error). Compressed big-endian I;16S, I and F
samples read byte-swapped, as Pillow unpacks libtiff's native-order rows
with the file's byte order. CIELab is LittleCMS's Lab to sRGB transform
as Pillow builds it (``lab.py``).

``decode_tiff_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
IMREAD_ANYDEPTH)``: 8-bit and 1-bit files go through libtiff's RGBA
reader (WhiteIsZero inverted, RGBA with unassociated alpha premultiplied,
CMYK, YCbCr and CIELab converted by libtiff's formulas, a palette
expanded), then grey stays one channel and colour becomes BGR; 16, 32 and
64-bit samples stay as stored (int8, uint16, int16, int32, float32,
float64), colour BGR with alpha dropped; None where OpenCV reads nothing:
2 and 4-bit grey, LZMA and ZSTD (its libtiff has neither codec), a
4-channel 32 or 64-bit file, a strip that fails to decode.

Refused by name (``NotImplementedError``): old-style JPEG (6),
``tiff_raw_16`` (32771) and the other codecs, 12-bit samples, YCbCr
subsampled outside JPEG, a JPEG of subsampled components outside YCbCr.

``encode_tiff`` writes Pillow's default ``save`` bytes: little-endian, one
uncompressed strip, its tags in Pillow's order, for L, RGB, RGBA and 16-bit
grey (``I;16``).
"""

from __future__ import annotations

import lzma
import struct
import zlib
from typing import NamedTuple

import numpy as np

from . import native_image
from .lab import lab_to_rgb_libtiff, lab_to_rgba
from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

MAGIC = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
              16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 13: "I", 16: "Q",
             17: "q", 18: "Q"}
# none, CCITT modified Huffman, Group 3, Group 4, LZW, JPEG, Deflate (Adobe's
# and the old code), PackBits, LZMA, ZSTD
_COMPRESSION = (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 34925, 50000)
_REFUSED = {6: "old-style JPEG (compression 6)", 32771: "tiff_raw_16 (compression 32771)"}
# the compressions Pillow 12.1.0 names (``COMPRESSION_INFO``): it identifies
# no file of another
_PILLOW_CODECS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34712, 34925,
                  50000, 50001)
# the codecs whose strips the predictor applies to (libtiff's PredictorInit)
_PREDICTED = (5, 8, 32946, 34925, 50000)
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

# Pillow 12.1.0's TiffImagePlugin.OPEN_INFO: (photometric, sample format,
# fill order, bits, extra samples) -> (mode, rawmode), for both byte orders
# unless the key starts with the byte order ("<" or ">")
OPEN_INFO = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"),
    ("<", 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    ("<", 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    ("<", 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (">", 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    ("<", 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    ("<", 1, (2,), 1, (16,), ()): ("I", "I;16S"), (">", 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    ("<", 0, (3,), 1, (32,), ()): ("F", "F;32F"), (">", 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    ("<", 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    ("<", 1, (2,), 1, (32,), ()): ("I", "I;32S"), (">", 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    ("<", 1, (3,), 1, (32,), ()): ("F", "F;32F"), (">", 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    ("<", 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
    (">", 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
    ("<", 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
    (">", 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
    ("<", 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
    (">", 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
    ("<", 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
    (">", 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
    ("<", 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
    (">", 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"), (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"), (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"), (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"), (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"), (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    ("<", 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L"),
    (">", 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}


class CodecError(OSError):
    """A strip or tile that its codec fails to decode."""


class _Tiff(NamedTuple):
    samples: np.ndarray  # (H, W, spp) as stored, native byte order; (H, W, 3) RGB after JPEG YCbCr
    photometric: int
    bits: int
    fmt: int  # SampleFormat: 1 unsigned, 2 signed, 3 floating point
    extra: tuple
    colormap: np.ndarray | None  # (3, 2^bits) uint16
    tags: dict
    chunks: list  # with ``keep``: (x, y, samples) of each strip or tile as decoded


def _tags(data: bytes, name: str) -> tuple[str, dict]:
    """The byte order and the first IFD's tags: integers as tuples, ASCII and
    UNDEFINED as bytes, rationals as floats."""
    if data[:4] in (b"II*\x00", b"II+\x00"):
        e = "<"
    elif data[:4] in (b"MM\x00*", b"MM\x00+"):
        e = ">"
    else:
        raise ValueError(f"{name}: not a TIFF file")
    big = data[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:  # BigTIFF: offset size 8, then the first IFD's 8-byte offset
            size, zero, off = struct.unpack_from(e + "HHQ", data, 4)
            if size != 8 or zero:
                raise ValueError(f"{name}: BigTIFF with {size}-byte offsets")
            (n,) = struct.unpack_from(e + "Q", data, off)
            head, entry, inline, cfmt, ofmt = 8, 20, 8, "Q", "Q"
        else:
            (off,) = struct.unpack_from(e + "I", data, 4)
            (n,) = struct.unpack_from(e + "H", data, off)
            head, entry, inline, cfmt, ofmt = 2, 12, 4, "I", "I"
    except struct.error:
        raise NotThisFormat(f"{name}: truncated TIFF header") from None
    tags = {}
    for i in range(min(n, max(0, (len(data) - off - head) // entry))):
        at = off + head + entry * i
        tag, typ, count = struct.unpack_from(f"{e}HH{cfmt}", data, at)
        size = _TYPE_SIZE.get(typ)
        if size is None or count > len(data):
            continue
        at += 4 + inline
        if size * count > inline:
            (at,) = struct.unpack_from(e + ofmt, data, at)
        if at + size * count > len(data):
            continue
        if typ in (2, 7):
            tags[tag] = data[at: at + count]
        elif typ in (5, 10):
            v = struct.unpack_from(f"{e}{2 * count}{'I' if typ == 5 else 'i'}", data, at)
            tags[tag] = tuple(v[k] / v[k + 1] if v[k + 1] else 0.0 for k in range(0, 2 * count, 2))
        else:
            tags[tag] = struct.unpack_from(f"{e}{count}{_TYPE_FMT[typ]}", data, at)
    return e, tags


def _dtype(e: str, fmt: int, bits: int) -> np.dtype | None:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt)
    if kind is None or bits not in (8, 16, 32, 64) or (kind == "f" and bits < 32):
        return None
    return np.dtype(f"{e}{kind}{bits // 8}")


def _inflate(raw: bytes, size: int) -> bytes:
    return zlib.decompressobj().decompress(raw, size)


def _unlzma(raw: bytes, size: int) -> bytes:
    """libtiff's LZMADecode: liblzma runs until the strip's buffer is full,
    so damage past the bytes that fill it goes unseen. Python's decoder
    drops the output of a call that fails: a strip that fails is fed again
    a byte at a time, to keep all liblzma gave before it stopped."""
    try:
        return lzma.LZMADecompressor().decompress(raw, size)
    except lzma.LZMAError as e:
        err = e
    dec, out = lzma.LZMADecompressor(), b""
    for at in range(len(raw)):
        try:
            out += dec.decompress(raw[at: at + 1], size - len(out))
        except lzma.LZMAError:
            break
        if len(out) >= size:
            return out
    raise ValueError(f"LZMA: {err}")


def _fp_predictor(rows: np.ndarray, n: int, bits: int, ch: int, cw: int) -> np.ndarray:
    """libtiff's fpAcc: byte-wise horizontal accumulation ``n`` bytes apart,
    then each sample's bytes from planes stored most significant first."""
    b = rows.reshape(ch, -1, n).cumsum(axis=1, dtype=np.uint8).reshape(ch, -1)
    nb = bits // 8
    b = b.reshape(ch, nb, cw * n).transpose(0, 2, 1)
    return np.ascontiguousarray(b).view(np.dtype(f">f{nb}")).reshape(ch, cw, n)


def _jpeg_chunk(raw: bytes, tables: bytes | None, photo: int, n: int, name: str) -> np.ndarray:
    """One JPEG strip or tile as libtiff's JPEG codec hands it on: the tables
    read first, YCbCr converted to RGB (JPEGCOLORMODE RGB), other colour
    spaces left as stored."""
    if tables and len(tables) > 4 and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:]  # the tables' SOI .. DQT/DHT, then the strip after its SOI
    return native_image.jpeg_decode_tiff(raw, ycbcr=photo == 6, components=n, name=name)


def _parse(data: bytes, name: str, cv2: bool = False, keep: bool = False) -> _Tiff:
    """Page 0's samples as stored (``_Tiff``): what neither reading takes is
    refused by name, the size checked against Pillow's limits (OpenCV's with
    ``cv2``) before a strip is decoded; a strip or tile its codec fails on
    raises ``CodecError``. ``keep``: each decoded chunk too."""
    e, t = _tags(data, name)
    one = lambda tag, default=None: t[tag][0] if tag in t else default  # noqa: E731
    width, height = one(256), one(257)
    comp, photo = one(259, 1), one(262, 0)
    spp = one(277, 1)
    bps = tuple(t.get(258, (1,)))
    if len(bps) < spp and len(bps) == 1:
        bps *= spp
    bps = bps[:spp]
    planar, predictor, fill = one(284, 1), one(317, 1), one(266, 1)
    fmt = tuple(t.get(339, (1,)))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    extra = tuple(t.get(338, ()))
    if width is None or height is None:
        raise NotThisFormat(f"{name}: TIFF without its image size")
    if comp in _REFUSED:
        raise NotImplementedError(f"{name}: TIFF {_REFUSED[comp]} is not supported")
    if comp not in _COMPRESSION:
        raise NotImplementedError(f"{name}: TIFF compression {comp} is not supported")
    if len(set(bps)) != 1 or len(set(fmt)) != 1 or len(bps) != spp:
        raise NotImplementedError(f"{name}: TIFF of bits {bps}, sample format {fmt}")
    bits, sfmt = bps[0], fmt[0]
    if bits == 12:
        raise NotImplementedError(f"{name}: 12-bit TIFF samples are not supported")
    dtype = _dtype(e, sfmt, bits)
    if dtype is None and not (bits in (1, 2, 4) and spp == 1 and sfmt == 1):
        raise NotImplementedError(f"{name}: TIFF of {bits}-bit samples, sample format {sfmt}")
    if photo == 6 and comp != 7 and tuple(t.get(530, (2, 2))) != (1, 1):
        raise NotImplementedError(f"{name}: subsampled YCbCr TIFF outside JPEG is not supported")
    if comp in (2, 3, 4) and (bits != 1 or spp != 1):
        raise ValueError(f"{name}: CCITT TIFF of {spp} samples of {bits} bits")
    if comp == 7 and bits != 8:
        raise ValueError(f"{name}: JPEG TIFF of {bits}-bit samples")
    if comp in _PREDICTED and predictor == 2 and bits < 8:
        raise NotImplementedError(f"{name}: TIFF predictor 2 on {bits}-bit samples")
    if comp in _PREDICTED and predictor == 3 and sfmt != 3:
        raise NotImplementedError(f"{name}: TIFF predictor 3 on sample format {sfmt}")
    if comp in _PREDICTED and predictor not in (1, 2, 3):
        raise NotImplementedError(f"{name}: TIFF predictor {predictor} is not supported")
    check_size(width, height, name, "TIFF", cv2)
    if 322 in t:
        cw, ch = one(322), one(323)
        offsets, counts = t.get(324, ()), t.get(325, ())
    else:
        cw, ch = width, min(one(278, height), height)
        offsets, counts = t.get(273, ()), t.get(279, ())
    if not (cw and ch):
        raise ValueError(f"{name}: TIFF tiles of {cw}x{ch}")
    check_size(cw, ch, name, "TIFF tile", cv2)
    n = spp if planar == 1 else 1  # samples per chunk
    row_bytes = (cw * n * bits + 7) // 8
    size = row_bytes * ch
    across, down = (width + cw - 1) // cw, (height + ch - 1) // ch
    out_dtype = dtype if dtype is not None else np.dtype(np.uint8)
    out = np.zeros((height, width, spp), out_dtype.newbyteorder("="))
    tables, t4 = t.get(347), one(292, 0) if comp == 3 else 0
    kept = []

    def chunks():
        for k, off in enumerate(offsets):
            plane, idx = divmod(k, across * down)
            y, x = divmod(idx, across)
            y, x = y * ch, x * cw
            if plane >= spp // n or y >= height:
                break
            raw = data[off: off + counts[k]] if k < len(counts) else data[off:]
            if fill == 2 and comp != 7:  # libjpeg reads JPEG strips as they are
                raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            if comp == 7:
                chunk = _jpeg_chunk(raw, tables, photo, n, name)
                if chunk.shape[2] != n:
                    raise ValueError(f"{name}: a JPEG strip of {chunk.shape[2]} components")
                h_, w_ = min(ch, height - y, chunk.shape[0]), min(cw, width - x, chunk.shape[1])
                out[y: y + h_, x: x + w_, :n] = chunk[:h_, :w_]
                continue
            if comp == 5:
                raw = native_image.tiff_lzw(raw, size, name)
            elif comp in (8, 32946):
                raw = _inflate(raw, size)
            elif comp == 32773:
                raw = native_image.packbits(raw, size, name)
            elif comp == 34925:
                raw = _unlzma(raw, size)
            elif comp == 50000:
                raw = native_image.zstd_decompress(raw, size, name)
            elif comp in (2, 3, 4):
                raw = native_image.fax_decode(raw, comp, cw, ch, t4, name)
            need = row_bytes * (ch if 322 in t else min(ch, height - y))
            if comp in _PREDICTED + (32773,) and len(raw) < need:
                raise ValueError(f"{name}: not enough data in a strip ({len(raw)} of {need} "
                                 "bytes)")  # libtiff's codecs refuse a short strip
            raw = raw[:size].ljust(size, b"\x00")
            rows = np.frombuffer(raw, np.uint8).reshape(ch, row_bytes)
            if dtype is not None:
                if comp in _PREDICTED and predictor == 3:
                    chunk = _fp_predictor(rows, n, bits, ch, cw)
                else:
                    chunk = rows.view(dtype).reshape(ch, cw, n)
                    if comp in _PREDICTED and predictor == 2:
                        u = np.dtype(f"{e}u{bits // 8}")
                        chunk = chunk.view(u).astype(u.newbyteorder("=")).cumsum(
                            axis=1, dtype=u.newbyteorder("=")).view(out_dtype.newbyteorder("="))
            else:
                chunk = np.unpackbits(rows, axis=1).reshape(ch, -1, bits)[:, :cw]
                chunk = (chunk * (1 << np.arange(bits - 1, -1, -1))).sum(-1)[..., None]
            if keep:
                kept.append((x, y, chunk))
            part = chunk[: height - y, : width - x]
            if planar == 1:
                out[y: y + ch, x: x + cw] = part
            else:
                out[y: y + ch, x: x + cw, plane] = part[..., 0]

    try:
        chunks()
    except (ValueError, OSError, IndexError, lzma.LZMAError, zlib.error) as err:
        raise CodecError(f"{name}: {err}") from None
    cmap = np.asarray(t[320], np.uint16).reshape(3, -1) if photo == 3 and 320 in t else None
    if photo == 3 and cmap is None:
        raise ValueError(f"{name}: palette TIFF without a colour map")
    if comp == 7 and photo == 6:
        photo = 2  # libjpeg's YCbCr -> RGB
    return _Tiff(out, photo, bits, sfmt, extra, cmap, t, kept)


def _grey8(g: np.ndarray, bits: int) -> np.ndarray:
    """Sub-byte and 8-bit grey on Pillow's 0..255 scale."""
    return (g.astype(np.int64) * (255 // ((1 << bits) - 1))).astype(np.uint8)


def _cmyk_pillow(c: np.ndarray) -> np.ndarray:
    """Convert.c ``cmyk2rgb``: nk - nk * v / 255 in MULDIV255's rounding."""
    return native_image.cmyk_convert(255 - c[..., :4], opencv=False)


def _cmyk_libtiff(c: np.ndarray) -> np.ndarray:
    """libtiff's RGBA reader (putRGBcontig8bitCMYKtile): k (255 - v) / 255
    with k = 255 - K, truncated; RGB."""
    c = c.astype(np.int64)
    k = 255 - c[..., 3:4]
    return (k * (255 - c[..., :3]) // 255).astype(np.uint8)


def _unpremultiply(v: np.ndarray) -> np.ndarray:
    """Unpack.c ``unpackRGBa``: colour * 255 / alpha, clipped; 0 at alpha 0."""
    v = v.astype(np.int64)
    a = v[..., 3:4]
    rgb = np.where(a == 0, 0, np.minimum(v[..., :3] * 255 // np.maximum(a, 1), 255))
    rgb = np.where(a == 255, v[..., :3], rgb)
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _ycbcr_libtiff(s: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (tif_color.c) for 8-bit
    YCbCr, with the file's coefficients and ReferenceBlackWhite."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))]
    ref = [f32(v) for v in tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))]

    def fix(x):
        return int(np.floor(np.float64(x) * 65536 + 0.5))

    def clampf(x, lo, hi):
        return min(max(x, f32(lo)), f32(hi))
    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clampf(f1, 0, 2))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clampf(f2, 0, 2))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clampf(f3, 0, 2))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clampf(f4, 0, 2))

    def code2v(c, rb, rw, cr):
        d = rw - rb
        return f32(f32(c - int(rb)) * f32(cr)) / f32(d if d != 0 else 1)

    def clampw(f):
        return int(min(max(f, f32(-128 * 32)), f32(128 * 32)))
    cr_r, cb_b, cr_g, cb_g, y_tab = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127))
        cb = clampw(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127))
        cr_r[i] = (d1 * cr + 32768) >> 16
        cb_b[i] = (d3 * cb + 32768) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + 32768
        y_tab[i] = clampw(code2v(x + 128, ref[0], ref[1], 255))
    yy, cb, cr = (s[..., i].astype(np.int64) for i in range(3))
    r = y_tab[yy] + cr_r[cr]
    g = y_tab[yy] + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y_tab[yy] + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _pillow_raw_ycbcr(data: bytes, t: dict, bps: tuple) -> np.ndarray:
    """Pillow's raw reading of uncompressed YCbCr: its rawmode is RGBX (four
    bytes a pixel) over three-byte samples, tile by tile; (H, W, 3)."""
    width, height = t[256][0], t[257][0]
    out = np.zeros((height, width, 3), np.uint8)
    for off, _, x0, y0, x1, y1, stride in sorted(_pillow_tiles(t, bps, False),
                                                 key=lambda k: k[0]):
        rows = raw_rows(data, off, x1 - x0, y1 - y0, 32, stride)
        out[y0:y1, x0:x1] = rows.reshape(y1 - y0, x1 - x0, 4)[..., :3]
    return out


# the rawmodes of OPEN_INFO that Pillow's raw decoder has no unpacker for
_NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
# a plane's rawmode letter (``rawmode[plane]``) Pillow unpacks into each
# mode, and the bits it reads a pixel
_PLANE_LETTERS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "LAB": "LAB", "L": "L", "1": "1",
                  "P": "P", "F": "F", "I": "I"}
_LETTER_BITS = {"1": 1, "F": 32, "I": 32}


def _pillow_tiles(t: dict, bps: tuple, planar: bool) -> list[tuple]:
    """Pillow's raw tiles (``_setup``): (offset, layer, x0, y0, x1, y1,
    stride) per strip or tile, in file order; a single tile that covers the
    image reads from the last offset."""
    one = lambda tag, default=None: t[tag][0] if tag in t else default  # noqa: E731
    width, height = one(256), one(257)
    if 322 in t:
        cw, ch, offsets = one(322), one(323), t.get(324, ())
    else:
        cw, ch, offsets = width, one(278, height), t.get(273, ())
    if cw == width and ch == height and not planar:
        offsets = offsets[-1:]
    tiles, x = [], 0
    y = layer = 0
    for off in offsets:
        stride = cw * sum(bps) / 8 if x + cw > width else 0
        if planar:
            stride /= len(bps)
        tiles.append((off, layer, x, y, min(x + cw, width), min(y + ch, height), int(stride)))
        x += cw
        if x >= width:
            x, y = 0, y + ch
            if y >= height:
                y, layer = 0, layer + 1
    return tiles


def _pillow_raw_planes(data: bytes, t: dict, mode: str, rawmode: str, spp: int, bps: tuple,
                       name: str) -> np.ndarray:
    """Pillow's raw reading of an uncompressed planar TIFF: a tile per
    strip or tile and plane, read in file order with the letter
    ``rawmode[plane]`` as its rawmode (whatever the samples' width, and
    with no bit reversal), a stride where a tile passes the right edge.
    (H, W, spp) of the letters' values."""
    width, height = t[256][0], t[257][0]
    out = np.zeros((height, width, spp), np.float64 if mode == "F" else np.int64)
    for off, layer, x0, y0, x1, y1, stride in sorted(_pillow_tiles(t, bps, True),
                                                     key=lambda k: k[0]):
        letter = rawmode[layer] if layer < len(rawmode) else ""
        if layer >= spp:
            continue
        if letter not in _PLANE_LETTERS.get(mode, ""):
            raise ValueError("unknown raw mode for given image mode")
        bits = _LETTER_BITS.get(letter, 8)
        rows = raw_rows(data, off, x1 - x0, y1 - y0, bits, stride)
        if bits == 1:
            v = np.unpackbits(rows, axis=1)[:, : x1 - x0] * 255
        elif bits == 32:
            v = rows.view("<f4" if letter == "F" else "<i4")
        else:
            v = rows
        out[y0:y1, x0:x1, layer] = v
    return out


def _pillow_rgba(mode: str, rawmode: str, s: np.ndarray, f: _Tiff) -> np.ndarray:
    """``convert("RGBA")`` of the samples as Pillow unpacks them in ``mode``."""
    if mode == "LAB":
        return lab_to_rgba(s.astype(np.uint8))
    if mode == "P" or mode == "PA":
        pal = (f.colormap.T >> 8).astype(np.uint8)
        out = to_rgba("P", s[..., 0].astype(np.uint8), pal)
        if mode == "PA":
            out[..., 3] = s[..., 1]
        return out
    if mode == "CMYK":
        c = (s >> 8).astype(np.uint8) if f.bits == 16 else s.astype(np.uint8)
        return _cmyk_pillow(c)
    if mode in ("RGB", "RGBA"):
        v = (s >> 8).astype(np.uint8) if f.bits == 16 else s.astype(np.uint8)
        if rawmode.startswith("RGBa"):
            v = _unpremultiply(v[..., :4])
        return to_rgba(mode, v)
    if mode == "LA":
        out = to_rgba("L", s[..., 0].astype(np.uint8))
        out[..., 3] = s[..., 1]
        return out
    g = s[..., 0]
    if mode in ("1", "L"):
        g = _grey8(g, f.bits)
        if f.photometric == 0:
            g = 255 - g
        return to_rgba("L", g)
    if mode == "I" and rawmode == "I;32N":
        g = g.view(np.int32)
    return to_rgba(mode, g)


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 of page 0 as Pillow's ``convert("RGBA")``."""
    if data[:4] == b"MM\x00+":  # Pillow 12.1.0 finds no image size in a big-endian BigTIFF
        raise NotThisFormat(f"{name}: big-endian BigTIFF")
    e, t = _tags(data, name)
    if t.get(259, (1,))[0] not in _PILLOW_CODECS:
        raise NotThisFormat(f"{name}: TIFF compression {t[259][0]}, which Pillow does not name")
    key = _pillow_key(e, t)
    mode_raw = OPEN_INFO.get(key) or OPEN_INFO.get((e,) + key)
    if mode_raw is None:  # Pillow's "unknown pixel mode": no format takes the file
        raise NotThisFormat(f"{name}: TIFF of no Pillow mode {key}")
    mode, rawmode = mode_raw
    compressed = t.get(259, (1,))[0] != 1
    planar = t.get(284, (1,))[0] == 2
    if planar and compressed and mode in ("RGB", "RGBA", "CMYK") and len(key[3]) > len(mode) \
            and 322 not in t:
        raise OSError("decoder error -2")  # libtiff's strips of planes past Pillow's bands
    try:
        f = _parse(data, name)
    except CodecError as err:  # libtiff's decode fails: Pillow's "decoder error"
        raise OSError("decoder error -2") from err
    s = f.samples
    if not compressed:
        if rawmode in _NO_UNPACKER:
            raise ValueError("unknown raw mode for given image mode")
        if planar:
            s = _pillow_raw_planes(data, t, mode, "RGB" if key[0] == 6 else rawmode,
                                   s.shape[2], key[3], name)
            f = f._replace(bits=8 if f.bits == 16 else f.bits)
    elif e == ">" and rawmode in ("I;16BS", "F;32BF", "I;32BS"):
        s = s.byteswap()  # libtiff's native order unpacked as big-endian
    if f.photometric == 6 and len(rawmode) == 4:  # YCbCr: libtiff's RGBA reader
        if not compressed:  # Pillow's raw reading: no conversion
            return to_rgba("RGB", s.astype(np.uint8) if planar else _pillow_raw_ycbcr(
                data, t, key[3]))
        return to_rgba("RGB", _ycbcr_libtiff(s, f.tags))
    if planar and mode == "LAB":
        # the planes land in Pillow's LAB bands without the sign flip of a
        # and b, and the fourth byte of each pixel, left 0, is the alpha
        out = lab_to_rgba(s.astype(np.uint8) ^ np.array([0, 0x80, 0x80], np.uint8))
        out[..., 3] = 0
        return out
    if planar and compressed and s.shape[2] > 1:
        if mode in ("LA", "PA"):  # libtiff's second plane finds no unpacker
            s = s.copy()
            s[..., 1] = 0
        elif rawmode == "RGBA" and key[4] == ():  # read as premultiplied, as libtiff
            rawmode = "RGBa"  # takes a fourth sample it is not told of
    return _pillow_rgba(mode, rawmode, s, f)


def _pillow_key(e: str, t: dict) -> tuple:
    """Pillow's ``_setup``: the OPEN_INFO key of a file's first IFD."""
    one = lambda tag, default=None: t[tag][0] if tag in t else default  # noqa: E731
    comp, photo = one(259, 1), one(262, 0)
    if comp == 6:
        photo = 6
    fmt = tuple(t.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tuple(t.get(258, (1,)))
    extra = tuple(t.get(338, ()))
    spp = one(277, 3 if comp == 6 and photo in (2, 6) else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    return (photo, fmt, one(266, 1), bps, extra)


def decode_tiff_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """As ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``; None where
    OpenCV reads nothing (see the module)."""
    try:
        e, t = _tags(data, name)
    except NotThisFormat:
        return None  # libtiff reads no directory
    comp = t.get(259, (1,))[0]
    bits = t.get(258, (1,))[0]
    if comp in (34925, 50000):  # not configured in OpenCV's libtiff
        return None
    if bits not in (1, 8, 16, 32, 64) and not (bits == 4 and t.get(262, (0,))[0] == 3):
        return None  # OpenCV's readHeader: 2-bit samples, 4-bit grey
    tiled = 322 in t
    if bits <= 8 and tiled and t.get(266, (1,))[0] == 2:
        raise NotImplementedError(f"{name}: bit-reversed tiles (FillOrder 2) are not read as "
                                  "OpenCV reads them")
    la_tiles = bits == 8 and tiled and t.get(277, (1,))[0] == 2 and t.get(284, (1,))[0] == 1
    try:
        f = _parse(data, name, cv2=True, keep=la_tiles)
    except (CodecError, NotThisFormat):
        return None  # no image size, or a strip fails: OpenCV reads nothing
    s, bits, photo = f.samples, f.bits, f.photometric
    spp = s.shape[2]
    if photo == 3 and bits == 1:  # one channel: the colour's grey (RGBA2GRAY)
        return _grey_of(_palette_cv2(f)[s[..., 0]])
    if photo == 3:
        return np.ascontiguousarray(_palette_cv2(f)[s[..., 0]][..., ::-1])
    planar = f.tags.get(284, (1,))[0] == 2 and spp > 1
    if bits > 8:
        if photo not in (0, 1, 2) or (spp == 4 and bits >= 32):
            return None  # OpenCV's readData refuses the photometric or asserts its channels
        if planar:
            raise NotImplementedError(f"{name}: OpenCV reads a planar {bits}-bit TIFF's first "
                                      "plane as interleaved samples")
        if photo in (0, 1):
            return np.ascontiguousarray(s[..., 0])  # grey (+ alpha: the grey), as stored
        return np.ascontiguousarray(s[..., 2::-1])
    if planar and photo == 8:
        return None  # libtiff's RGBA reader has no separate CIELab
    # 1 and 8 bits: libtiff's RGBA reader
    if f.fmt == 2 and photo in (0, 1):  # int8 grey as stored, WhiteIsZero inverted
        return np.ascontiguousarray(~s[..., 0] if photo == 0 else s[..., 0])
    if la_tiles and photo in (0, 1):
        s = _la_tiles_skewed(f)
    if photo in (0, 1):
        g = _grey8(s[..., 0], bits)
        if planar and f.extra == (2,):  # the separate reader: no inversion, alpha associated
            return ((g.astype(np.int64) * s[..., 1] + 127) // 255).astype(np.uint8)
        return np.ascontiguousarray(255 - g if photo == 0 else g)
    if photo == 5:
        return np.ascontiguousarray(_cmyk_libtiff(s)[..., ::-1])
    if photo == 6:
        return np.ascontiguousarray(_ycbcr_libtiff(s, f.tags)[..., ::-1])
    if photo == 8:
        return np.ascontiguousarray(lab_to_rgb_libtiff(s, f.tags)[..., ::-1])
    if photo != 2:
        raise NotImplementedError(f"{name}: TIFF photometric {photo} is not read as OpenCV "
                                  "reads it")
    if spp == 4 and f.extra == (2,):
        # libtiff's RGBA reader associates the alpha: (a * v + 127) // 255
        a = s[..., 3:].astype(np.int64)
        return np.ascontiguousarray(((s[..., 2::-1] * a + 127) // 255).astype(np.uint8))
    return np.ascontiguousarray(s[..., 2::-1])


def _palette_cv2(f: _Tiff) -> np.ndarray:
    """(256, 3) RGB of libtiff's RGBA reader: a colour map of 16-bit values
    (any over 255) keeps the high bytes, else the low."""
    cmap = f.colormap
    if (cmap > 255).any():
        cmap = cmap >> 8
    pal = np.zeros((256, 3), np.uint8)
    n = min(256, cmap.shape[1])
    pal[:n] = cmap[:, :n].T.astype(np.uint8)
    return pal


def _grey_of(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's RGB -> grey: (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    v = rgb.astype(np.int64)
    return ((v[..., 0] * 4899 + v[..., 1] * 9617 + v[..., 2] * 1868 + 8192) >> 14).astype(np.uint8)


def _la_tiles_skewed(f: _Tiff) -> np.ndarray:
    """libtiff's putagreytile (8-bit grey + alpha, contiguous) steps to the
    next row of a tile cut by the right edge by the missing pixels, not
    their bytes: row r of such a tile starts r * (2 w + tile width - w)
    bytes in. (H, W, 2) samples as the RGBA reader sees them."""
    s = f.samples.copy()
    h, w_img = s.shape[:2]
    for x, y, chunk in f.chunks:
        cw = chunk.shape[1]
        w = min(cw, w_img - x)
        if w == cw:
            continue
        flat = chunk.reshape(-1)
        for r in range(min(chunk.shape[0], h - y)):
            at = r * (2 * w + cw - w)
            s[y + r, x: x + w] = flat[at: at + 2 * w].reshape(w, 2)
    return s


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
