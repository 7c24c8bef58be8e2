"""The port's own image codec: every format the JAX package opens through
Pillow or OpenCV that the port reads (ROADMAP.md queues the rest).

numpy and the standard library here (zlib for PNG's deflate); the JPEG,
GIF, TIFF and WebP modules and the run-length and block decoders of the
rarer formats reach the native codec (``native_image``,
``csrc/sl_image.cpp``, ``csrc/sl_webp.cpp``, ``csrc/sl_plain_formats.cpp``,
``csrc/sl_pillow_formats.cpp``, built with g++ at first use) for their bit
loops. Two readings of a file, each the one a part of the JAX package gets
from a library:

- ``read_image`` / ``decode_image``: (H, W, 4) uint8, what
  ``PIL.Image.open(path).convert("RGBA")`` gives (mesh textures, glTF
  images, ``Texture``, ``ImageLoader``). PNG of every colour type (grey,
  grey + alpha, truecolour, truecolour + alpha, palette), every bit depth
  (1, 2, 4, 8, 16), ``tRNS`` transparency and Adam7 interlacing, with
  Pillow's conversions: 16-bit samples keep their high byte, 16-bit grey
  clips at 255, a transparent colour is matched against the samples as
  Pillow holds them (``_pil_rgba``). Netpbm ``P1``-``P6`` and ``Pf``
  (``netpbm.py``), JPEG (``jpeg.py``), BMP and DIB (``bmp.py``), TGA
  (``tga.py``), GIF frame 0 (``gif.py``), TIFF page 0 (``tiff.py``: classic
  and BigTIFF; uncompressed, LZW, Deflate, PackBits, JPEG, CCITT RLE, Group
  3 and 4, LZMA and ZSTD; 1-64-bit samples, float and signed among them;
  grey, RGB, palette, CMYK, YCbCr and CIELab; strips, tiles, planes),
  WebP frame 0 (``webp.py``: lossy, lossless, alpha, animation), QOI
  (``qoi.py``), SGI (``sgi.py``), PCX and DCX frame 0 (``pcx.py``), IM
  (``im.py``), DDS (``dds.py``: uncompressed and BC1-BC7), ICO and CUR
  (``ico.py``), ICNS (``icns.py``), PSD (``psd.py``), JPEG 2000
  (``jpeg2000.py``: the codestream and JP2 as Pillow writes them), AVIF
  (``avif.py``), and the rest of Pillow's readers: BLP (``blp.py``), FTEX
  (``ftex.py``), Sun raster (``sun.py``), XBM (``xbm.py``), XPM
  (``xpm.py``), MSP (``msp.py``), GIMP brushes (``gbr.py``), FITS
  (``fits.py``), FLI/FLC frame 0 (``fli.py``), SPIDER (``spider.py``),
  McIdas (``mcidas.py``), PIXAR (``pixar.py``), IM Tools (``imt.py``), XV
  thumbnails (``xvthumb.py``), PhotoCD (``pcd.py``) and IPTC
  (``iptc.py``). The formats are tried in Pillow's order
  (``PILLOW_ORDER``), each behind its plugin's ``_accept`` test where it
  has one; a reader that finds its header is not the format's sends the
  file on to the next format (``pillow_open.NotThisFormat``), as Pillow's
  ``Image.open`` does on ``SyntaxError``. Where Pillow opens a file but
  cannot load it, the port raises Pillow's ``OSError``: the BUFR, GRIB and
  HDF5 stubs ("cannot find loader for this ... file"), WMF and EMF (no
  renderer on Linux), MPEG ("cannot load this image") and EPS, which
  Pillow renders through Ghostscript ("Unable to locate Ghostscript on
  paths", as on a host without it). A file no format takes, a Radiance
  ``.hdr`` among them, raises Pillow's ``UnidentifiedImageError`` message as
  an ``OSError``.
- ``read_image_cv2``: what ``cv2.imread(path, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)`` gives (the light map's panorama): grey stays one
  channel, colour becomes three in BGR order with any alpha dropped,
  16-bit samples stay 16-bit, an ``.hdr`` or PFM file decodes to float32,
  a TIFF of 32 or 64-bit samples to float32, int32 or float64 (8-bit and
  1-bit TIFFs through libtiff's RGBA reader, LZMA and ZSTD ones None),
  a JPEG is turned by its EXIF orientation, a WebP gives frame 0, Netpbm
  includes PAM, JPEG 2000 is read as OpenCV's OpenJPEG reader reads it,
  AVIF as its libavif reads it (alpha dropped), a Sun raster as OpenCV's
  own reader reads it (``sun.decode_sun_cv2``); None for a file OpenCV does
  not read (a TGA, a DIB, a QOI, an SGI, a PCX, a DCX, an IM, a DDS, an
  ICO, a CUR, an ICNS, a PSD, Pillow's rarer formats, no image).

Encoders: ``encode_png`` writes 8-bit L, RGB and RGBA and 16-bit grey (the
modes the JAX ``ImageSaver`` writes through Pillow) as Pillow's ``save``
writes them; ``encode_png_samples``
writes any colour type, depth, palette, ``tRNS`` and interlacing (the
codec's fixtures); ``encode_hdr`` writes flat or run-length scanlines.
JPEG, BMP/DIB, TGA, TIFF, WebP, GIF, Netpbm, QOI, SGI, PCX, IM, DDS, ICO,
ICNS, JPEG 2000, EPS and PDF have their own encoders in their modules (``image_saver.ENCODERS`` picks
them by extension).

The JPEG kinds both libraries refuse raise ``OSError`` with Pillow's
message on Pillow's path and give None on OpenCV's (``jpeg.py`` lists
them); the kinds of ROADMAP.md's reading queue (a JPEG 2000 code-block
style, AVIF film grain and quantizer matrices, a LAB PSD, old-style JPEG
and ``tiff_raw_16`` TIFFs and the other TIFF layouts ``tiff.py`` lists)
raise ``NotImplementedError`` with their names. There is no substitute image.
Every decoder checks the
size its header claims against Pillow's limit (or OpenCV's, for
``read_image_cv2``) before it decodes a pixel (``image_limits.py``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np

from . import (blp, dds, eps, fits, fli, ftex, gbr, icns, ico, im, imt, iptc, mcidas, msp, pcd, pcx,
               pixar, psd, qoi, sgi, spider, sun, xbm, xpm, xvthumb)
from .avif import decode_avif, decode_avif_cv2, is_avif
from .bmp import decode_bmp, decode_bmp_cv2, decode_dib, is_dib
from .gif import decode_gif, decode_gif_cv2
from .image_limits import check_size
from .jpeg import MAGIC as JPEG_MAGIC
from .jpeg import decode_jpeg, decode_jpeg_cv2
from .jpeg2000 import J2K_MAGIC, JP2_MAGIC, decode_jpeg2000, decode_jpeg2000_cv2
from .netpbm import decode_netpbm, decode_netpbm_cv2
from .pillow_open import NotThisFormat
from .tga import FOOTER as TGA_FOOTER
from .tga import decode_tga
from .tiff import MAGIC as TIFF_MAGIC
from .tiff import decode_tiff, decode_tiff_cv2
from .webp import MAGIC as WEBP_MAGIC
from .webp import decode_webp, decode_webp_cv2

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# the byte after "P" that sends a file to OpenCV's Netpbm reading
PNM_KINDS = b"0123456789fFy"
# PNG colour type -> (samples per pixel, allowed bit depths)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
# OpenCV's decoders by magic bytes; every RIFF file goes to the WebP
# decoder, which gives None for one that is not WebP
_CV2_DECODERS = ((JPEG_MAGIC, decode_jpeg_cv2), (b"BM", decode_bmp_cv2),
                 (b"GIF87a", decode_gif_cv2), (b"GIF89a", decode_gif_cv2),
                 *((m, decode_tiff_cv2) for m in TIFF_MAGIC),
                 (WEBP_MAGIC, decode_webp_cv2), (J2K_MAGIC, decode_jpeg2000_cv2),
                 (JP2_MAGIC, decode_jpeg2000_cv2),
                 (sun.MAGIC.to_bytes(4, "big"), sun.decode_sun_cv2))


class PngImage(NamedTuple):
    """A PNG as stored: (H, W, C) samples (uint8, or uint16 at depth 16;
    at depths 1-4 the raw values 0 .. 2^depth - 1) and what interprets them."""

    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: np.ndarray | None  # (N, 3) uint8
    trns: bytes | None  # the raw tRNS chunk


# ---------------------------------------------------------------------------
# PNG decode
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (None, Sub, Up, Average, Paeth).
    Rows of the first three are vectorized along the row; runs of Average
    and Paeth rows go along anti-diagonals (a byte needs its left and upper
    neighbours only), vectorized over the run's rows."""
    rows = raw.reshape(height, stride + 1)
    ftypes = rows[:, 0].astype(np.int64)
    if (ftypes > 4).any():
        raise ValueError(f"PNG: unknown scanline filter {int(ftypes.max())}")
    groups = stride // bpp
    data = rows[:, 1:].astype(np.int32).reshape(height, groups, bpp)
    out = np.zeros((height, groups, bpp), np.int32)
    zero = np.zeros((groups, bpp), np.int32)
    y = 0
    while y < height:
        f = ftypes[y]
        prev = out[y - 1] if y else zero
        if f == 0:
            out[y] = data[y]
        elif f == 1:
            out[y] = data[y].cumsum(axis=0) & 255
        elif f == 2:
            out[y] = (data[y] + prev) & 255
        if f <= 2:
            y += 1
            continue
        end = y
        while end < height and ftypes[end] >= 3:
            end += 1
        n = end - y
        ks = np.arange(n)
        for t in range(n + groups - 1):
            k = ks[max(0, t - groups + 1): min(n, t + 1)]
            r, x = y + k, t - k
            a = np.where((x > 0)[:, None], out[r, np.maximum(x - 1, 0)], 0)
            up_ok = (r > 0)[:, None]
            b = np.where(up_ok, out[np.maximum(r - 1, 0), x], 0)
            c = np.where(up_ok & (x > 0)[:, None], out[np.maximum(r - 1, 0), np.maximum(x - 1, 0)], 0)
            pred = np.where((ftypes[r] == 3)[:, None], (a + b) >> 1, _paeth(a, b, c))
            out[r, x] = (data[r, x] + pred) & 255
        y = end
    return out.reshape(height, stride).astype(np.uint8)


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) bytes -> (h, width, channels) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, width, channels)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width].reshape(h, width, 1).astype(np.uint8)


def _decode_pass(raw: np.ndarray, pos: int, w: int, h: int, channels: int, depth: int):
    stride = (w * channels * depth + 7) // 8
    size = h * (stride + 1)
    if pos + size > raw.size:
        raise ValueError(f"PNG data has {raw.size} bytes, too few for the image")
    bpp = max(1, channels * depth // 8)
    rows = _unfilter(raw[pos: pos + size], h, stride, bpp)
    return _unpack(rows, w, channels, depth), pos + size


def decode_png_samples(data: bytes, name: str = "<bytes>", cv2: bool = False) -> PngImage:
    """The stored samples of a PNG (any colour type, depth and interlacing);
    the size limit is Pillow's, or with ``cv2`` OpenCV's."""
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, trns, idat = 8, None, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"{name}: PNG colour type {ctype} at depth {depth} is not valid")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    check_size(width, height, name, "PNG", cv2)
    channels = _PNG_TYPES[ctype][0]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        samples, _ = _decode_pass(raw, 0, width, height, channels, depth)
    else:
        samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if w <= 0 or h <= 0:
                continue
            sub, at = _decode_pass(raw, at, w, h, channels, depth)
            samples[y0::dy, x0::dx] = sub
    return PngImage(samples, ctype, depth, palette, trns)


def _pil_rgba(png: PngImage) -> np.ndarray:
    """(H, W, 4) uint8 as ``Image.open(...).convert("RGBA")`` (Pillow 12).

    Pillow first holds the samples in a mode of its own, then converts:
    grey 1-bit as "1" (0/255), 2- and 4-bit as "L" scaled by 85 / 17, 8-bit
    as "L", 16-bit as "I;16" (clipped at 255 on the way to RGBA); colour and
    alpha at 16 bits keep the high byte of each sample; palette indices
    look up PLTE (entries past its end are black). A grey or truecolour
    ``tRNS`` key is the raw sample value; Pillow keeps its low byte and
    compares it with the held 8-bit values (at depth 1 any key but 0 is
    the white pixels), so a key at depth 16, or at depths 2 and 4 once
    scaled, matches only where the two coincide."""
    s, ctype, depth = png.samples, png.color_type, png.bit_depth
    h, w = s.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(png.palette)] = png.palette[:256]
        idx = s[..., 0].astype(np.int64)
        out[..., :3] = pal[idx]
        if png.trns is not None:
            alpha = np.full(256, 255, np.uint8)
            t = np.frombuffer(png.trns, np.uint8)[:256]
            alpha[: len(t)] = t
            out[..., 3] = alpha[idx]
        return out
    if ctype in (0, 4):
        g = s[..., 0]
        if depth == 16:  # "I;16" clipped (grey), "LA" from the high bytes
            grey = np.minimum(g, 255) if ctype == 0 else g >> 8
        else:
            grey = g.astype(np.int64) * (255 // ((1 << depth) - 1))
        out[..., :3] = grey.astype(np.uint8)[..., None]
        if ctype == 4:
            a = s[..., 1]
            out[..., 3] = (a >> 8) if depth == 16 else a
        elif png.trns is not None and len(png.trns) >= 2:
            (key,) = struct.unpack(">H", png.trns[:2])
            key = (255 if key else 0) if depth == 1 else key & 255
            out[..., 3] = np.where(grey == key, 0, 255)
        return out
    rgb = (s[..., :3] >> 8).astype(np.uint8) if depth == 16 else s[..., :3]
    out[..., :3] = rgb
    if ctype == 6:
        out[..., 3] = (s[..., 3] >> 8) if depth == 16 else s[..., 3]
    elif png.trns is not None and len(png.trns) >= 6:
        key = np.array(struct.unpack(">HHH", png.trns[:6])) & 255
        out[..., 3] = np.where((rgb.astype(np.int64) == key).all(-1), 0, 255)
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    return _pil_rgba(decode_png_samples(data, name))


def _ppm(data: bytes, name: str) -> np.ndarray:
    """PPM as Pillow takes it: a header its plugin does not identify sends
    the file on to the next format."""
    try:
        return decode_netpbm(data, name)
    except ValueError as e:
        if "cannot identify the image" in str(e):
            raise NotThisFormat(str(e)) from e
        raise


def _stub(fmt: str):
    """The stubs Pillow opens without a handler (BUFR, GRIB, HDF5): the
    load raises."""
    def refuse(data: bytes, name: str):
        raise OSError(f"cannot find loader for this {fmt} file")
    return refuse


def _mpeg(data: bytes, name: str):
    """MPEG: Pillow reads the sequence header's size, then has no decoder."""
    if len(data) < 7:
        raise NotThisFormat("index out of range")
    w, h = data[4] << 4 | data[5] >> 4, (data[5] & 15) << 8 | data[6]
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "MPEG")
    raise OSError("cannot load this image")


def _wmf(data: bytes, name: str):
    """WMF and EMF: Pillow reads the size, then has no renderer on Linux."""
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            raise NotThisFormat("unpack_from requires a buffer of at least 16 bytes")
        inch = struct.unpack_from("<H", s, 14)[0]
        if inch == 0:
            raise ValueError("Invalid inch")
        x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
        size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
        if s[22:26] != b"\x01\x00\t\x00":
            raise NotThisFormat("Unsupported WMF file format")
    elif s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        # the dots per inch Pillow computes: ZeroDivisionError on an empty frame
        _dpi = 2540.0 * (x1 - x0) / (f2 - f0), 2540.0 * (y1 - y0) / (f3 - f1)
        size = x1 - x0, y1 - y0
    else:
        raise NotThisFormat("Unsupported file format")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(*size, name, "WMF")
    raise OSError("cannot find loader for this WMF file")


def _tga(data: bytes, name: str) -> np.ndarray:
    """TGA has no magic bytes: here its extension or its 2.0 footer names it."""
    if not (name.lower().endswith(".tga") or data.endswith(TGA_FOOTER)):
        raise NotThisFormat("not a TGA file")
    return decode_tga(data, name)


# Pillow 12.1.0's Image.open order: the formats of ``preinit`` (BMP, DIB,
# GIF, JPEG, PPM, PNG), then every plugin as ``init`` registers it. Each
# entry: (name, the test of the plugin's ``_accept``, which sees the first
# 16 bytes, or None where the plugin has none; Pillow's reading). A reading
# that raises ``NotThisFormat`` sends the file on to the next entry, as
# Pillow's open does on ``SyntaxError``; the formats the port read before
# this list existed are taken by their magic and raise from their modules.
PILLOW_ORDER = (
    ("BMP", lambda d: d[:2] == b"BM", decode_bmp),
    ("DIB", is_dib, decode_dib),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("JPEG", lambda d: d.startswith(JPEG_MAGIC), decode_jpeg),
    ("PPM", lambda d: d[:1] == b"P" and d[1:2] != b"" and d[1:2] in b"0123456fy", _ppm),
    ("PNG", lambda d: d[:8] == PNG_MAGIC, decode_png),
    ("AVIF", is_avif, decode_avif),
    ("BLP", blp.accept, blp.decode_blp),
    ("BUFR", lambda d: d.startswith((b"BUFR", b"ZCZC")), _stub("BUFR")),
    ("CUR", ico.is_cur, ico.decode_cur),
    ("PCX", pcx.is_pcx, pcx.decode_pcx),
    ("DCX", pcx.is_dcx, pcx.decode_dcx),
    ("DDS", lambda d: d.startswith(dds.MAGIC), dds.decode_dds),
    ("EPS", eps.accept, eps.decode_eps),
    ("FITS", fits.accept, fits.decode_fits),
    ("FLI", fli.accept, fli.decode_fli),
    ("FTEX", ftex.accept, ftex.decode_ftex),
    ("GBR", gbr.accept, gbr.decode_gbr),
    ("GRIB", lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1, _stub("GRIB")),
    ("HDF5", lambda d: d.startswith(b"\x89HDF\r\n\x1a\n"), _stub("HDF5")),
    ("JPEG2000", lambda d: d.startswith((J2K_MAGIC, JP2_MAGIC)), decode_jpeg2000),
    ("ICNS", lambda d: d.startswith(icns.MAGIC), icns.decode_icns),
    ("ICO", ico.is_ico, ico.decode_ico),
    ("IM", lambda d: im.parse_header(d) is not None, im.decode_im),
    ("IMT", None, imt.decode_imt),
    ("IPTC", None, iptc.decode_iptc),
    ("MCIDAS", mcidas.accept, mcidas.decode_mcidas),
    ("MPEG", lambda d: d.startswith(b"\x00\x00\x01\xb3"), _mpeg),
    ("TIFF", lambda d: d[:4] in TIFF_MAGIC, decode_tiff),
    ("MSP", msp.accept, msp.decode_msp),
    ("PCD", None, pcd.decode_pcd),
    ("PIXAR", pixar.accept, pixar.decode_pixar),
    ("PSD", lambda d: d.startswith(psd.MAGIC), psd.decode_psd),
    ("QOI", lambda d: d.startswith(qoi.MAGIC), qoi.decode_qoi),
    ("SGI", sgi.is_sgi, sgi.decode_sgi),
    ("SPIDER", None, spider.decode_spider),
    ("SUN", sun.is_sun, sun.decode_sun),
    ("TGA", None, _tga),
    ("WEBP", lambda d: d.startswith(WEBP_MAGIC), decode_webp),
    ("WMF", lambda d: d.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")), _wmf),
    ("XBM", xbm.accept, xbm.decode_xbm),
    ("XPM", lambda d: d.startswith(xpm.MAGIC), xpm.decode_xpm),
    ("XVTHUMB", xvthumb.accept, xvthumb.decode_xvthumb),
)


# the readers that read as Pillow reads a file opened by its path (mapped
# raw rows, a file's ``read`` of a negative length), not a byte stream
FROM_FILE = ("FITS", "FTEX", "GBR", "IMT", "MCIDAS", "XVTHUMB")


def decode_image(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``; raises what
    Pillow raises, and for a file no format takes Pillow's
    ``UnidentifiedImageError`` message as an ``OSError``. ``from_file``:
    the bytes are a file Pillow opens by its path, else a stream."""
    for fmt, accept, read in PILLOW_ORDER:
        if accept is not None and not accept(data):
            continue
        try:
            return read(data, name, from_file=from_file) if fmt in FROM_FILE else read(data, name)
        except NotThisFormat:
            continue
    raise OSError(f"cannot identify image file {name!r}")


def read_image(path: str) -> np.ndarray:
    """``decode_image`` of a file."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path, from_file=True)


def read_png_samples(path: str) -> PngImage:
    with open(path, "rb") as f:
        return decode_png_samples(f.read(), path)


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE)
# ---------------------------------------------------------------------------


def decode_hdr(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Radiance ``.hdr`` -> (H, W, 3) float32 RGB, as OpenCV reads it: the
    header's ``EXPOSURE`` is not applied, a pixel is mantissa * 2^(e - 136)
    (no half-step added; e = 0 is black), scanlines flat or new-style
    run-length, the ``-Y H +X W`` orientation only."""
    if data[:2] != b"#?":
        raise ValueError(f"{name}: not a Radiance HDR file")
    pos = 0
    fmt = None
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line[7:].decode()
    if fmt not in (None, "32-bit_rle_rgbe"):
        raise NotImplementedError(f"{name}: Radiance format {fmt} is not supported")
    end = data.index(b"\n", pos)
    line = data[pos:end]
    res = line.split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise NotImplementedError(
            f"{name}: Radiance orientation {line.decode(errors='replace')!r} is not supported "
            "(-Y H +X W only)"
        )
    height, width = int(res[1]), int(res[3])
    check_size(width, height, name, "Radiance HDR", cv2=True)
    buf = np.frombuffer(data, np.uint8)
    rgbe = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        if (width < 8 or width > 0x7FFF or pos + 4 > len(data) or data[pos] != 2
                or data[pos + 1] != 2 or data[pos + 2] & 0x80):
            # flat from here on (OpenCV reads the rest of a file flat once a
            # scanline does not start as a run-length one)
            n = (height - y) * width * 4
            rgbe[y:] = buf[pos: pos + n].reshape(height - y, width, 4)
            break
        if (data[pos + 2] << 8 | data[pos + 3]) != width:
            raise ValueError(f"{name}: wrong scanline width")
        pos += 4
        for c in range(4):
            x = 0
            line = rgbe[y, :, c]
            while x < width:
                count = data[pos]
                pos += 1
                if count > 128:
                    count -= 128
                    if count == 0 or x + count > width:
                        raise ValueError(f"{name}: bad scanline data")
                    line[x: x + count] = data[pos]
                    pos += 1
                else:
                    if count == 0 or x + count > width:
                        raise ValueError(f"{name}: bad scanline data")
                    line[x: x + count] = buf[pos: pos + count]
                    pos += count
                x += count
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float64)
    v = rgb.max(axis=-1)
    mant, exp = np.frexp(v)
    scale = np.where(v > 1e-32, mant * 256.0 / np.where(v > 1e-32, v, 1.0), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, exp + 128, 0).astype(np.uint8)
    return out


def _rle_component(vals: np.ndarray) -> bytes:
    """One scanline component in new-style RLE: runs of >= 4 equal bytes
    as runs, the rest as literals of at most 128."""
    out = bytearray()
    n, x = len(vals), 0
    while x < n:
        run = 1
        while x + run < n and run < 127 and vals[x + run] == vals[x]:
            run += 1
        if run >= 4:
            out += bytes([128 + run, int(vals[x])])
            x += run
            continue
        start = x
        while x < n and x - start < 128:
            r = 1
            while x + r < n and r < 4 and vals[x + r] == vals[x]:
                r += 1
            if r >= 4:
                break
            x += 1
        out += bytes([x - start]) + vals[start:x].tobytes()
    return bytes(out)


def encode_hdr(rgb: np.ndarray, rle: bool = True, exposure: float | None = None) -> bytes:
    """(H, W, 3) float RGB -> Radiance ``.hdr`` bytes; ``rle`` writes
    new-style run-length scanlines (width 8 .. 32767), else flat ones;
    ``exposure`` adds an ``EXPOSURE=`` header line (readers do not apply it)."""
    rgb = np.asarray(rgb)
    height, width = rgb.shape[:2]
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n"
    if exposure is not None:
        head += f"EXPOSURE={exposure}\n".encode()
    head += f"\n-Y {height} +X {width}\n".encode()
    rgbe = _float_to_rgbe(rgb)
    if not rle or not 8 <= width <= 0x7FFF:
        return head + rgbe.tobytes()
    body = bytearray()
    for y in range(height):
        body += bytes([2, 2, width >> 8, width & 255])
        for c in range(4):
            body += _rle_component(rgbe[y, :, c])
    return head + bytes(body)


def read_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_hdr(f.read(), path)


def read_image_cv2(path: str) -> np.ndarray | None:
    """The array ``cv2.imread(path, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``
    gives: grey (H, W), colour (H, W, 3) in BGR order with alpha dropped
    and palettes expanded; uint8, uint16 at depth 16 (grey PNG at depths
    1-4 scaled to 8 bits), float32 for HDR; frame 0 of a WebP; AVIF in
    BGR; a Sun raster by OpenCV's own rules (``sun.decode_sun_cv2``); None
    for a TGA, a DIB, a QOI, an SGI, a PCX, a DCX, an IM, a DDS, an ICO, a
    CUR, an ICNS, a PSD, Pillow's rarer formats or a file that is no image,
    as OpenCV reads none."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"#?":
        return np.ascontiguousarray(decode_hdr(data, path)[..., ::-1])
    if data[:1] == b"P" and data[1:2] and data[1:2] in PNM_KINDS:
        return decode_netpbm_cv2(data, path)
    for magic, cv2_reading in _CV2_DECODERS:
        if data.startswith(magic):
            return cv2_reading(data, path)
    if is_avif(data):
        return decode_avif_cv2(data, path)
    if data[:8] != PNG_MAGIC:
        # what OpenCV does not read (a TGA, a DIB, a QOI, ... or no image)
        return None
    png = decode_png_samples(data, path, cv2=True)
    s, ctype, depth = png.samples, png.color_type, png.bit_depth
    if ctype == 0:
        g = s[..., 0]
        return g if depth >= 8 else (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(png.palette)] = png.palette[:256]
        rgb = pal[s[..., 0].astype(np.int64)]
    elif ctype == 4:
        rgb = np.repeat(s[..., :1], 3, axis=2)
    else:
        rgb = s[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


# ---------------------------------------------------------------------------
# PNG encode
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, C) samples -> (h, stride) bytes."""
    h = samples.shape[0]
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    per = 8 // depth
    vals = samples.reshape(h, -1).astype(np.uint8)
    pad = (-vals.shape[1]) % per
    vals = np.concatenate([vals, np.zeros((h, pad), np.uint8)], axis=1).reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (vals << shifts).sum(axis=2).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row with ``ftype`` (0-4); (h, stride + 1) bytes."""
    cur = rows.astype(np.int32)
    prev = np.concatenate([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.concatenate([np.zeros_like(cur[:, :bpp]), cur[:, :-bpp]], axis=1)
    upleft = np.concatenate([np.zeros_like(prev[:, :bpp]), prev[:, :-bpp]], axis=1)
    pred = [np.zeros_like(cur), left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][ftype]
    body = ((cur - pred) & 255).astype(np.uint8)
    return np.concatenate([np.full((rows.shape[0], 1), ftype, np.uint8), body], axis=1)


def encode_png_samples(samples: np.ndarray, color_type: int, bit_depth: int,
                       palette: np.ndarray | None = None, trns: bytes | None = None,
                       interlace: bool = False, filter_type: int = 0) -> bytes:
    """Any PNG: (H, W, C) samples of ``color_type`` at ``bit_depth``, an
    optional PLTE and raw ``tRNS`` body, Adam7 with ``interlace``, every
    scanline filtered with ``filter_type``."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    channels, depths = _PNG_TYPES[color_type]
    if bit_depth not in depths or samples.shape[2] != channels:
        raise ValueError(f"PNG colour type {color_type} takes {channels} samples at "
                         f"depths {depths}")
    height, width = samples.shape[:2]
    bpp = max(1, channels * bit_depth // 8)
    if interlace:
        parts = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        parts = [p for p in parts if p.shape[0] and p.shape[1]]
    else:
        parts = [samples]
    raw = b"".join(_filtered(_pack_rows(p, bit_depth), bpp, filter_type).tobytes() for p in parts)
    ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, int(interlace))
    out = PNG_MAGIC + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


PNG_BLOCK = 65536  # ImageFile.MAXBLOCK: Pillow's encoder buffer is max(this, 4 * width)


def _adaptive_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Pillow's ZipEncode filter choice: per row, of None, Up, Sub and
    Paeth tried in that order, the first whose bytes (as signed) have the
    least sum of magnitudes; (h, stride + 1) bytes."""
    cur = rows.astype(np.int32)
    prior = np.concatenate([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.concatenate([np.zeros_like(cur[:, :bpp]), cur[:, :-bpp]], axis=1)
    upleft = np.concatenate([np.zeros_like(prior[:, :bpp]), prior[:, :-bpp]], axis=1)
    best = choice = out = None
    for ftype, pred in ((0, 0), (2, prior), (1, left), (4, _paeth(left, prior, upleft))):
        body = (cur - pred) & 255
        cost = np.where(body < 128, body, 256 - body).sum(axis=1)
        if best is None:
            best, choice, out = cost, np.zeros(len(cur), np.uint8), body
            continue
        better = (best > 0) & (cost < best)
        best = np.where(better, cost, best)
        choice[better] = ftype
        out[better] = body[better]
    return np.concatenate([choice[:, None], out.astype(np.uint8)], axis=1)


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA, or uint16 (H, W)
    16-bit grey -> the PNG Pillow 12's ``save`` writes for them: IHDR, the
    rows filtered as ``_adaptive_rows`` picks, deflated at level 6 with
    ``Z_FILTERED`` and memLevel 9, in IDAT chunks of at most max(65536,
    4 x width) bytes, IEND. The bytes are Pillow's where Python's zlib is
    the one Pillow links (the samples are the same with any zlib)."""
    a = np.asarray(pixels)
    if a.dtype == np.uint16 and a.ndim == 2:
        ctype, depth = 0, 16
    elif a.dtype == np.uint8 and a.ndim == 2:
        ctype, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in (3, 4):
        ctype, depth = (2 if a.shape[2] == 3 else 6), 8
    else:
        raise ValueError("encode_png expects uint8 (H, W), (H, W, 3|4) or uint16 (H, W), not "
                         f"{a.dtype} {a.shape}")
    height, width = a.shape[:2]
    channels = 1 if a.ndim == 2 else a.shape[2]
    rows = _pack_rows(a.reshape(height, width, channels), depth)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_adaptive_rows(rows, channels * depth // 8).tobytes()) + z.flush()
    block = max(PNG_BLOCK, 4 * width)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    return (PNG_MAGIC + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", data[i: i + block]) for i in range(0, len(data), block))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
