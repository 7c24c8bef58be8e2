"""Writers of image files for the port's codec tests, and the generator of
the committed fixtures in ``stillleben_tpu_torch/assets/image_fixtures/``.

The writers make the variants that Pillow and OpenCV do not write (RLE
BMP, 16-bit and BITFIELDS BMP, top-down and OS/2 BMP, 16-bit and
colour-mapped TGA, the TGA origin bits, GIF with a local table or a frame
smaller than its screen, tiled, big-endian and predicted TIFF, an
animated WebP whose frame 0 is smaller than its canvas); each file is
decoded by Pillow or OpenCV as the reference.

``make_fixtures()`` writes, from seeded numpy images, the files the port
cannot write (progressive JPEG, GIF, LZW and Deflate TIFF, RLE TGA with
Pillow; RLE8 BMP with ``rle8_bmp`` here, which Pillow decodes) and
``digests()`` the SHA-256 of Pillow's decodes and of Pillow's JPEG
encodes of ``image_fixtures.seeded_images()``; ``make_webp_fixtures()``
the WebP files (Pillow's encodes) and ``webp_digests()`` Pillow's and
OpenCV's readings of them. Regenerate with

    python tests/torch_image_fixtures.py --write

``make_encode_fixtures()`` writes Pillow's ``save`` of
``image_fixtures.encode_sources()`` (GIF, PGM, PPM) in the modes the JAX
``ImageSaver`` hands Pillow (``pillow_save``), ``encode_digests()`` their
SHA-256; ``gif_divergence`` names the first stage (header, palette,
transparency, index image, LZW stream) at which two GIF files part.

The plain formats (QOI, SGI, PCX, DCX, IM, DDS): ``sgi_file`` (planar or
run-length at 1 or 2 bytes a sample), ``pcx_file`` (any bits and planes,
every byte as a run of one), ``dcx`` (a table of PCX frames), ``dds_file``
(any pixel format, FourCC or DX10 header) with ``dds_masked`` (pixels
packed by masks) and ``bcn_blocks`` (seeded random blocks);
``make_plain_fixtures()`` writes the committed plain files (Pillow's
``save`` where Pillow writes the variant) and ``plain_digests()`` their
SHA-256 and Pillow's readings.

The JPEG variants: ``libjpeg_write`` is libjpeg-turbo 3.1's own encoder
(a C shim, built by gcc at first use into the port's gitignored
``_build/``, over the system ``jpeglib.h`` and the ``libjpeg-*.so`` Pillow
bundles): arithmetic coding with its DAC conditioning, libjpeg's simple
progression, lossless (predictor, point transform), CMYK/YCCK, 12- and
16-bit samples, restarts; ``lossless_jpeg`` writes the lossless files
libjpeg does not (subsampled components, YCbCr); ``jpeg_cut_after_scan``
and ``jpeg_patch_marker`` make the cut and renamed-frame files;
``make_jpeg_variant_fixtures()`` writes the committed variants and
``jpeg_variant_digests()`` Pillow's and OpenCV's
readings of them (``pillow_reading``, ``cv2_reading``).

JPEG 2000, EPS and PDF: ``pillow_file`` is Pillow's ``save`` to a named
file (the name picks the container and a PDF's title), ``fixed_clock``
fixes ``time.gmtime`` for a PDF's dates, ``patch_cod_style`` makes the
code-block style Pillow does not write; ``make_jpeg2000_fixtures()``
writes the committed JPEG 2000 files and ``jpeg2000_digests()`` their
SHA-256, Pillow's and OpenCV's readings and the digests of Pillow's
files of ``jpeg2000_saver_sources()``.

AVIF: ``make_avif_fixtures()`` writes Pillow's files of
``image_fixtures.avif_sources()`` and a three-frame ``.avifs``, and
``avif_digests()`` their SHA-256 and Pillow's and OpenCV's readings;
``avif_encode_digests()`` the SHA-256 of the port's own files of
``avif_write_sources()`` (``--avif-encode`` rewrites those alone).
``make_avif_cv2_fixtures()`` writes ``AVIF_CV2_FILES`` (OpenCV's
``imwrite`` at 8, 10 and 12 bits, Pillow's 4:0:0 and quantizer matrices,
film grain through OpenCV's libavif: ``libavif_encode_planes``;
``--avif-cv2`` writes these and their digests alone); ``--avif-cv2-sweep N
[START]`` holds seeded files of those writers to both libraries.

Pillow's rarer formats: ``make_pillow_format_fixtures()`` writes the
committed files of BLP, FTEX, Sun raster, XBM, XPM, MSP, GBR, FITS,
FLI/FLC, SPIDER, McIdas, PIXAR, IM Tools, XV thumbnails and IPTC (Pillow's
``save`` of BLP1 and BLP2 palette images, XBM and MSP; OpenCV's ``imwrite``
of ``.ras``; ``image_fixtures.rare_formats``' writers for the rest, and
the textured scene's blob base colour as BLP2 DXT5 and checker as a
run-length Sun raster) and ``pillow_format_digests()`` their SHA-256 and
Pillow's and OpenCV's readings, and those of the seeded PhotoCD files
(``--pillow-formats`` writes these alone); ``pillow_formats_sweep_case``
draws a file of a writer's options from a seed (``--pillow-formats-sweep
N [START]`` holds N of them to Pillow's and OpenCV's readings;
``--pillow-formats-times`` times Pillow and the port on one 640x480 file
per format on this host).

``vp8_divergence`` names the first stage at which two lossy WebP files
part (the divergence finder of the port's encoder), ``vp8l_divergence``
(and ``alph_divergence`` for two files' ALPH chunks) the first part of two
VP8L streams (``vp8l_parse``); ``libwebp_alpha_stream`` is libwebp's own
stream of an alpha plane, the oracle; ``--alph`` prints the port's ALPH
chunks against libwebp's.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "stillleben_tpu_torch", "assets", "image_fixtures")
if ROOT not in sys.path:  # run as a script from the checkout
    sys.path.insert(0, ROOT)

from stillleben_tpu_torch.assets.image_fixtures import tiff_files  # noqa: E402


def smooth(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded uint8 (h, w, c): low-frequency waves and a little noise, the
    content JPEG is made for."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = np.zeros((h, w, c))
    for k in range(c):
        fx, fy = rng.uniform(0.5, 4, 2)
        out[..., k] = 128 + 90 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + rng.uniform(0, 6))
    out += rng.normal(0, 12, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp(body_rows: list[bytes] | bytes, width: int, height: int, bits: int, *,
        compression: int = 0, palette: np.ndarray | None = None, masks=(), header: int = 40,
        top_down: bool = False) -> bytes:
    """A BMP around ready pixel data (rows already in file order, padded)."""
    body = body_rows if isinstance(body_rows, bytes) else b"".join(body_rows)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pal = b"" if palette is None else np.asarray(palette, np.uint8)[:, ::-1].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(body), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header > 40:
            info += b"".join(struct.pack("<I", m) for m in masks)
            info += b"\0" * (header - 40 - 4 * len(masks))
            masks = ()
        pal = b""
        if palette is not None:
            p = np.zeros((len(palette), 4), np.uint8)
            p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
            pal = p.tobytes()
    extra = b"".join(struct.pack("<I", m) for m in masks)
    offset = 14 + len(info) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + info + extra + pal + body


def raw_rows(pix: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """(h, w) indices at 1/4/8 bits or (h, w, k) bytes per pixel as padded rows."""
    rows = pix if top_down else pix[::-1]
    if pix.ndim == 2 and bits < 8:
        per = 8 // bits
        w = rows.shape[1]
        pad = np.zeros((rows.shape[0], (-w) % per), np.uint8)
        v = np.concatenate([rows, pad], 1).reshape(rows.shape[0], -1, per).astype(np.int64)
        rows = (v << (bits * np.arange(per - 1, -1, -1))).sum(-1).astype(np.uint8)
    rows = rows.reshape(rows.shape[0], -1)
    stride = (rows.shape[1] + 3) & ~3
    out = np.zeros((rows.shape[0], stride), np.uint8)
    out[:, : rows.shape[1]] = rows
    return out.tobytes()


def rle8_bmp(index: np.ndarray, palette: np.ndarray, rle4: bool = False) -> bytes:
    """RLE8 (or RLE4) BMP: runs of two or more as encoded runs, stretches of
    three or more distinct values as absolute runs (padded to words), end of
    line after every row and end of bitmap."""
    h, w = index.shape
    out = bytearray()
    for row in index[::-1]:
        x = 0
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2 or x + 1 == w:
                out += bytes([run, int(row[x]) * 17 if rle4 else int(row[x])])
                x += run
                continue
            end = x
            while end < w and end - x < 255 and (end + 1 >= w or row[end + 1] != row[end]):
                end += 1
            n = end - x
            if n < 3:
                out += bytes([1, int(row[x]) * 17 if rle4 else int(row[x])])
                x += 1
                continue
            vals = row[x:end].astype(np.uint8)
            if rle4:
                v = np.concatenate([vals, np.zeros(n % 2, np.uint8)]).reshape(-1, 2)
                data = ((v[:, 0] << 4) | v[:, 1]).astype(np.uint8).tobytes()
            else:
                data = vals.tobytes()
            out += bytes([0, n]) + data + b"\0" * (len(data) % 2)
            x = end
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bmp(bytes(out), w, h, 4 if rle4 else 8, compression=2 if rle4 else 1, palette=palette)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------


def tga(pix_bytes: bytes, width: int, height: int, itype: int, depth: int, *, flags: int = 0,
        cmap: bytes = b"", cmap_start: int = 0, cmap_len: int = 0, cmap_depth: int = 0,
        ident: bytes = b"") -> bytes:
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap_len else 0, itype, cmap_start,
                       cmap_len, cmap_depth, 0, 0, width, height, depth, flags)
    return head + ident + cmap + pix_bytes


def tga_rle(pix: np.ndarray, width: int = 0) -> bytes:
    """(n, bpp) pixels as run-length packets: literal packets across rows,
    repeat packets within a row of ``width`` (across rows with 0)."""
    out = bytearray()
    i, n = 0, len(pix)
    while i < n:
        run, end = 1, n if not width else (i // width + 1) * width
        while i + run < end and run < 128 and (pix[i + run] == pix[i]).all():
            run += 1
        if run > 1:
            out += bytes([0x80 | (run - 1)]) + pix[i].tobytes()
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and (pix[j + 1] == pix[j]).all()):
            j += 1
        out += bytes([j - i - 1]) + pix[i:j].tobytes()
        i = j
    return bytes(out)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def lzw_gif(index: np.ndarray, min_code: int) -> bytes:
    """GIF's LZW of the indices with a clear code at the start and a table
    reset when it fills: plain, valid codes."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    size = min_code + 1
    out_bits = []
    table = {bytes([i]): i for i in range(clear)}
    nxt = eoi + 1

    def emit(c, s):
        out_bits.append((c, s))

    emit(clear, size)
    cur = b""
    for v in index.reshape(-1).tolist():
        nb = cur + bytes([v])
        if nb in table:
            cur = nb
            continue
        emit(table[cur], size)
        if nxt < 4096:
            table[nb] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear, size)
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = eoi + 1, min_code + 1
        cur = bytes([v])
    if cur:
        emit(table[cur], size)
    emit(eoi, size)
    acc, nbits, data = 0, 0, bytearray()
    for c, s in out_bits:
        acc |= c << nbits
        nbits += s
        while nbits >= 8:
            data.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        data.append(acc & 255)
    return bytes(data)


def gif(index: np.ndarray, *, screen=None, offset=(0, 0), global_pal=None, local_pal=None,
        transparency=None, interlace=False, background=0) -> bytes:
    h, w = index.shape
    sw, sh = screen or (w, h)

    def table_bits(p):
        return max(1, int(np.ceil(np.log2(max(len(p), 2)))))

    def table(p):
        t = np.zeros((1 << table_bits(p), 3), np.uint8)
        t[: len(p)] = p
        return t.tobytes()

    flags = 0 if global_pal is None else 0x80 | (table_bits(global_pal) - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, flags, background, 0)
    if global_pal is not None:
        out += table(global_pal)
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    iflags = 0x40 if interlace else 0
    if local_pal is not None:
        iflags |= 0x80 | (table_bits(local_pal) - 1)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, iflags)
    if local_pal is not None:
        out += table(local_pal)
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        index = index[order]
    min_code = max(2, table_bits(local_pal if local_pal is not None else global_pal))
    data = lzw_gif(index, min_code)
    out += bytes([min_code])
    for i in range(0, len(data), 255):
        chunk = data[i: i + 255]
        out += bytes([len(chunk)]) + chunk
    return out + b"\x00;"


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


# the package's writer (the card's host remakes its files without Pillow)
packbits = tiff_files.packbits
tiff = tiff_files.tiff_file


def forked(fn, *args, **kw):
    """``fn(*args, **kw)`` in a forked child: its value, None where the
    child dies (libtiff's encoder aborts the process on some settings), or
    what it raises, raised here."""
    import pickle

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            out = ("ok", fn(*args, **kw))
        except Exception as e:  # noqa: BLE001  (sent to the parent, which raises it)
            out = ("error", e)
        with os.fdopen(w, "wb") as f:
            pickle.dump(out, f)
        os._exit(0)
    os.close(w)
    with os.fdopen(r, "rb") as f:
        data = f.read()
    os.waitpid(pid, 0)
    if not data:
        return None
    kind, value = pickle.loads(data)
    if kind == "error":
        raise value
    return value


def _pillow_tiff(pixels: np.ndarray, mode: str, **kw) -> bytes:
    from PIL import Image

    b = io.BytesIO()
    Image.frombytes(mode, pixels.shape[1::-1], pixels.tobytes()).save(b, "TIFF", **kw)
    return b.getvalue()


def pillow_tiff(pixels: np.ndarray, mode: str, **kw) -> bytes | None:
    """Pillow's ``save(..., "TIFF", **kw)`` of ``pixels`` (the mode's raw
    bytes, (h, w) or (h, w, bands)) in a forked child: None where libtiff
    aborts the process."""
    return forked(_pillow_tiff, np.ascontiguousarray(pixels), mode, **kw)


# Pillow's TIFF modes: (bands, numpy dtype of their raw bytes)
TIFF_MODES = {"1": (1, "u1"), "L": (1, "u1"), "LA": (2, "u1"), "RGB": (3, "u1"),
              "RGBA": (4, "u1"), "CMYK": (4, "u1"), "YCbCr": (3, "u1"), "LAB": (3, "u1"),
              "I;16": (1, "<u2"), "I;16B": (1, ">u2"), "F": (1, "<f4"), "I": (1, "<i4"),
              "P": (1, "u1"), "PA": (2, "u1")}
# the compressions libtiff writes for each
TIFF_CODECS = ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits", "lzma", "zstd")
TIFF_JPEG_MODES = ("L", "LA", "RGB", "RGBA", "CMYK", "YCbCr", "LAB")
TIFF_SWEEP_SIZES = ((1, 1), (3, 5), (37, 53), (64, 17), (130, 65))


def tiff_mode_pixels(mode: str, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded raw bytes of ``mode`` (smooth, so JPEG and the codecs see
    image-like content; F and I spread over their range)."""
    bands, dt = TIFF_MODES[mode]
    rng = np.random.default_rng(seed)
    if mode == "1":
        return (smooth(h, w, 1, seed)[..., 0] > 127).astype(np.uint8) * 255
    if mode == "F":
        return (rng.standard_normal((h, w)) * 200 + 100).astype("<f4")
    if mode == "I":
        return rng.integers(-300, 600, (h, w)).astype("<i4")
    if dt.endswith("u2"):
        return (smooth(h, w, 1, seed)[..., 0].astype(np.uint16) * 257 + rng.integers(
            0, 257, (h, w))).astype(dt)
    a = smooth(h, w, bands, seed)
    return a[..., 0] if bands == 1 else a


def tiff_sweep_case(i: int) -> tuple[str, bytes]:
    """A seeded TIFF: Pillow's ``save`` of a mode and compression (JPEG at
    a seeded quality, CCITT for mode 1, BigTIFF), or ``tiff_files.tiff_file``
    of a photometric, sample type, layout (strips or tiles, planar), byte
    order, fill order, predictor and codec. (label, bytes)."""
    rng = np.random.default_rng(1000 + i)
    pick = lambda options: options[int(rng.integers(len(options)))]  # noqa: E731
    h, w = pick(TIFF_SWEEP_SIZES)
    if rng.random() < 0.3:
        h, w = w, h
    if i % 5 < 2:  # Pillow's writer
        mode = pick(tuple(TIFF_MODES))
        codecs = TIFF_CODECS + (("jpeg",) if mode in TIFF_JPEG_MODES else ()) + (
            ("group3", "group4", "tiff_ccitt") if mode == "1" else ())
        comp = pick(codecs)
        kw = {"compression": comp}
        if comp == "jpeg":
            kw["quality"] = int(rng.integers(10, 96))
        if comp == "raw" and rng.random() < 0.5:
            kw["big_tiff"] = True
        px = tiff_mode_pixels(mode, h, w, i)
        if mode in ("P", "PA"):
            px = (px.astype(np.uint16) % 64).astype(np.uint8)
        label = f"pillow {mode} {comp} {w}x{h} {kw}"
        return label, pillow_tiff(px, mode, **kw) or b""
    kind = pick(("grey", "grey", "rgb", "rgb", "palette", "cmyk", "ycbcr", "lab"))
    dtype = "u1"
    spp, extra, photo, bits, colormap, tags = 1, (), 1, 0, None, {}
    if kind == "grey":
        photo = pick((0, 1))
        dtype = pick(("b1", "b2", "b4", "u1", "u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8"))
        if dtype == "u1" and rng.random() < 0.3:
            spp, extra = 2, (2,)
    elif kind == "rgb":
        photo = 2
        dtype = pick(("u1", "u1", "u2", "i2", "i4", "f4", "f8"))
        spp = pick((3, 3, 4))
        if spp == 4:
            extra = pick(((), (0,), (1,), (2,)))
    elif kind == "palette":
        photo = 3
        dtype = pick(("b1", "b2", "b4", "u1"))
    elif kind == "cmyk":
        photo, spp = 5, 4
        dtype = pick(("u1", "u1", "u2"))
    elif kind == "ycbcr":
        photo, spp = 6, 3
        tags = {530: (3, (1, 1)), 532: (5, ((0, 1), (255, 1), (128, 1), (255, 1), (128, 1),
                                            (255, 1)))}
    else:
        photo, spp = 8, 3
    if dtype.startswith("b"):
        bits = int(dtype[1])
        samples = rng.integers(0, 1 << bits, (h, w, 1)).astype(np.uint8)
        dt = np.dtype(np.uint8)
    else:
        dt = np.dtype(dtype)
        if dt.kind == "f":
            samples = (rng.standard_normal((h, w, spp)) * 150 + 100).astype(dt)
        elif dt.itemsize == 1:
            samples = smooth(h, w, spp, i).astype(dt)
        else:
            info = np.iinfo(dt)
            samples = rng.integers(max(info.min, -2 ** 20), min(info.max, 2 ** 20) + 1,
                                   (h, w, spp)).astype(dt)
    if photo == 3:
        colormap = rng.integers(0, 65536, (3, 1 << (bits or 8)))
    comp = pick((1, 8, 32773, 34925))
    predictor = 1
    if comp in (8, 34925) and not bits:
        predictor = pick((1, 2, 3) if dt.kind == "f" else (1, 2))
    tile = None
    rows = 0
    if rng.random() < 0.4:
        tile = (16 * int(rng.integers(1, 4)), 16 * int(rng.integers(1, 4)))
    elif rng.random() < 0.5:
        rows = int(rng.integers(1, h + 1))
    opts = dict(endian=pick(("<", ">")), tile=tile, rows=rows, compression=comp,
                predictor=predictor, extra=extra, colormap=colormap, bits=bits,
                planar=pick((1, 2)) if spp > 1 else 1, bigtiff=rng.random() < 0.3,
                fill=2 if rng.random() < 0.15 else 1, tags=tags)
    label = f"writer {kind} photometric {photo} {dtype} spp {spp} {w}x{h} " + " ".join(
        f"{k}={v}" for k, v in opts.items() if k not in ("colormap", "tags") and v)
    return label, tiff(samples, photo, **opts)


def jpeg_tiled_tiff(rgb: np.ndarray, tile: int = 16, quality: int = 75) -> bytes:
    """A YCbCr TIFF of JPEG tiles, each a whole JFIF file of Pillow's
    ``save`` (4:2:0), no ``JPEGTables``: libtiff upsamples and converts."""
    from PIL import Image

    h, w = rgb.shape[:2]
    chunks = []
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            part = np.zeros((tile, tile, 3), np.uint8)
            src = rgb[ty: ty + tile, tx: tx + tile]
            part[: src.shape[0], : src.shape[1]] = src
            b = io.BytesIO()
            Image.fromarray(part).save(b, "JPEG", quality=quality)
            chunks.append(b.getvalue())
    return tiff(rgb, 6, tile=(tile, tile), compression=7, raw_chunks=chunks,
                tags={530: (3, (2, 2))})


def _cv2_file(a: np.ndarray, ext: str, params=()) -> bytes:
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x" + ext)
        cv2.imwrite(p, a, list(params))
        with open(p, "rb") as f:
            return f.read()


def make_tiff_fixtures() -> dict[str, bytes]:
    """The TIFF and JPEG 2000 files of the TIFF slice: Pillow's ``save`` at
    the kinds the usual writers make, OpenCV's ``imwrite`` of float32 and
    16-bit arrays, JPEG tiles, the scene's textures, the 640x480 timed
    files, and ``tiff_files.tiff_fixtures()``."""
    import cv2

    from stillleben_tpu_torch.assets.image import decode_hdr, encode_hdr
    from stillleben_tpu_torch.assets.image_fixtures import _few_colours
    from stillleben_tpu_torch.assets.procedural import (base_color_texture, checker_texture,
                                                        sky_equirect)

    files = {}

    def pil(name, mode, px, **kw):
        files[name] = pillow_tiff(px, mode, **kw)

    rgb, grey = smooth(53, 37, 3, 40), smooth(53, 37, 1, 41)[..., 0]
    for mode, px in (("RGB", rgb), ("L", grey), ("YCbCr", rgb), ("CMYK", smooth(53, 37, 4, 42))):
        pil(f"jpeg_{mode.lower()}.tif", mode, px, compression="jpeg")
    bits = tiff_mode_pixels("1", 53, 37, 43)
    pil("g4.tif", "1", bits, compression="group4")
    pil("g3.tif", "1", bits, compression="group3")
    pil("g3_2d_fill2.tif", "1", bits, compression="group3", tiffinfo={292: 1, 266: 2})
    pil("ccitt_rle.tif", "1", bits, compression="tiff_ccitt")
    pil("lzma_rgb.tif", "RGB", rgb, compression="lzma")
    pil("zstd_rgb.tif", "RGB", rgb, compression="zstd")
    cmyk = smooth(53, 37, 4, 44)
    pil("cmyk.tif", "CMYK", cmyk)
    pil("cmyk_lzw.tif", "CMYK", cmyk, compression="tiff_lzw")
    pil("ycbcr.tif", "YCbCr", rgb)
    pil("lab.tif", "LAB", smooth(53, 37, 3, 45))
    pil("mode_f.tif", "F", tiff_mode_pixels("F", 53, 37, 46))
    pil("mode_i.tif", "I", tiff_mode_pixels("I", 53, 37, 47))
    pil("bigtiff_rgb.tif", "RGB", rgb, big_tiff=True)
    files["jpeg_tiles_ycbcr.tif"] = jpeg_tiled_tiff(smooth(53, 37, 3, 48))
    fl = (np.random.default_rng(49).standard_normal((53, 37, 3)) * 40).astype(np.float32)
    files["cv2_float_rgb.tif"] = _cv2_file(fl, ".tif")
    files["cv2_float_rgb_pred3.tif"] = _cv2_file(fl, ".tif", (cv2.IMWRITE_TIFF_COMPRESSION, 5,
                                                               cv2.IMWRITE_TIFF_PREDICTOR, 3))
    files["cv2_float_rgba.tif"] = _cv2_file(np.concatenate([fl, fl[..., :1]], -1), ".tif")
    files["cv2_int32.tif"] = _cv2_file(tiff_mode_pixels("I", 53, 37, 50) * 7919, ".tif")
    # the light map's panorama: the pixels sky.hdr decodes to, float32 RGB
    # (OpenCV writes BGR arrays as RGB files)
    sky = decode_hdr(encode_hdr(sky_equirect(), rle=True))
    files["sky_float.tif"] = _cv2_file(np.ascontiguousarray(sky[..., ::-1]), ".tif", (
        cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 3))
    # the scene: the blob's base colour as Pillow's JPEG, the checker as Group 4
    # at 256^2 (the PNG twin of a 512^2 black and white checker takes the
    # port's slow Paeth unfilter, ROADMAP B, host item 3)
    pil("blob_basecolor_jpeg.tif", "RGB", base_color_texture(), compression="jpeg")
    checker = checker_texture(size=256)[..., 0] > 127
    pil("checker_g4.tif", "1", checker.astype(np.uint8) * 255, compression="group4")
    # the timed 640x480 files: few colours in 8-pixel cells keep them small
    frame = _few_colours(480, 640, 51, n=6, cell=8)
    pil("timed_jpeg.tif", "RGB", frame, compression="jpeg")
    pil("timed_g4.tif", "1", (frame[..., 0] > 127).astype(np.uint8) * 255, compression="group4")
    pil("timed_lzma.tif", "RGB", frame, compression="lzma")
    pil("timed_zstd.tif", "RGB", frame, compression="zstd")
    pil("timed_cmyk_lzw.tif", "CMYK", np.concatenate([frame, frame[..., :1]], -1),
        compression="tiff_lzw")
    # C-26 and C-29: OpenCV's 16-bit JPEG 2000 and the file its failed write leaves
    rng = np.random.default_rng(52)
    for name, c in (("cv2_rgb16.jp2", 3), ("cv2_rgba16.jp2", 4)):
        files[name] = _cv2_file(rng.integers(0, 65536, (53, 37, c)).astype(np.uint16), ".jp2")
    files["cv2_broken.jp2"] = _cv2_file(rng.integers(0, 65536, (31, 29)).astype(np.uint16),
                                        ".jp2")
    files.update(tiff_files.tiff_fixtures())
    return files


def tiff_reading(data: bytes, name: str) -> str:
    """SHA-256 of Pillow's ``convert("RGBA")`` of ``data`` opened as the file
    ``name``, or ``refused:`` and the ``OSError``'s message (the path as
    ``name``), or another exception's type and message."""
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(data)
        try:
            return hashlib.sha256(np.asarray(Image.open(p).convert("RGBA")).tobytes()).hexdigest()
        except OSError as e:  # UnidentifiedImageError too: the port's OSError
            return "refused: " + str(e).replace(p, name)
        except Exception as e:  # noqa: BLE001  (the reading is the exception)
            return f"{type(e).__name__}: {str(e).replace(p, name)}"


def port_tiff_reading(data: bytes, name: str) -> str:
    """``tiff_reading``'s form of the port's ``decode_image``."""
    from stillleben_tpu_torch.assets import image

    try:
        return hashlib.sha256(image.decode_image(data, name).tobytes()).hexdigest()
    except OSError as e:
        return f"refused: {e}"
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        return f"{type(e).__name__}: {e}"


def tiff_cv2_reading(data: bytes, name: str) -> str:
    """``cv2.imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` of ``data`` saved as
    ``name``: its dtype, shape and SHA-256, or ``None``."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(data)
        img = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return "None" if img is None else array_reading(img)


def array_reading(a: np.ndarray) -> str:
    """``dtype shape sha256`` of an array's bytes."""
    a = np.ascontiguousarray(a)
    return f"{a.dtype} {tuple(a.shape)} {hashlib.sha256(a.tobytes()).hexdigest()}"


def tiff_digests(files: dict[str, bytes]) -> dict:
    """``TIFF_FILE`` / ``TIFF_DECODE`` / ``TIFF_DECODE_CV2``: each file's
    SHA-256 and Pillow's and OpenCV's readings."""
    return {"TIFF_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "TIFF_DECODE": {n: tiff_reading(d, n) for n, d in sorted(files.items())},
            "TIFF_DECODE_CV2": {n: tiff_cv2_reading(d, n) for n, d in sorted(files.items())}}


def write_tiff_fixtures() -> None:
    """``--tiff``: writes ``make_tiff_fixtures()``'s files and their three
    tables into ``digests.py``, every other table as it stands."""
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    files = make_tiff_fixtures()
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    tables = {k: dict(v) for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    tables.update(tiff_digests(files))
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))
    print({k: len(v) for k, v in files.items()}, sum(map(len, files.values())))


def tiff_sweep_one(i: int, directory: str) -> str:
    """Case ``i`` through Pillow, OpenCV and the port: "" where
    ``read_image`` equals ``Image.open(p).convert("RGBA")`` (or raises an
    exception of Pillow's class) and ``read_image_cv2`` equals
    ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` (dtype, shape and
    values, or None); else what differed."""
    import cv2
    from PIL import Image

    from stillleben_tpu_torch.assets import image

    label, data = tiff_sweep_case(i)
    if not data:
        return ""  # libtiff's encoder refused the settings
    path = os.path.join(directory, f"sweep{i}.tif")
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = np.asarray(Image.open(path).convert("RGBA"))
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        ref = type(e)
    try:
        got = image.read_image(path)
    except Exception as e:  # noqa: BLE001
        got = type(e)
    diffs = []
    if isinstance(ref, type) or isinstance(got, type):
        if not (isinstance(ref, type) and isinstance(got, type) and issubclass(
                got, OSError if issubclass(ref, OSError) else ref)):
            diffs.append(f"Pillow {ref if isinstance(ref, type) else 'reads'}, the port "
                         f"{got if isinstance(got, type) else 'reads'}")
    elif not np.array_equal(ref, got):
        diffs.append("Pillow's pixels differ")
    want = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    try:
        have = image.read_image_cv2(path)
    except Exception as e:  # noqa: BLE001
        have = type(e)
    if isinstance(have, type) or (want is None) != (have is None):
        diffs.append(f"OpenCV {'None' if want is None else 'reads'}, the port "
                     f"{have if isinstance(have, type) or have is None else 'reads'}")
    elif want is not None and not (want.dtype == have.dtype and want.shape == have.shape
                                   and np.array_equal(want, have, equal_nan=True)):
        diffs.append(f"OpenCV's array differs ({want.dtype}{want.shape} against "
                     f"{have.dtype}{have.shape})")
    os.remove(path)
    return f"{label}: {'; '.join(diffs)}" if diffs else ""


def tiff_sweep(n: int, start: int = 0) -> list[str]:
    """``--tiff-sweep N [START]``: cases START .. START + N - 1 of
    ``tiff_sweep_case`` held to Pillow's and OpenCV's readings; prints and
    returns what differed."""
    import tempfile

    bad = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(start, start + n):
            diff = tiff_sweep_one(i, d)
            if diff:
                bad.append(f"case {i}: {diff}")
                print(bad[-1], flush=True)
    print(f"{n} cases from {start}: {n - len(bad)} read as Pillow and OpenCV read them")
    return bad


# ---------------------------------------------------------------------------
# WebP
# ---------------------------------------------------------------------------


def webp_save(pixels: np.ndarray, **kw) -> bytes:
    """Pillow's WebP ``save`` of uint8 (H, W, 3|4) with its options."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels)).save(b, "WEBP", **kw)
    return b.getvalue()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def webp_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The top-level chunks of a RIFF/WEBP file: (fourcc, payload)."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8: pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def webp_anim(canvas: tuple[int, int], frames: list[tuple[int, int, bytes]], *,
              alpha: bool = True, background: int = 0) -> bytes:
    """An animated WebP (VP8X, ANIM, one ANMF per frame) of ``canvas`` (W, H):
    each frame is (x, y, a still WebP file), its ALPH / VP8 / VP8L chunks
    placed at the even offset (x, y); Pillow's encoder always writes frame 0
    at the canvas's size, this writer need not."""
    body = b""
    for x, y, still in frames:
        chunks = webp_chunks(still)
        kinds = [k for k, _ in chunks]
        if b"VP8X" in kinds:
            p = dict(chunks)[b"VP8X"]
            fw, fh = (struct.unpack("<I", p[4:7] + b"\0")[0] + 1,
                      struct.unpack("<I", p[7:10] + b"\0")[0] + 1)
        elif b"VP8 " in kinds:
            p = dict(chunks)[b"VP8 "]
            fw, fh = struct.unpack_from("<HH", p, 6)
            fw, fh = fw & 0x3FFF, fh & 0x3FFF
        else:
            v = struct.unpack_from("<I", dict(chunks)[b"VP8L"], 1)[0]
            fw, fh = (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
        payload = b"".join(_chunk(k, p) for k, p in chunks if k in (b"ALPH", b"VP8 ", b"VP8L"))
        head = b"".join(struct.pack("<I", v)[:3] for v in (x // 2, y // 2, fw - 1, fh - 1, 100))
        body += _chunk(b"ANMF", head + bytes([0]) + payload)
    flags = 0x02 | (0x10 if alpha else 0)
    vp8x = _chunk(b"VP8X", bytes([flags, 0, 0, 0]) + struct.pack("<I", canvas[0] - 1)[:3]
                  + struct.pack("<I", canvas[1] - 1)[:3])
    data = b"WEBP" + vp8x + _chunk(b"ANIM", struct.pack("<IH", background, 0)) + body
    return b"RIFF" + struct.pack("<I", len(data)) + data


def webp_frame() -> np.ndarray:
    """The 640x480 frame the WebP decode is timed on: the 8-bit sky over the
    bench's blob texture, tiled (content a lossless file stays small on)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.procedural import base_color_texture, sky_ldr

    frame = sky_ldr(480, 640).copy()
    frame[240:] = np.tile(base_color_texture(0)[..., :3], (1, 3, 1))[:240, :640]
    return frame


def _libwebp():
    """libwebp as Pillow ships it (its ``_webp`` extension loads it and the
    libraries it needs first), with the encoder's structures: the options
    ``Image.save`` does not pass (the simple loop filter, sharpness, token
    partitions, segments, raw or unfiltered alpha) reach the decoder's
    paths that Pillow's files never take."""
    import ctypes
    import glob

    import PIL
    from PIL import _webp  # noqa: F401

    c_int, c_float, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class Config(ctypes.Structure):  # WebPConfig (encode.h), room to spare after it
        _fields_ = [("lossless", c_int), ("quality", c_float), ("method", c_int),
                    ("image_hint", c_int), ("target_size", c_int), ("target_PSNR", c_float)] + [
            (n, c_int) for n in (
                "segments", "sns_strength", "filter_strength", "filter_sharpness",
                "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                "alpha_quality", "pass", "show_compressed", "preprocessing", "partitions",
                "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
                "qmax")] + [("_spare", c_int * 16)]

    class Picture(ctypes.Structure):  # WebPPicture (encode.h)
        _fields_ = [("use_argb", c_int), ("colorspace", c_int), ("width", c_int),
                    ("height", c_int), ("y", ptr), ("u", ptr), ("v", ptr), ("y_stride", c_int),
                    ("uv_stride", c_int), ("a", ptr), ("a_stride", c_int),
                    ("pad1", ctypes.c_uint32 * 2), ("argb", ptr), ("argb_stride", c_int),
                    ("pad2", ctypes.c_uint32 * 3), ("writer", ptr), ("custom_ptr", ptr),
                    ("extra_info_type", c_int), ("extra_info", ptr), ("stats", ptr),
                    ("error_code", c_int), ("progress_hook", ptr), ("user_data", ptr),
                    ("pad3", ctypes.c_uint32 * 3), ("pad4", ptr), ("pad5", ptr),
                    ("pad6", ctypes.c_uint32 * 8), ("memory_", ptr), ("memory_argb_", ptr),
                    ("pad7", ptr * 2), ("_spare", ctypes.c_uint8 * 256)]

    class Writer(ctypes.Structure):  # WebPMemoryWriter
        _fields_ = [("mem", ptr), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32 * 4)]

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    return ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0]), Config, Picture, Writer


def libwebp_encode(pixels: np.ndarray, quality: float = 75.0, **config) -> bytes:
    """libwebp's ``WebPEncode`` of uint8 (H, W, 3|4) with the default preset,
    ``quality`` and the given ``WebPConfig`` fields (e.g. ``filter_type=0``
    for the simple loop filter, ``partitions=3`` for 8 token partitions,
    ``alpha_compression=0`` for raw alpha)."""
    import ctypes

    lib, Config, Picture, Writer = _libwebp()
    abi = 0x0209  # the encoder's ABI major version 2
    cfg = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(quality), abi):
        raise RuntimeError("WebPConfigInit")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the configuration {config}")
    pic = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
        raise RuntimeError("WebPPictureInit")
    pix = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pix.shape
    pic.width, pic.height, pic.use_argb = w, h, int(cfg.lossless)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not imp(ctypes.byref(pic), pix.ctypes.data_as(ctypes.c_void_p), w * c):
            raise RuntimeError("WebPPictureImport")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        pic.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode: error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def libwebp_planes(pixels: np.ndarray, cleanup: bool) -> dict:
    """libwebp's own YUV 4:2:0 planes of uint8 (H, W, 3|4):
    ``WebPPictureImportRGB(A)`` into a YUV picture, then with ``cleanup``
    ``WebPCleanupTransparentArea`` (which ``WebPEncode`` calls when
    ``exact`` is 0). Keys y, u, v, and a (None without transparency)."""
    import ctypes

    lib, _, Picture, _ = _libwebp()
    pic = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), 0x0209):
        raise RuntimeError("WebPPictureInit")
    pix = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pix.shape
    pic.width, pic.height, pic.use_argb = w, h, 0
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    try:
        if not imp(ctypes.byref(pic), pix.ctypes.data_as(ctypes.c_void_p), w * c):
            raise RuntimeError("WebPPictureImport")
        if cleanup:
            lib.WebPCleanupTransparentArea(ctypes.byref(pic))

        def plane(ptr, stride, ph, pw):
            rows = ctypes.string_at(ptr, stride * (ph - 1) + pw)
            return np.array([np.frombuffer(rows, np.uint8, pw, stride * r) for r in range(ph)])

        uh, uw = (h + 1) // 2, (w + 1) // 2
        return {"y": plane(pic.y, pic.y_stride, h, w), "u": plane(pic.u, pic.uv_stride, uh, uw),
                "v": plane(pic.v, pic.uv_stride, uh, uw),
                "a": plane(pic.a, pic.a_stride, h, w) if pic.a else None}
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))


# The divergence finder: VP8's partition 0 (RFC 6386 9.2-9.11, 19.2-19.3),
# parsed to name the first stage at which two lossy files part.

def _vp8_tables():
    import re

    src = open(os.path.join(ROOT, "stillleben_tpu_torch", "csrc", "sl_vp8_tables.h")).read()

    def tab(name, shape):
        body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return np.array([int(x) for x in re.findall(r"\d+", body)]).reshape(shape)

    return (tab("kCoeffsUpdateProba", (4, 8, 3, 11)), tab("kCoeffsProba0", (4, 8, 3, 11)),
            tab("kBModesProba", (10, 10, 9)))


class _BoolReader:
    def __init__(self, buf: bytes):
        self.buf, self.pos, self.count, self.range = buf, 2, 0, 255
        self.value = (buf[0] << 8 | buf[1]) if len(buf) > 1 else 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, self.value - (split << 8)
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.buf[self.pos] if self.pos < len(self.buf) else 0
                self.pos += 1
        return bit

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get(128)
        return v

    def signed(self, n: int) -> int:
        if not self.get(128):
            return 0
        v = self.lit(n)
        return -v if self.get(128) else v


def vp8_partition0(data: bytes) -> dict:
    """The headers and the per-macroblock modes of a lossy WebP's partition 0:
    the segment header (quantiser and filter level per segment, map
    probabilities), the filter header, the quantiser indices, the token
    probability updates, the skip probability, and per macroblock its
    segment, skip flag, intra-16 mode or sixteen intra-4 modes, and chroma
    mode (libwebp's numbering: DC 0, TM 1, VE 2, HE 3)."""
    upd, _, bmodes = _vp8_tables()
    vp8 = dict(webp_chunks(data))[b"VP8 "]
    bits = vp8[0] | vp8[1] << 8 | vp8[2] << 16
    w, h = struct.unpack_from("<HH", vp8, 6)
    br = _BoolReader(vp8[10: 10 + (bits >> 5)])
    info = {"profile": (bits >> 1) & 7, "size0": bits >> 5, "w": w & 0x3fff, "h": h & 0x3fff}
    info["colorspace"], info["clamp"] = br.get(128), br.get(128)
    seg = {"enabled": br.get(128)}
    if seg["enabled"]:
        seg["update_map"] = br.get(128)
        if br.get(128):
            seg["absolute"] = br.get(128)
            seg["quant"] = [br.signed(7) for _ in range(4)]
            seg["filter"] = [br.signed(6) for _ in range(4)]
        seg["probs"] = ([br.lit(8) if br.get(128) else 255 for _ in range(3)]
                        if seg["update_map"] else [255] * 3)
    info["segments"] = seg
    info["filter"] = {"simple": br.get(128), "level": br.lit(6), "sharpness": br.lit(3)}
    if br.get(128) and br.get(128):
        info["filter"]["deltas"] = [br.signed(6) for _ in range(8)]
    info["partitions"] = 1 << br.lit(2)
    info["quant"] = [br.lit(7)] + [br.signed(4) for _ in range(5)]
    info["refresh"] = br.get(128)
    info["proba_updates"] = [(t, b, c, p, br.lit(8)) for t in range(4) for b in range(8)
                             for c in range(3) for p in range(11) if br.get(int(upd[t, b, c, p]))]
    info["skip_proba"] = br.lit(8) if br.get(128) else None
    mbw, mbh = (info["w"] + 15) // 16, (info["h"] + 15) // 16
    top, mbs = [0] * (4 * mbw), []
    for _ in range(mbh):
        left = [0] * 4
        for x in range(mbw):
            mb = {}
            if seg["enabled"] and seg["update_map"]:
                pr = seg["probs"]
                mb["segment"] = (2 + br.get(pr[2])) if br.get(pr[0]) else br.get(pr[1])
            if info["skip_proba"] is not None:
                mb["skip"] = br.get(info["skip_proba"])
            if br.get(145):
                m = (1 if br.get(128) else 3) if br.get(156) else (2 if br.get(163) else 0)
                mb["i16"] = m
                top[4 * x: 4 * x + 4], left = [m] * 4, [m] * 4
            else:
                modes = []
                for j in range(4):
                    for i in range(4):
                        p = bmodes[top[4 * x + i], left[j]]
                        path = [(0, 0), (1, 1), (2, 2)]
                        m = None
                        for k, mode in path:
                            if not br.get(int(p[k])):
                                m = mode
                                break
                        if m is None:
                            if not br.get(int(p[3])):
                                m = 3 if not br.get(int(p[4])) else (4 if not br.get(int(p[5])) else 5)
                            elif not br.get(int(p[6])):
                                m = 6
                            elif not br.get(int(p[7])):
                                m = 7
                            else:
                                m = 8 if not br.get(int(p[8])) else 9
                        modes.append(m)
                        top[4 * x + i], left[j] = m, m
                mb["i4"] = modes
            if not br.get(142):
                mb["uv"] = 0
            elif not br.get(114):
                mb["uv"] = 2
            else:
                mb["uv"] = 3 if not br.get(183) else 1
            mbs.append(mb)
    info["macroblocks"] = mbs
    return info


def vp8_divergence(ours: bytes, ref: bytes) -> str | None:
    """Where two lossy WebP files first part, stage by stage: the container,
    then partition 0 (headers, segments and quantisers, filter, token
    probabilities, each macroblock's segment and modes), then the token
    partition. None if they are equal."""
    if ours == ref:
        return None
    a, b = dict(webp_chunks(ours)), dict(webp_chunks(ref))
    for kind in (b"VP8X", b"ALPH"):
        if (kind in a) != (kind in b):
            return f"chunk {kind!r} in one file only"
    pa, pb = vp8_partition0(ours), vp8_partition0(ref)
    for key in ("profile", "w", "h", "segments", "filter", "partitions", "quant",
                "proba_updates", "skip_proba"):
        if pa[key] != pb[key]:
            return f"partition 0, {key}: {pa[key]} vs libwebp's {pb[key]}"
    mbw = (pa["w"] + 15) // 16
    for i, (ma, mb) in enumerate(zip(pa["macroblocks"], pb["macroblocks"])):
        if ma != mb:
            return f"partition 0, macroblock ({i % mbw}, {i // mbw}): {ma} vs libwebp's {mb}"
    if a[b"VP8 "] != b[b"VP8 "]:
        return "the token partition"
    return "the container (the VP8 chunk is equal)"


def vp8l_transforms(stream: bytes) -> list[str]:
    """The transforms at the head of a VP8L image stream (an ALPH payload
    after its header byte): 'predictor (bits b)', 'cross-colour (bits b)',
    'subtract-green', 'palette (n colours)'; reading stops at the first
    transform with data."""
    pos, out = 0, []

    def bits(n):
        nonlocal pos
        v = 0
        for i in range(n):
            byte = stream[pos >> 3] if (pos >> 3) < len(stream) else 0
            v |= ((byte >> (pos & 7)) & 1) << i
            pos += 1
        return v

    while bits(1):
        kind = bits(2)
        if kind in (0, 1):
            out.append(f"{('predictor', 'cross-colour')[kind]} (bits {bits(3) + 2})")
            break
        if kind == 3:
            out.append(f"palette ({bits(8) + 1} colours)")
            break
        out.append("subtract-green")
    return out


# The divergence finder of the ALPH chunk's VP8L stream (the WebP lossless
# format, RFC 9649), parsed to name the first part at which two streams
# part, and libwebp's own stream of a plane as the oracle.


class _LBits:
    """LSB-first bit reader; past the end it reads zeros."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p, self.pos = self.pos, self.pos + n
        window = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little")
        return (window >> (p & 7)) & ((1 << n) - 1)


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _code_to_plane():
    import re

    with open(os.path.join(ROOT, "stillleben_tpu_torch", "csrc", "sl_webp.cpp")) as f:
        src = f.read()
    body = re.search(r"kCodeToPlane\[120\]\s*=\s*\{(.*?)\};", src, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)]


class _Prefix:
    """One prefix code from its lengths: a single used symbol reads no bits."""

    def __init__(self, lengths: list[int]):
        used = [i for i, n in enumerate(lengths) if n]
        self.single = used[0] if len(used) == 1 else (0 if not used else None)
        self.table, code = {}, 0
        for n in range(1, 16):  # canonical codes, shortest first
            for sym in (i for i, m in enumerate(lengths) if m == n):
                self.table[(n, code)] = sym
                code += 1
            code <<= 1

    def decode(self, br: _LBits) -> int:
        if self.single is not None:
            return self.single
        code = 0
        for n in range(1, 16):
            code = (code << 1) | br.read(1)
            if (n, code) in self.table:
                return self.table[(n, code)]
        raise ValueError("not a prefix code")


def _read_prefix_code(br: _LBits, alphabet: int) -> list[int]:
    lengths = [0] * alphabet
    if br.read(1):  # the simple code: one or two symbols
        num = br.read(1) + 1
        lengths[br.read(1 + 7 * br.read(1))] = 1
        if num == 2:
            lengths[br.read(8)] = 1
        return lengths
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CL_ORDER[i]] = br.read(3)
    max_symbol = 2 + br.read(2 + 2 * br.read(3)) if br.read(1) else alphabet
    code, prev, i = _Prefix(cl), 8, 0
    while i < alphabet and max_symbol > 0:
        max_symbol -= 1
        c = code.decode(br)
        if c < 16:
            lengths[i], i = c, i + 1
            prev = c or prev
        else:
            extra, offset = {16: (2, 3), 17: (3, 3), 18: (7, 11)}[c]
            for _ in range(br.read(extra) + offset):
                lengths[i], i = (prev if c == 16 else 0), i + 1
    return lengths


def _prefix_value(code: int, br: _LBits) -> int:
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + br.read(extra) + 1


def _vp8l_image(br: _LBits, w: int, h: int, level0: bool, planes: list[int]) -> dict:
    """One entropy-coded image: its colour-cache bits, meta prefix image
    (bits and pixels, level 0 only), code lengths per group, tokens
    (literal ARGB, cache index, or copy of length and distance code) and
    pixels."""
    cache_bits = br.read(4) if br.read(1) else 0
    meta_bits, meta, num_groups = None, None, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        sub = _vp8l_image(br, -(-w >> meta_bits), -(-h >> meta_bits), False, planes)["pixels"]
        meta = [(p >> 8) & 0xffff for p in sub]
        num_groups = max(meta) + 1
    alphabets = (256 + 24 + ((1 << cache_bits) if cache_bits else 0), 256, 256, 256, 40)
    groups = [[_read_prefix_code(br, a) for a in alphabets] for _ in range(num_groups)]
    codes = [[_Prefix(lengths) for lengths in g] for g in groups]
    cache = [0] * (1 << cache_bits) if cache_bits else None
    pixels, tokens, pos, mw = [0] * (w * h), [], 0, -(-w >> meta_bits) if meta_bits else 1

    def put(argb):
        nonlocal pos
        pixels[pos] = argb
        if cache is not None:
            cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)] = argb
        pos += 1

    while pos < w * h:
        g = codes[meta[((pos // w) >> meta_bits) * mw + ((pos % w) >> meta_bits)]] if meta else codes[0]
        s = g[0].decode(br)
        if s < 256:
            r, b, a = g[1].decode(br), g[2].decode(br), g[3].decode(br)
            argb = (a << 24) | (r << 16) | (s << 8) | b
            tokens.append(("literal", argb))
            put(argb)
        elif s < 280:
            length = _prefix_value(s - 256, br)
            dist_code = _prefix_value(g[4].decode(br), br)
            tokens.append(("copy", length, dist_code))
            if dist_code > 120:
                dist = dist_code - 120
            else:
                dc = planes[dist_code - 1]
                dist = max(1, (dc >> 4) * w + 8 - (dc & 0xF))
            for _ in range(min(length, w * h - pos)):
                put(pixels[pos - dist] if pos >= dist else 0)
        else:
            tokens.append(("cache", s - 280))
            put(cache[s - 280])
    return {"cache_bits": cache_bits, "meta": (meta_bits, meta), "code_lengths": groups,
            "tokens": tokens, "pixels": pixels}


def vp8l_parse(stream: bytes, width: int, height: int) -> dict:
    """A VP8L image stream without its header (an ALPH payload after its
    header byte) of a ``width`` x ``height`` image: its transforms in order,
    each with its data as an entropy-coded image (``_vp8l_image``), and
    the main image."""
    br, planes, xsize, transforms = _LBits(stream), _code_to_plane(), width, []
    while br.read(1):
        kind = br.read(2)
        if kind in (0, 1):
            bits = br.read(3) + 2
            data = _vp8l_image(br, -(-xsize >> bits), -(-height >> bits), False, planes)
            transforms.append((("predictor", "cross-colour")[kind], bits, data))
        elif kind == 2:
            transforms.append(("subtract-green", None, None))
        else:
            n = br.read(8) + 1
            transforms.append(("palette", n, _vp8l_image(br, n, 1, False, planes)))
            xbits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            xsize = -(-xsize >> xbits)
    return {"transforms": transforms, "main": _vp8l_image(br, xsize, height, True, planes)}


def _vp8l_parts(stream: bytes, width: int, height: int) -> list[tuple[str, object]]:
    names = ("green/length/cache", "red", "blue", "alpha", "distance")

    def image(label, img):
        out = [(f"{label}: colour-cache bits", img["cache_bits"]),
               (f"{label}: meta prefix image (bits, groups)", img["meta"])]
        for g, lengths in enumerate(img["code_lengths"]):
            out += [(f"{label}: code lengths of group {g}, {names[k]}", lengths[k]) for k in range(5)]
        return out + [(f"{label}: tokens", img["tokens"])]

    parsed, parts = vp8l_parse(stream, width, height), []
    parts.append(("transforms", [(t[0], t[1]) for t in parsed["transforms"]]))
    for i, (kind, arg, data) in enumerate(parsed["transforms"]):
        if data is not None:
            parts += image(f"transform {i} ({kind}) data", data)
    return parts + image("the main image", parsed["main"])


def vp8l_divergence(ours: bytes, ref: bytes, width: int, height: int) -> str | None:
    """Where two VP8L streams of a ``width`` x ``height`` image (ALPH
    payloads after their header byte) first part: the transforms and their
    data, the colour-cache bits, the meta prefix image, the code lengths
    group by group, then the index of the first token that differs. None
    if they are equal."""
    if ours == ref:
        return None
    try:
        pa, pb = _vp8l_parts(ours, width, height), _vp8l_parts(ref, width, height)
    except (ValueError, IndexError, KeyError) as e:
        return f"a stream does not parse ({e!r})"
    for (la, va), (lb, vb) in zip(pa, pb):
        if la != lb:
            return f"the layout: {la} vs libwebp's {lb}"
        if va == vb:
            continue
        if la.endswith("tokens"):
            i = next((k for k, (x, y) in enumerate(zip(va, vb)) if x != y), min(len(va), len(vb)))
            return (f"{la}: token {i} of {len(va)} / {len(vb)}: "
                    f"{va[i] if i < len(va) else None} vs libwebp's {vb[i] if i < len(vb) else None}")
        return f"{la}: {va} vs libwebp's {vb}"
    if len(pa) != len(pb):
        return f"the layout: {len(pa)} parts vs libwebp's {len(pb)}"
    return "the bits after the last token"


def alph_divergence(ours: bytes, ref: bytes) -> str | None:
    """Where two WebP files' ALPH chunks first part: the header byte
    (compression, filter), the raw plane, or the VP8L stream
    (``vp8l_divergence``, the sides from VP8X). None if they are equal."""
    a, b = dict(webp_chunks(ours)), dict(webp_chunks(ref))
    ca, cb = a.get(b"ALPH"), b.get(b"ALPH")
    if ca == cb:
        return None
    if ca is None or cb is None:
        return "ALPH in one file only"
    if ca[0] != cb[0]:
        return f"ALPH header byte {ca[0]:#04x} vs libwebp's {cb[0]:#04x}"
    if ca[0] & 3 == 0:
        return "the raw plane"
    vp8x = a[b"VP8X"]
    w = 1 + int.from_bytes(vp8x[4:7], "little")
    h = 1 + int.from_bytes(vp8x[7:10], "little")
    return "ALPH " + vp8l_divergence(ca[1:], cb[1:], w, h)


def alpha_filter(plane: np.ndarray, kind: int) -> np.ndarray:
    """An (H, W) uint8 plane under libwebp's alpha filter ``kind`` (0 none,
    1 horizontal, 2 vertical, 3 gradient): row 0 predicted from the left,
    column 0 from above, the first sample from 0."""
    a = plane.astype(np.int32)
    if kind == 0:
        return plane.astype(np.uint8).copy()
    pred = np.zeros_like(a)
    pred[0, 1:], pred[1:, 0] = a[0, :-1], a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def libwebp_alpha_stream(plane: np.ndarray) -> bytes:
    """libwebp's VP8L stream of an (H, W) uint8 plane as its alpha encoder
    writes it (alpha_enc.c's EncodeLossless: the plane in green, alpha, red
    and blue 0; method 4, quality 32, exact): ``WebPEncode`` of that ARGB
    image, lossless, whose VP8L chunk after its 5-byte header (signature,
    sides, alpha bit, version) is that stream."""
    h, w = plane.shape
    argb = np.zeros((h, w, 4), np.uint8)
    argb[..., 1] = plane
    data = libwebp_encode(argb, quality=32.0, lossless=1, method=4, exact=1)
    chunk = dict(webp_chunks(data))[b"VP8L"]
    assert chunk[0] == 0x2F, chunk[:5]
    return chunk[5:]


def alph_report(cases: dict[str, np.ndarray]) -> list[str]:
    """For each RGBA array: the port's ALPH chunk against the one Pillow's
    ``save`` writes (libwebp), as one line: header bytes, sizes, whether
    bitwise equal (else where they part), each stream's transforms, and
    whether the port's VP8L stream of the plane under the chosen filter
    equals libwebp's own (``libwebp_alpha_stream``, the oracle)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import native_image
    from stillleben_tpu_torch.assets.webp import encode_webp

    lines = []
    for name, a in cases.items():
        ours_file, ref_file = encode_webp(a), webp_save(a)
        ours, ref = dict(webp_chunks(ours_file))[b"ALPH"], dict(webp_chunks(ref_file))[b"ALPH"]
        tf = [vp8l_transforms(c[1:]) if c[0] & 3 else ["raw"] for c in (ours, ref)]
        plane = alpha_filter(a[..., 3], (ref[0] >> 2) & 3)
        oracle = native_image.vp8l_encode_plane(plane) == libwebp_alpha_stream(plane)
        lines.append(f"{name}: header {ours[0]:#04x} / libwebp {ref[0]:#04x}; {len(ours)} / "
                     f"{len(ref)} bytes; "
                     + ("bitwise equal" if ours == ref else alph_divergence(ours_file, ref_file))
                     + f"; transforms {tf[0]} / libwebp {tf[1]}; the plane's VP8L stream equal to "
                       f"libwebp's {oracle}")
    return lines


def alph_cases() -> dict[str, np.ndarray]:
    """The RGBA arrays ``--alph`` reports on: alpha.webp's source, the
    image-parity test's ``rgba``, and the encode tests' three alphas over
    the 67x91 and 640x480 frames."""
    rgb = smooth(67, 91, 3, 1)
    cases = {"alpha.webp": np.concatenate([rgb, smooth(67, 91, 1, 2)], -1),
             "parity rgba 31x45": smooth(31, 45, 4, 2)}
    frame = webp_frame()
    for (h, w), pix in (((67, 91), rgb), ((480, 640), frame)):
        yy, xx = np.mgrid[0:h, 0:w]
        disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 2.5) ** 2 + 1
        for kind, a in (("ramp", smooth(h, w, 1, 5 + h + w)[..., 0]),
                        ("mask", disc.astype(np.uint8) * 255), ("transparent", np.zeros((h, w), np.uint8))):
            cases[f"{kind} {h}x{w}"] = np.concatenate([pix, a[..., None]], -1)
    return cases


def alpha_webp_sources() -> dict[str, np.ndarray]:
    """The RGBA arrays behind the ALPH fixtures (``image_fixtures.
    ALPHA_WEBP_FILES`` beside alpha.webp), by file name, each 64x48 over one
    smooth RGB: a disc mask of 2 levels (a palette of 2 colours, 8 indices a
    pixel), a smooth alpha in 12 levels (2 indices a pixel), noise (libwebp
    stores the plane raw) and a horizontal ramp with smooth ripples (the
    horizontal filter)."""
    rgb = smooth(48, 64, 3, 17)
    yy, xx = np.mgrid[0:48, 0:64]
    alphas = {
        "alpha_mask.webp": ((yy - 24) ** 2 + (xx - 28) ** 2 < 18 ** 2).astype(np.uint8) * 255,
        "alpha_levels.webp": (smooth(48, 64, 1, 18)[..., 0] // 22 * 23).astype(np.uint8),
        "alpha_noise.webp": np.random.default_rng(19).integers(0, 256, (48, 64)).astype(np.uint8),
        "alpha_hfilter.webp": np.clip(xx * 4 + smooth(48, 64, 1, 20)[..., 0] // 16, 0, 255).astype(np.uint8),
    }
    return {n: np.concatenate([rgb, a[..., None]], -1) for n, a in alphas.items()}


def alpha_webp_digests(files: dict[str, bytes]) -> dict:
    """The SHA-256 of the RGBA WebP fixtures' bytes (alpha.webp and the ALPH
    fixtures): a host that re-encodes their sources to these digests writes
    Pillow's files."""
    names = ("alpha.webp",) + tuple(alpha_webp_sources())
    return {"ALPHA_WEBP_FILE": {n: hashlib.sha256(files[n]).hexdigest() for n in names}}


def make_webp_fixtures() -> dict[str, bytes]:
    """The WebP fixtures, each written by Pillow's encoder (the animation's
    container by ``webp_anim`` around Pillow's frames)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.procedural import base_color_texture, checker_texture, sky_ldr

    rgb = smooth(67, 91, 3, 1)
    rgba = np.concatenate([rgb, smooth(67, 91, 1, 2)], -1)
    rng = np.random.default_rng(16)
    pal = rng.integers(0, 256, (16, 4)).astype(np.uint8)
    yy, xx = np.mgrid[0:40, 0:52]
    pal16 = pal[(xx // 5 + 3 * (yy // 4)) % 16]
    frame0 = webp_save(smooth(22, 30, 3, 3), quality=80)
    frame1 = webp_save(smooth(40, 48, 3, 4), quality=80)
    return {
        "q80.webp": webp_save(rgb, quality=80),
        "alpha.webp": webp_save(rgba, quality=80),
        "lossless.webp": webp_save(rgba, lossless=True),
        "palette16.webp": webp_save(pal16, lossless=True),
        "odd.webp": webp_save(smooth(33, 45, 3, 5), quality=50),
        "anim.webp": webp_anim((48, 40), [(6, 8, frame0), (0, 0, frame1)]),
        "frame.webp": webp_save(webp_frame(), quality=80),
        "frame_lossless.webp": webp_save(webp_frame(), lossless=True),
        "blob_basecolor.webp": webp_save(base_color_texture(0)[..., :3], quality=80),
        "checker.webp": webp_save(checker_texture()[..., :3], lossless=True),
        "sky.webp": webp_save(sky_ldr(), quality=80),
        **{n: webp_save(a, quality=80) for n, a in alpha_webp_sources().items()},
    }


def pillow_save(pixels: np.ndarray, ext: str) -> bytes:
    """The bytes the JAX ``ImageSaver`` writes for ``pixels`` to a path
    ending in ``ext``: ``Image.fromarray`` (L, RGB, RGBA or I;16) saved in
    the format Pillow registers for the extension."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(np.asarray(pixels)).save(b, Image.registered_extensions()[ext])
    return b.getvalue()


def make_encode_fixtures() -> dict[str, bytes]:
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import encode_sources

    return {n: pillow_save(a, os.path.splitext(n)[1]) for n, a in encode_sources().items()}


def encode_digests(files: dict[str, bytes]) -> dict:
    return {"ENCODE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())}}


def gif_parts(data: bytes) -> dict:
    """A single-image GIF's parts: header (signature, screen, flags),
    palette (the global table), transparency (the graphic control
    extension's index or None), descriptor, code size, lzw (the sub-blocks
    as stored, without the terminating empty block), index (the decoded
    indices in row order) and trailer."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import gif, native_image

    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 128 else 0)
    parts = {"header": data[:13], "palette": data[13:pos], "transparency": None}
    while data[pos] == 0x21:
        body, end = gif._blocks(data, pos + 2)
        if data[pos + 1] == 0xF9 and body[0] & 1:
            parts["transparency"] = body[3]
        pos = end
    parts["descriptor"] = data[pos: pos + 10]
    w, h, iflags = struct.unpack_from("<HHB", data, pos + 5)
    parts["code size"] = data[pos + 10]
    start = pos + 11
    lzw, end = gif._blocks(data, start)
    parts["lzw"] = data[start:end - 1]  # the sub-blocks, without their terminator
    index = native_image.gif_lzw(lzw, data[pos + 10], w * h).reshape(h, w)
    if iflags & 64:
        index = index[np.argsort(gif._interlaced_rows(h), kind="stable")]
    parts["index"] = index
    parts["trailer"] = data[end:]
    return parts


def gif_divergence(ours: bytes, ref: bytes) -> str | None:
    """None when the two GIF files are equal, else the first stage at which
    they part: the header, the palette, the transparent index, the image
    descriptor, the index image, the LZW stream, the trailer."""
    if ours == ref:
        return None
    a, b = gif_parts(ours), gif_parts(ref)
    for key in ("header", "palette", "transparency", "descriptor", "code size", "index", "lzw",
                "trailer"):
        x, y = a[key], b[key]
        same = np.array_equal(x, y) if key == "index" else x == y
        if not same:
            if key == "index" and x.shape == y.shape:
                return f"index image ({int((x != y).sum())} of {x.size} pixels differ)"
            return key
    return "bytes outside the parts"


def cv2_bgr_sha(data: bytes) -> str:
    """SHA-256 of ``cv2.imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``'s bytes."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.webp")
        with open(p, "wb") as f:
            f.write(data)
        img = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def webp_digests(files: dict[str, bytes]) -> dict:
    return {"WEBP_DECODE": {n: pillow_rgba_sha(d) for n, d in sorted(files.items())},
            "WEBP_DECODE_CV2": {n: cv2_bgr_sha(d) for n, d in sorted(files.items())}}


# ---------------------------------------------------------------------------
# QOI, SGI, PCX, DCX, IM, DDS
# ---------------------------------------------------------------------------


def _sgi_rle_row(vals: np.ndarray, bpc: int) -> bytes:
    """One channel's row as SGI runs: repeats of 3 or more as runs, the rest
    as copies, at most 127 samples an opcode, then the terminator."""
    out, n, x = bytearray(), len(vals), 0
    op = (lambda c: bytes([0, c])) if bpc == 2 else (lambda c: bytes([c]))
    sample = (lambda v: int(v).to_bytes(2, "big")) if bpc == 2 else (lambda v: bytes([int(v)]))
    while x < n:
        run = 1
        while x + run < n and run < 127 and vals[x + run] == vals[x]:
            run += 1
        if run >= 3:
            out += op(run) + sample(vals[x])
            x += run
            continue
        start = x
        while x < n and x - start < 127 and not (x + 2 < n and vals[x] == vals[x + 1] == vals[x + 2]):
            x += 1
        out += op(0x80 | (x - start)) + b"".join(sample(v) for v in vals[start:x])
    return bytes(out + op(0))


def sgi_file(planes: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int = 0,
             name: bytes = b"") -> bytes:
    """An SGI file of (z, h, w) samples (uint8 at ``bpc`` 1, uint16 at 2),
    rows given top-down and stored bottom-up, planar or run-length (the
    offset and length tables, then the rows channel by channel)."""
    z, h, w = planes.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = (struct.pack(">hBBHHHHll", 474, int(rle), bpc, dimension, w, h, z, 0,
                        255 if bpc == 1 else 65535) + bytes(4) + struct.pack("79s", name)
            + bytes(1) + struct.pack(">l", 0) + bytes(404))
    flipped = planes[:, ::-1]
    if not rle:
        return head + flipped.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    rows = [_sgi_rle_row(flipped[c, y], bpc) for c in range(z) for y in range(h)]
    starts, pos = [], 512 + 8 * z * h
    for r in rows:
        starts.append(pos)
        pos += len(r)
    return (head + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *map(len, rows))
            + b"".join(rows))


def pcx_file(rows: np.ndarray, width: int, bits: int, planes: int, *, version: int = 5,
             palette16: bytes = bytes(48), trailer: bytes = b"") -> bytes:
    """A PCX file of (h, planes x stride) bytes per row, each byte written as
    a run of one (0xC1, byte), and ``trailer`` after the data."""
    h, line = rows.shape
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, width - 1, h - 1, 72, 72)
            + palette16.ljust(48, b"\0")[:48] + bytes(1)
            + struct.pack("<BHHHH", planes, line // planes, 1, width, h) + bytes(54))
    body = bytes(np.stack([np.full(rows.shape, 0xC1, np.uint8), rows], -1).reshape(-1))
    return head + body + trailer


def pcx_bitplanes(index: np.ndarray, planes: int, palette16: bytes) -> bytes:
    """A PCX of 1 bit in ``planes`` planes (index bit p in plane p), each
    plane's line padded to an even number of bytes."""
    h, w = index.shape
    stride = (w + 7) // 8
    stride += stride % 2
    line = np.zeros((h, planes, stride), np.uint8)
    for p in range(planes):
        packed = np.packbits((index >> p) & 1, axis=1)
        line[:, p, : packed.shape[1]] = packed
    return pcx_file(line.reshape(h, -1), w, 1, planes, palette16=palette16)


def dcx(frames: list[bytes]) -> bytes:
    """A DCX file: the magic, the frames' offsets, a zero, the frames."""
    pos, offsets = 4 + 4 * (len(frames) + 1), []
    for f in frames:
        offsets.append(pos)
        pos += len(f)
    return struct.pack(f"<I{len(frames) + 1}I", 0x3ADE68B1, *offsets, 0) + b"".join(frames)


def dds_file(width: int, height: int, pfflags: int, body: bytes, *, fourcc: bytes = bytes(4),
             bitcount: int = 0, masks=(0, 0, 0, 0), dxgi: int | None = None) -> bytes:
    """A DDS file: the 128-byte header (with a DX10 header when ``dxgi`` is
    given), then ``body``."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 0) + bytes(44)
            + struct.pack("<I", 32) + struct.pack("<I", pfflags)
            + (b"DX10" if dxgi is not None else fourcc) + struct.pack("<I", bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def dds_masked(pix: np.ndarray, masks, bitcount: int) -> bytes:
    """(h, w, c) uint8 packed little-endian by ``masks``: each channel's top
    bits in its mask's field."""
    value = np.zeros(pix.shape[:2], np.uint64)
    for c, m in enumerate(masks):
        if not m:
            continue
        shift = (m & -m).bit_length() - 1
        width = (m >> shift).bit_length()
        field = pix[..., c].astype(np.uint64)
        field = field >> np.uint64(8 - width) if width <= 8 else field << np.uint64(width - 8)
        value |= field << np.uint64(shift)
    return value.astype("<u8").view(np.uint8).reshape(pix.shape[:2] + (8,))[..., : bitcount // 8].tobytes()


def bcn_blocks(width: int, height: int, block_bytes: int, seed: int) -> bytes:
    """Seeded random BCn blocks for a ``width`` x ``height`` image."""
    n = ((width + 3) // 4) * ((height + 3) // 4)
    return np.random.default_rng(seed).integers(0, 256, n * block_bytes).astype(np.uint8).tobytes()


def make_plain_fixtures() -> dict[str, bytes]:
    """The plain formats' fixtures: Pillow's ``save`` of
    ``plain_sources()`` (``PLAIN_ENCODE_FILES``) and the read fixtures
    (``PLAIN_READ_FILES``)."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import plain_sources

    def save(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    files = {}
    for n, a in plain_sources().items():  # SGI and IM write the base name: save by name
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            Image.fromarray(a).save(os.path.join(d, n))
            with open(os.path.join(d, n), "rb") as f:
                files[n] = f.read()
    rng = np.random.default_rng(17)
    rgb = smooth(37, 45, 3, 6)
    rgba = np.concatenate([rgb, smooth(37, 45, 1, 7)], -1)
    deep = (rgb.astype(np.uint16) * 257 + rng.integers(0, 256, rgb.shape)).astype(np.uint16)
    pal = Image.fromarray(rgb).quantize(64, method=Image.Quantize.MEDIANCUT)
    index16 = rng.integers(0, 16, (21, 45))
    palette16 = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    grey_pcx = save(Image.fromarray(rgb[..., 1]), "PCX")
    y, x = np.mgrid[0:24, 0:32]
    ramp = np.stack([x * 8, y * 10, (x + y) * 4, 255 - x * 8], -1).astype(np.uint8)
    floats = (rgb[..., 0].astype(np.float32) * 1.3 - 40.25).astype(np.float32)
    dx10 = {"bc4.dds": (80, 8, 32, 24), "bc5s.dds": (84, 16, 32, 24), "bc6h.dds": (95, 16, 32, 24),
            "bc6hs.dds": (96, 16, 32, 24), "bc7.dds": (98, 16, 32, 24), "bc7_odd.dds": (99, 16, 7, 5)}
    files.update({
        "rle8.sgi": sgi_file(rgba.transpose(2, 0, 1), 1, rle=True, name=b"rle8"),
        "rle16.sgi": sgi_file(deep.transpose(2, 0, 1), 2, rle=True),
        "raw16.sgi": sgi_file(deep[None, ..., 0], 2),
        "bits1.pcx": save(Image.fromarray(rgb[..., 0]).convert("1"), "PCX"),
        "planes4.pcx": pcx_bitplanes(index16, 4, palette16),
        "palette.pcx": save(pal, "PCX"),
        "frames.dcx": dcx([grey_pcx, save(pal, "PCX")]),
        "palette.im": save(pal, "IM"),
        "float.im": save(Image.fromarray(floats, "F"), "IM"),
        "dxt1.dds": save(Image.fromarray(rgba), "DDS", pixel_format="DXT1"),
        "dxt3.dds": save(Image.fromarray(rgba), "DDS", pixel_format="DXT3"),
        "dxt5.dds": save(Image.fromarray(rgba), "DDS", pixel_format="DXT5"),
        "bc5.dds": save(Image.fromarray(rgb), "DDS", pixel_format="BC5"),
        "la.dds": save(Image.fromarray(rgba[..., 2:]).convert("LA"), "DDS"),
        "rgb565.dds": dds_file(32, 24, 0x40, dds_masked(ramp, (0xF800, 0x7E0, 0x1F), 16),
                               bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "argb4444.dds": dds_file(32, 24, 0x41, dds_masked(ramp, (0xF00, 0xF0, 0xF, 0xF000), 16),
                                 bitcount=16, masks=(0xF00, 0xF0, 0xF, 0xF000)),
        "p8.dds": dds_file(32, 24, 0x20, rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
                           + rng.integers(0, 256, 32 * 24).astype(np.uint8).tobytes(),
                           bitcount=8),
        "rgba8.dds": dds_file(32, 24, 0x4, ramp.tobytes(), dxgi=28),
    })
    for i, (n, (dxgi, block, w, h)) in enumerate(dx10.items()):
        files[n] = dds_file(w, h, 0x4, bcn_blocks(w, h, block, 40 + i), dxgi=dxgi)
    return files


def plain_digests(files: dict[str, bytes]) -> dict:
    """``PLAIN_FILE``: each plain fixture's SHA-256; ``PLAIN_DECODE``: that of
    Pillow's ``convert("RGBA")`` of it."""
    return {"PLAIN_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "PLAIN_DECODE": {n: pillow_rgba_sha(d) for n, d in sorted(files.items())}}


# ---------------------------------------------------------------------------
# ICO, CUR, ICNS and PSD
# ---------------------------------------------------------------------------


def icon_file(entries: list[tuple], cur: bool = False) -> bytes:
    """An ICO (or, with ``cur``, a CUR) of ready entry bodies: each entry
    ``(width, height, bpp, body)`` or ``(width, height, bpp, body,
    colors)``; 256 is stored as 0. A cursor's planes and bits fields hold
    its hotspot (here (1, 2))."""
    head = (b"\0\0\2\0" if cur else b"\0\0\1\0") + struct.pack("<H", len(entries))
    offset = len(head) + 16 * len(entries)
    dirs, bodies = [], []
    for e in entries:
        w, h, bpp, body = e[:4]
        colors = e[4] if len(e) > 4 else 0
        planes, bits = (1, 2) if cur else (1, bpp)
        dirs.append(struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, planes, bits, len(body),
                                offset))
        bodies.append(body)
        offset += len(body)
    return head + b"".join(dirs) + b"".join(bodies)


def and_mask(mask: np.ndarray) -> bytes:
    """An icon's AND mask: 1 bit a pixel (set = transparent), rows padded
    to 32 bits, bottom-up."""
    h, w = mask.shape
    stride = (w + 31) // 32 * 4
    bits = np.zeros((h, stride * 8), np.uint8)
    bits[:, :w] = mask != 0
    return np.packbits(bits[::-1], axis=1).tobytes()


def icon_dib(pix: np.ndarray, bits: int, mask: np.ndarray | None = None,
             palette: np.ndarray | None = None) -> bytes:
    """An icon's DIB: the header with twice the height, the palette, the
    image's rows bottom-up (``pix``: (h, w) indices at 1/4/8 bits, (h, w,
    3) RGB at 24, (h, w, 4) RGBA at 32) and the AND mask (all opaque where
    ``mask`` is None)."""
    h, w = pix.shape[:2]
    body = raw_rows(pix if bits <= 8 else pix[..., [2, 1, 0, 3][: pix.shape[2]]], bits)
    body += and_mask(np.zeros((h, w), np.uint8) if mask is None else mask)
    return bmp(body, w, 2 * h, bits, palette=palette)[14:]


def icns_rle(plane: np.ndarray) -> bytes:
    """One channel in ICNS's run-length code: runs of 3 to 130 equal bytes
    as ``n + 125, byte``, the rest as literals of at most 128 bytes."""
    v = np.asarray(plane, np.uint8).ravel()
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(v):
        run = 1
        while i + run < len(v) and run < 130 and v[i + run] == v[i]:
            run += 1
        if run >= 3:
            for k in range(0, len(lit), 128):
                out += bytes([len(lit[k: k + 128]) - 1]) + lit[k: k + 128]
            lit.clear()
            out += bytes([run + 125, int(v[i])])
            i += run
        else:
            lit.append(int(v[i]))
            i += 1
    for k in range(0, len(lit), 128):
        out += bytes([len(lit[k: k + 128]) - 1]) + lit[k: k + 128]
    return bytes(out)


def icns_file(blocks: list[tuple[bytes, bytes]]) -> bytes:
    """An ICNS of ``(type, body)`` blocks."""
    body = b"".join(kind + struct.pack(">I", 8 + len(b)) + b for kind, b in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def psd_resource(rid: int, name: bytes, data: bytes) -> bytes:
    """One image resource: ``8BIM``, its id, its Pascal name padded to an
    even length, its data padded to an even length."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) & 1)
    return b"8BIM" + struct.pack(">H", rid) + pname + struct.pack(">I", len(data)) + data + (
        b"\0" * (len(data) & 1))


def psd_file(planes: np.ndarray, mode: int, *, bits: int = 8, compression: int = 0,
             color_data: bytes = b"", resources: bytes = b"", layers: bytes = b"",
             channels: int | None = None, width: int | None = None) -> bytes:
    """A PSD whose composite image is ``planes`` ((C, H, W) uint8 channels;
    at 1 bit, (1, H, ceil(W / 8)) packed rows), raw (0) or PackBits (1,
    with a row-length table for every channel, as Photoshop writes it);
    ``channels`` overrides the header's count and ``compression`` may be
    any number (2 is ZIP); ``width`` is the header's (a 1-bit image's
    may end inside its last byte)."""
    c, h, row = planes.shape
    w = width or (row * 8 if bits == 1 else row)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits, mode)
    out = head + struct.pack(">I", len(color_data)) + color_data
    out += struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers + struct.pack(">H", compression)
    if compression == 1:
        rows = [packbits(planes[k, y].tobytes(), row) for k in range(c) for y in range(h)]
        return out + b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)
    return out + planes.tobytes()


def make_icon_fixtures() -> dict[str, bytes]:
    """The ICO, CUR, ICNS and PSD read fixtures (``ICON_FILES``): Pillow's
    ``save`` where Pillow writes the variant (ICO with PNG entries, and with
    BMP entries through ``bitmap_format="bmp"``), this module's writers for
    the rest (ICO with 1/4/8/24/32-bit DIBs and AND masks, entries of one
    size at several depths, a PNG entry with ``tRNS``; cursors; ICNS with
    run-length planes and masks, raw planes, PNG entries; PSD in every mode
    Pillow reads, raw and PackBits, and the kinds it refuses), and the
    textured scene's images (the blob's base colour as a PackBits PSD and as
    an ICO of BMP entries, the checker as an ICNS, the sky as a PackBits
    PSD)."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image import encode_png, encode_png_samples
    from stillleben_tpu_torch.assets.procedural import base_color_texture, checker_texture, sky_ldr

    def save(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    rng = np.random.default_rng(19)
    rgb = smooth(37, 45, 3, 8)
    rgba = np.concatenate([rgb, smooth(37, 45, 1, 9)], -1)
    deep = (rgb[..., 0].astype(np.uint16) * 257 + rng.integers(0, 256, rgb.shape[:2])).astype(
        np.uint16)
    h, w = 20, 27
    mask = (smooth(h, w, 1, 10)[..., 0] > 150).astype(np.uint8)
    pal = {n: rng.integers(0, 256, (n, 3)).astype(np.uint8) for n in (2, 16, 256)}
    idx = {n: rng.integers(0, n, (h, w)).astype(np.uint8) for n in (2, 16, 256)}
    pix24 = smooth(h, w, 3, 11)
    pix32 = np.concatenate([pix24, smooth(h, w, 1, 12)], -1)
    e = {1: (w, h, 1, icon_dib(idx[2], 1, mask, pal[2]), 2),
         4: (w, h, 4, icon_dib(idx[16], 4, mask, pal[16]), 16),
         8: (w, h, 8, icon_dib(idx[256], 8, mask, pal[256])),
         24: (w, h, 24, icon_dib(pix24, 24, mask)),
         32: (w, h, 32, icon_dib(pix32, 32, mask))}
    bw = (w, h, 1, icon_dib(idx[2], 1, mask, np.array([[0, 0, 0], [255, 255, 255]], np.uint8)), 2)
    small32 = (16, 16, 32, icon_dib(pix32[:16, :16], 32))
    png_p = encode_png_samples(idx[16][..., None], 3, 8, palette=pal[16],
                               trns=bytes(range(0, 256, 16)))

    def planes(p):
        return b"".join(icns_rle(p[..., c]) for c in range(3))

    p128, p48, p32, p16 = (smooth(s, s, 4, 20 + s) for s in (128, 48, 32, 16))
    p16[3:9, 2:12] = 200  # runs in every plane
    W, H = 29, 19
    ch = rng.integers(0, 256, (5, H, W)).astype(np.uint8)
    ch[:, 5:9, :] = 77
    ch[:, 12:, 3:20] = smooth(H - 12, 17, 5, 13).transpose(2, 0, 1)
    res = psd_resource(1039, b"icc", b"abc") + psd_resource(1005, b"", b"1234")
    palette = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    bits1 = np.packbits(smooth(H, W, 1, 14)[..., 0] > 128, axis=1)[None]
    blob = base_color_texture(0)[..., :3]
    blob_small = np.asarray(Image.fromarray(blob).resize((128, 128), Image.Resampling.BILINEAR))
    checker = checker_texture(256)[..., :3]
    return {
        "pillow_rgba.ico": save(Image.fromarray(rgba), "ICO"),
        "pillow_bmp_rgba.ico": save(Image.fromarray(rgba), "ICO", bitmap_format="bmp"),
        "pillow_bmp_rgb.ico": save(Image.fromarray(rgb), "ICO", bitmap_format="bmp"),
        "pillow_bmp_grey.ico": save(Image.fromarray(rgb[..., 1]), "ICO", bitmap_format="bmp"),
        "pillow_depth16.ico": save(Image.fromarray(deep), "ICO"),
        "dib1.ico": icon_file([e[1]]),
        "dib1_bw.ico": icon_file([bw]),
        "dib4.ico": icon_file([e[4]]),
        "dib8.ico": icon_file([e[8]]),
        "dib24.ico": icon_file([e[24]]),
        "dib32.ico": icon_file([e[32]]),
        "depths.ico": icon_file([small32, e[24], e[8], e[32], e[4]]),
        "png_trns.ico": icon_file([(w, h, 8, png_p)]),
        "cursor.cur": icon_file([e[32]], cur=True),
        "cursors.cur": icon_file([small32, e[32], e[24]], cur=True),
        "cursor8.cur": icon_file([e[8]], cur=True),
        "rle.icns": icns_file([(b"TOC ", bytes(8)), (b"is32", planes(p16)),
                               (b"s8mk", p16[..., 3].tobytes()), (b"il32", planes(p32)),
                               (b"l8mk", p32[..., 3].tobytes()), (b"ih32", planes(p48)),
                               (b"h8mk", p48[..., 3].tobytes()),
                               (b"it32", bytes(4) + planes(p128)),
                               (b"t8mk", p128[..., 3].tobytes())]),
        "rle48.icns": icns_file([(b"is32", planes(p16)), (b"ih32", planes(p48))]),
        "raw.icns": icns_file([(b"il32", p32[..., :3].tobytes()),
                               (b"l8mk", p32[..., 3].tobytes())]),
        "png.icns": icns_file([(b"it32", bytes(4) + planes(p128)),
                               (b"ic11", encode_png(p32)), (b"ic07", encode_png(p128[..., :3]))]),
        "png_grey.icns": icns_file([(b"ic07", encode_png(smooth(128, 128, 1, 15)[..., 0]))]),
        "unknown.icns": icns_file([(b"ic09", b"JUNK" * 4)]),
        "checker.icns": icns_file([(b"ic08", encode_png(checker)),
                                   (b"it32", bytes(4) + planes(checker[::2, ::2])),
                                   (b"t8mk", bytes(128 * 128))]),
        "bitmap.psd": psd_file(bits1, 0, bits=1, width=W),
        "bitmap_rle.psd": psd_file(bits1, 0, bits=1, width=W, compression=1),
        "grey_rle.psd": psd_file(ch[:1], 1, compression=1, resources=res, layers=bytes(10)),
        "indexed.psd": psd_file(ch[:1], 2, color_data=palette),
        "indexed_rle.psd": psd_file(ch[:1], 2, color_data=palette, compression=1),
        "indexed_nopalette.psd": psd_file(ch[:1], 2),
        "rgb.psd": psd_file(ch[:3], 3, resources=res),
        "rgb_rle.psd": psd_file(ch[:3], 3, compression=1),
        "rgba.psd": psd_file(ch[:4], 3),
        "rgba_rle.psd": psd_file(ch[:4], 3, compression=1, layers=bytes(6)),
        "rgb5_rle.psd": psd_file(ch[:5], 3, compression=1),
        "cmyk.psd": psd_file(ch[:4], 4),
        "cmyk_rle.psd": psd_file(ch[:4], 4, compression=1),
        "cmyk5_rle.psd": psd_file(ch[:5], 4, compression=1),
        "duotone.psd": psd_file(ch[:1], 8, color_data=bytes(10)),
        "multichannel_rle.psd": psd_file(ch[:3], 7, compression=1),
        "grey16.psd": psd_file(ch[:2], 1, bits=16),
        "zip.psd": psd_file(ch[:3], 3, compression=2),
        "two_channels.psd": psd_file(ch[:2], 3),
        "truncated.psd": psd_file(ch[:3], 3)[:-50],
        "truncated_rle.psd": psd_file(ch[:3], 3, compression=1)[:-50],
        "blob_packbits.psd": psd_file(np.ascontiguousarray(blob.transpose(2, 0, 1)), 3,
                                      compression=1),
        "sky_packbits.psd": psd_file(np.ascontiguousarray(sky_ldr(64, 128).transpose(2, 0, 1)), 3,
                                     compression=1),
        "blob_bmp.ico": save(Image.fromarray(blob_small), "ICO", bitmap_format="bmp",
                             sizes=[(32, 32), (128, 128)]),
    }


# what the icon and PSD readers refuse with, by the words of their messages
ICON_REFUSALS = ("cannot identify image file", "image file is truncated", "not enough channels",
                 "cannot load this image")


def icon_reading(data: bytes) -> str:
    """SHA-256 of Pillow's ``convert("RGBA")`` of ``data``, or ``refused:``
    and which of ``ICON_REFUSALS`` its ``OSError`` says, or the type and
    message of any other exception."""
    try:
        return pillow_rgba_sha(data)
    except OSError as e:
        return "refused: " + next(r for r in ICON_REFUSALS if r in str(e))
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        return f"{type(e).__name__}: {e}"


def icon_digests(files: dict[str, bytes]) -> dict:
    """``ICON_FILE`` / ``ICON_DECODE``: each icon and PSD fixture's SHA-256
    and Pillow's reading of it; ``ICON_ENCODE``: the SHA-256 of Pillow's
    ``save`` of each of ``icon_sources()`` (the saver's ICO and ICNS, not
    committed)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import icon_sources

    return {"ICON_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "ICON_DECODE": {n: icon_reading(d) for n, d in sorted(files.items())},
            "ICON_ENCODE": {n: hashlib.sha256(pillow_save(a, os.path.splitext(n)[1])).hexdigest()
                            for n, a in icon_sources().items()}}


# ---------------------------------------------------------------------------
# JPEG variants: libjpeg-turbo's own writer
# ---------------------------------------------------------------------------

# a shim over the libjpeg-turbo that Pillow ships (3.1), built against the
# system's jpeglib.h (the jpeg62 ABI both share); the 3.x entry points the
# older header lacks are declared here
_JPEG_SHIM = r"""
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr, int, int);
JDIMENSION jpeg12_write_scanlines(j_compress_ptr, short**, JDIMENSION);
JDIMENSION jpeg16_write_scanlines(j_compress_ptr, unsigned short**, JDIMENSION);

struct shim_err { struct jpeg_error_mgr pub; jmp_buf jb; char msg[JMSG_LENGTH_MAX]; };

static void on_error(j_common_ptr c) {
  struct shim_err* e = (struct shim_err*)c->err;
  (*c->err->format_message)(c, e->msg);
  longjmp(e->jb, 1);
}

/* o: quality, progressive, arith, psv (0: not lossless), pt, restart_interval,
   restart_in_rows, precision, dc_L, dc_U, ac_K, adobe (-1: libjpeg's
   choice), jfif (-1), jpeg colour space (0: libjpeg's default), then
   h, v for each component (0: libjpeg's default) */
int sl_shim_write(const void* pix, int w, int h, int nc, int in_cs, const int* o,
                  unsigned char** out, unsigned long* len, char* msg) {
  struct jpeg_compress_struct ci;
  struct shim_err err;
  ci.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  *out = NULL;
  *len = 0;
  if (setjmp(err.jb)) {
    strcpy(msg, err.msg);
    jpeg_destroy_compress(&ci);
    if (*out) free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_compress(&ci);
  jpeg_mem_dest(&ci, out, len);
  ci.image_width = w;
  ci.image_height = h;
  ci.input_components = nc;
  ci.in_color_space = (J_COLOR_SPACE)in_cs;
  ci.data_precision = o[7];
  jpeg_set_defaults(&ci);
  ci.data_precision = o[7];
  if (o[3]) jpeg_enable_lossless(&ci, o[3], o[4]);
  if (o[13]) jpeg_set_colorspace(&ci, (J_COLOR_SPACE)o[13]);
  for (int k = 0; k < nc && k < 4; k++)
    if (o[14 + 2 * k]) {
      ci.comp_info[k].h_samp_factor = o[14 + 2 * k];
      ci.comp_info[k].v_samp_factor = o[15 + 2 * k];
    }
  jpeg_set_quality(&ci, o[0], TRUE);
  if (o[2]) ci.arith_code = TRUE;
  for (int t = 0; t < NUM_ARITH_TBLS; t++) {
    ci.arith_dc_L[t] = (UINT8)o[8];
    ci.arith_dc_U[t] = (UINT8)o[9];
    ci.arith_ac_K[t] = (UINT8)o[10];
  }
  if (o[1]) jpeg_simple_progression(&ci);
  ci.restart_interval = o[5];
  ci.restart_in_rows = o[6];
  if (o[11] >= 0) ci.write_Adobe_marker = o[11];
  if (o[12] >= 0) ci.write_JFIF_header = o[12];
  jpeg_start_compress(&ci, TRUE);
  int stride = w * nc;
  while (ci.next_scanline < ci.image_height) {
    int y = ci.next_scanline;
    if (o[7] <= 8) {
      JSAMPROW row = (JSAMPROW)((const unsigned char*)pix + (size_t)y * stride);
      jpeg_write_scanlines(&ci, &row, 1);
    } else if (o[7] <= 12) {
      short* row = (short*)pix + (size_t)y * stride;
      jpeg12_write_scanlines(&ci, &row, 1);
    } else {
      unsigned short* row = (unsigned short*)pix + (size_t)y * stride;
      jpeg16_write_scanlines(&ci, &row, 1);
    }
  }
  jpeg_finish_compress(&ci);
  jpeg_destroy_compress(&ci);
  return 0;
}

void sl_shim_free(unsigned char* p) { free(p); }
"""

# libjpeg's J_COLOR_SPACE values
JCS = {"L": 1, "RGB": 2, "YCbCr": 3, "CMYK": 4, "YCCK": 5}
_jpeg_shim_lib = None


def _jpeg_shim():
    """The shim, compiled by gcc at first use into the port's gitignored
    build directory and linked to Pillow's bundled libjpeg-turbo."""
    global _jpeg_shim_lib
    if _jpeg_shim_lib is not None:
        return _jpeg_shim_lib
    import ctypes
    import glob
    import subprocess
    import tempfile

    import PIL
    from PIL import Image  # noqa: F401  (loads Pillow's libjpeg first)

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    libjpeg = glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0]
    key = hashlib.sha256((_JPEG_SHIM + libjpeg).encode()).hexdigest()[:16]
    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    so = os.path.join(build, f"libsl_jpeg_shim_{key}.so")
    if not os.path.exists(so):
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as d:
            src = os.path.join(d, "shim.c")
            with open(src, "w") as f:
                f.write(_JPEG_SHIM)
            tmp = os.path.join(d, "shim.so")
            subprocess.run(["gcc", "-O1", "-shared", "-fPIC", src, libjpeg, "-o", tmp,
                            f"-Wl,-rpath,{libs}"], check=True, capture_output=True)
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.sl_shim_write.restype = ctypes.c_int
    lib.sl_shim_write.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                  ctypes.POINTER(ctypes.c_ulong), ctypes.c_char_p)
    lib.sl_shim_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
    lib.sl_shim_free.restype = None
    _jpeg_shim_lib = lib
    return lib


def libjpeg_write(pixels: np.ndarray, *, mode: str | None = None, quality: int = 75,
                  progressive: bool = False, arith: bool = False, lossless=None,
                  restart_interval: int = 0, restart_rows: int = 0, precision: int = 8,
                  dac=(0, 1, 5), adobe=None, jfif=None, colorspace: str | None = None,
                  sampling=()) -> bytes:
    """libjpeg-turbo 3.1's encode of (H, W) or (H, W, C) samples (uint8,
    or uint16 at ``precision`` 12 or 16): ``mode`` the input colour space
    (L, RGB or CMYK by the channels), ``arith`` arithmetic coding with the
    conditioning ``dac`` = (L, U, Kx) on every table, ``progressive``
    libjpeg's simple progression, ``lossless`` = (predictor, point
    transform), ``colorspace`` the file's (e.g. YCCK), ``sampling`` the
    (h, v) of each component, ``adobe`` / ``jfif`` whether those markers are
    written (libjpeg's choice when None). Raises ``ValueError`` with
    libjpeg's message where libjpeg refuses."""
    import ctypes

    lib = _jpeg_shim()
    a = np.asarray(pixels)
    nc = 1 if a.ndim == 2 else a.shape[2]
    mode = mode or {1: "L", 3: "RGB", 4: "CMYK"}[nc]
    a = np.ascontiguousarray(a, np.uint8 if precision <= 8 else np.uint16)
    psv, pt = lossless or (0, 0)
    opts = [quality, int(progressive), int(arith), psv, pt, restart_interval, restart_rows,
            precision, *dac, -1 if adobe is None else int(adobe),
            -1 if jfif is None else int(jfif), JCS[colorspace] if colorspace else 0]
    opts += [0] * 8
    for k, (hs, vs) in enumerate(sampling):
        opts[14 + 2 * k], opts[15 + 2 * k] = hs, vs
    o = np.array(opts, np.int32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_ulong(0)
    msg = ctypes.create_string_buffer(512)
    rc = lib.sl_shim_write(a.ctypes.data_as(ctypes.c_void_p), a.shape[1], a.shape[0], nc,
                           JCS[mode], o.ctypes.data_as(ctypes.c_void_p), ctypes.byref(out),
                           ctypes.byref(n), msg)
    if rc:
        raise ValueError(f"libjpeg: {msg.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.sl_shim_free(out)


def lossless_jpeg(planes: list[np.ndarray], sampling: list[tuple[int, int]], width: int,
                  height: int, psv: int = 1, pt: int = 0, restart_interval: int = 0,
                  ids=None, jfif: bool = True, adobe: int | None = None) -> bytes:
    """A lossless (SOF3) 8-bit JPEG of one interleaved scan written here, for
    what libjpeg's writer does not make: subsampled components and YCbCr
    (libjpeg-turbo writes its lossless files 1x1, without colour
    conversion). ``planes``: each component's samples at its downsampled
    size; ``sampling``: its (h, v); ``restart_interval`` in MCUs (a multiple
    of the MCUs in a row); ``adobe``: an Adobe marker's colour transform.
    The predictions are the decoder's (jdpred.c):
    a row that starts the scan or a restart interval predicts its first
    sample from 2^(7 - pt), the rest of a row's first column from above."""
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcux, mcuy = -(-width // max_h), -(-height // max_v)
    if restart_interval % mcux:
        raise ValueError("a lossless restart interval is whole MCU rows")
    # one table for sizes 0..16: two codes of each length 2..9, one of 10
    bits = [0, 0] + [2] * 8 + [1] + [0] * 6
    codes, code, sym = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[sym] = (code, length)
            code, sym = code + 1, sym + 1
        code <<= 1
    out, acc, nacc = bytearray(), 0, 0

    def put(value, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | value, nacc + n
        while nacc >= 8:
            b = (acc >> (nacc - 8)) & 255
            out.append(b)
            if b == 0xFF:
                out.append(0)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def flush():
        nonlocal nacc
        if nacc:
            put((1 << (8 - nacc)) - 1, 8 - nacc)

    x = [np.asarray(p, np.int64) >> pt for p in planes]
    first_row = [True] * len(planes)
    rows_per_rst = restart_interval // mcux if restart_interval else 0
    rst = 0
    for my in range(mcuy):
        if rows_per_rst and my and my % rows_per_rst == 0:
            flush()
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            first_row = [True] * len(planes)
        diffs = []  # each component's v rows of differences for this MCU row
        for ci, (h, v) in enumerate(sampling):
            p = x[ci]
            dh, dw = p.shape
            rows = np.zeros((v, mcux * h), np.int64)
            for r in range(v):
                j = my * v + r
                if j >= dh:
                    continue
                for i in range(dw):
                    ra = p[j, i - 1] if i else 0
                    rb = p[j - 1, i] if j else 0
                    rc = p[j - 1, i - 1] if j and i else 0
                    if first_row[ci] and r == 0:
                        pred = (1 << (7 - pt)) if i == 0 else ra
                    elif i == 0:
                        pred = rb
                    else:
                        pred = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]
                    rows[r, i] = (p[j, i] - pred) & 0xFFFF
            first_row[ci] = False
            diffs.append(rows)
        for mx in range(mcux):
            for ci, (h, v) in enumerate(sampling):
                for r in range(v):
                    for c in range(h):
                        d = int(diffs[ci][r, mx * h + c])
                        d = d - 65536 if d > 32768 else d
                        size = 16 if d == 32768 else abs(d).bit_length()
                        put(*codes[size])
                        if 0 < size < 16:
                            put(d if d > 0 else d + (1 << size) - 1, size)
    flush()
    ids = ids or list(range(1, len(planes) + 1))

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    head = b"\xff\xd8"
    if jfif:
        head += seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    head += seg(0xC4, bytes([0]) + bytes(bits[1:17]) + bytes(range(17)))
    head += seg(0xC3, struct.pack(">BHHB", 8, height, width, len(planes)) + b"".join(
        bytes([ids[k], (h << 4) | v, 0]) for k, (h, v) in enumerate(sampling)))
    if restart_interval:
        head += seg(0xDD, struct.pack(">H", restart_interval))
    head += seg(0xDA, bytes([len(planes)]) + b"".join(bytes([i, 0]) for i in ids) +
                bytes([psv, 0, pt]))
    return head + bytes(out) + b"\xff\xd9"


def jpeg_scans(data: bytes) -> list[int]:
    """The offsets of a JPEG's SOS markers."""
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


def jpeg_cut_after_scan(data: bytes, k: int, eoi: bool = True) -> bytes:
    """A progressive JPEG's first ``k`` scans, with an EOI or without."""
    return data[: jpeg_scans(data)[k]] + (b"\xff\xd9" if eoi else b"")


def jpeg_patch_marker(data: bytes, old: int, new: int) -> bytes:
    """``data`` with its first marker ``old`` renamed ``new`` (a frame of
    another process: hierarchical, lossless arithmetic)."""
    i = data.index(bytes([0xFF, old]))
    return data[: i + 1] + bytes([new]) + data[i + 2:]


def pillow_cmyk_jpeg(rgb: np.ndarray, **kw) -> bytes:
    """Pillow's ``save`` of ``convert("CMYK")`` of an RGB image (the Adobe
    CMYK a photo editor exports)."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(b, "JPEG", **kw)
    return b.getvalue()


def _with_black(rgb: np.ndarray) -> np.ndarray:
    """uint8 CMYK samples of an RGB image: the inverted channels and a black
    plane from their minimum (as libjpeg takes CMYK: no inversion)."""
    c = 255 - rgb.astype(np.int32)
    k = c.min(-1, keepdims=True)
    return np.concatenate([c - k // 2, k], -1).astype(np.uint8)


def make_jpeg_variant_fixtures() -> dict[str, bytes]:
    """The JPEG variant fixtures (``image_fixtures.JPEG_VARIANT_FILES``: the
    files the card's host, which has no libjpeg, cannot write), written by
    libjpeg-turbo 3.1 (``libjpeg_write``), Pillow, or ``lossless_jpeg``: a
    61x83 cut of ``webp_frame()`` in each variant (``arith.jpg``: restarts
    every 3 MCUs and DAC L=2 U=5 Kx=20; ``truncated_prog.jpg`` cut inside its
    6th scan, no EOI; ``hierarchical.jpg`` and ``lossless_arith.jpg`` a
    frame renamed SOF5 and SOF11), the whole 640x480 frame in six, and the
    textured scene's images (the blob's base colour, the checker, the sky)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.procedural import base_color_texture, checker_texture, sky_ldr

    frame = webp_frame()
    small = np.ascontiguousarray(frame[200:261, 180:263])
    blob = base_color_texture(0)[..., :3].copy()
    w = libjpeg_write
    sub = [np.ascontiguousarray(small[::2, ::2, 0]), small[..., 1], small[..., 2]]
    ycc = [small[..., k] for k in range(3)]
    prog = w(frame[:160, :200], progressive=True)
    return {
        "arith.jpg": w(small, arith=True, restart_interval=3, dac=(2, 5, 20)),
        "arith_prog.jpg": w(small, arith=True, progressive=True,
                            sampling=((2, 1), (1, 1), (1, 1))),
        "arith_grey.jpg": w(small[..., 1], arith=True),
        "lossless.jpg": w(small, lossless=(7, 1), restart_rows=2),
        "lossless_grey.jpg": w(small[..., 1], lossless=(1, 0)),
        "lossless_sub.jpg": lossless_jpeg(sub, [(1, 1), (2, 2), (2, 2)], 83, 61, psv=4,
                                          ids=[82, 71, 66], jfif=False),
        "cmyk.jpg": pillow_cmyk_jpeg(small),
        "cmyk_prog.jpg": w(_with_black(small), progressive=True, adobe=False),
        "ycck.jpg": w(_with_black(small), colorspace="YCCK", sampling=((1, 1),) * 4),
        "ycck_arith.jpg": w(_with_black(small), colorspace="YCCK", arith=True,
                            progressive=True),
        "smoothed.jpg": jpeg_cut_after_scan(w(small, progressive=True), 3),
        "smoothed_arith.jpg": jpeg_cut_after_scan(w(small, progressive=True, arith=True), 2),
        "truncated_prog.jpg": prog[: (jpeg_scans(prog)[5] + jpeg_scans(prog)[6]) // 2],
        "bits12.jpg": w(small.astype(np.uint16) * 16, precision=12),
        "lossless16.jpg": w(small.astype(np.uint16) * 257, precision=16, lossless=(1, 0)),
        "hierarchical.jpg": jpeg_patch_marker(w(small), 0xC0, 0xC5),
        "lossless_arith.jpg": jpeg_patch_marker(w(small, lossless=(1, 0)), 0xC3, 0xCB),
        "lossless_ycc.jpg": lossless_jpeg(ycc, [(1, 1)] * 3, 83, 61),
        "frame_arith.jpg": w(frame, arith=True),
        "frame_arith_prog.jpg": w(frame, arith=True, progressive=True),
        "frame_lossless.jpg": w(frame, lossless=(6, 1)),
        "frame_cmyk.jpg": pillow_cmyk_jpeg(frame),
        "frame_ycck.jpg": w(_with_black(frame), colorspace="YCCK",
                            sampling=((2, 2), (1, 1), (1, 1), (2, 2))),
        "frame_smoothed.jpg": jpeg_cut_after_scan(w(frame, progressive=True), 5),
        "blob_arith.jpg": w(blob, arith=True, progressive=True),
        "blob_cmyk.jpg": pillow_cmyk_jpeg(blob),
        "checker_lossless.jpg": w(checker_texture()[..., :3], lossless=(1, 0)),
        "sky_ycck.jpg": w(_with_black(sky_ldr()), colorspace="YCCK"),
    }


# how Pillow refuses a file, by the words of its message
PILLOW_REFUSALS = ("cannot identify image file", "broken data stream when reading image file",
                   "image file is truncated")


def pillow_reading(data: bytes) -> str:
    """SHA-256 of Pillow's ``convert("RGBA")`` of ``data``, or ``refused:``
    and which of ``PILLOW_REFUSALS`` its ``OSError`` says."""
    from PIL import Image

    try:
        return pillow_rgba_sha(data)
    except OSError as e:
        return "refused: " + next(r for r in PILLOW_REFUSALS if r in str(e))


def cv2_reading(data: bytes) -> str:
    """SHA-256 of ``cv2.imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``'s bytes
    of ``data`` as a ``.jpg``, or ``None`` where it reads nothing."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.jpg")
        with open(p, "wb") as f:
            f.write(data)
        img = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return "None" if img is None else hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def jpeg_variant_digests(files: dict[str, bytes]) -> dict:
    return {"JPEG_VARIANT_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "JPEG_VARIANT_DECODE": {n: pillow_reading(d) for n, d in sorted(files.items())},
            "JPEG_VARIANT_DECODE_CV2": {n: cv2_reading(d) for n, d in sorted(files.items())}}


# ---------------------------------------------------------------------------
# JPEG 2000, EPS and PDF: Pillow's writers
# ---------------------------------------------------------------------------


def pillow_file(pixels: np.ndarray, name: str, **kw) -> bytes:
    """The bytes of Pillow's ``save`` of ``pixels`` to a file called
    ``name``, as the JAX ``ImageSaver`` saves it: the name picks the format,
    JPEG 2000's container (a codestream only for ``.j2k``) and a PDF's
    title. A PDF's dates are the clock's: fix ``time.gmtime`` for its bytes
    (``fixed_clock``)."""
    import tempfile

    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, name)
        Image.fromarray(np.asarray(pixels)).save(p, **kw)
        with open(p, "rb") as f:
            return f.read()


class fixed_clock:
    """``time.gmtime()`` without an argument gives ``time.gmtime(at)``
    inside the ``with`` block (Pillow's PDF writer and the port's read the
    clock through it)."""

    def __init__(self, at: int):
        self.at = at

    def __enter__(self):
        import time

        self._gmtime = time.gmtime
        time.gmtime = lambda *a: self._gmtime(*(a or (self.at,)))
        return self

    def __exit__(self, *exc):
        import time

        time.gmtime = self._gmtime


def patch_cod_style(codestream: bytes, style: int) -> bytes:
    """A codestream with its COD's code-block style byte replaced."""
    at = codestream.index(b"\xff\x52") + 12  # marker, Lcod, Scod, SGcod, levels, xcb, ycb
    return codestream[:at] + bytes([style]) + codestream[at + 1:]


def make_jpeg2000_fixtures() -> dict[str, bytes]:
    """The JPEG 2000 fixtures: Pillow's ``save`` at its defaults of
    ``jpeg2000_sources()`` (``JPEG2000_ENCODE_FILES``),
    ``JPEG2000_READ_FILES``: Pillow's files with the reversible colour
    transform (RGB, RGBA), of LA, of 32x32 code-blocks, of two levels, with
    the 9/7 wavelet, two layers, precincts, RPCL and tiles, and its COD's
    code-block style patched to 1 (Pillow sets no style), which the port
    refuses; an ICNS whose 128^2 entry is Pillow's JP2 of an RGBA image and
    one whose 128^2 entry is a 9/7 codestream; and
    ``jpeg2000_settings_fixtures()`` (``JPEG2000_SETTINGS_FILES``)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import jpeg2000_sources

    files = {n: pillow_file(a, n) for n, a in jpeg2000_sources().items()}
    rgb, rgba = smooth(40, 56, 3, 30), smooth(40, 56, 4, 31)
    big = smooth(70, 90, 3, 32)
    nine_seven = pillow_file(rgb, "x.j2k", irreversible=True)
    nine_seven_128 = pillow_file(smooth(128, 128, 3, 34), "x.j2k", irreversible=True)
    files.update({
        "rct.jp2": pillow_file(rgb, "rct.jp2", mct=1),
        "rct_rgba.j2k": pillow_file(rgba, "rct_rgba.j2k", mct=1),
        "la.jp2": pillow_file(rgba[..., ::3].copy(), "la.jp2"),
        "la.j2k": pillow_file(rgba[..., ::3].copy(), "la.j2k"),
        "cblk32.j2k": pillow_file(big, "cblk32.j2k", codeblock_size=(32, 32)),
        "levels2.jp2": pillow_file(big, "levels2.jp2", num_resolutions=3),
        "irreversible.j2k": nine_seven,
        "layers.jp2": pillow_file(big, "layers.jp2", quality_layers=[40, 10]),
        "precincts.j2k": pillow_file(big, "precincts.j2k", precinct_size=(64, 64)),
        "rpcl.j2k": pillow_file(big, "rpcl.j2k", progression="RPCL"),
        "tiles.j2k": pillow_file(big, "tiles.j2k", tile_size=(32, 32)),
        "cblk_style.j2k": patch_cod_style(pillow_file(rgb, "x.j2k"), 1),
        "j2k_entry.icns": icns_file([(b"ic07", pillow_file(smooth(128, 128, 4, 33), "x.jp2"))]),
        "j2k_97.icns": icns_file([(b"ic07", nine_seven_128)]),
    })
    files.update(jpeg2000_settings_fixtures())
    return files


def jpeg2000_settings_fixtures() -> dict[str, bytes]:
    """``JPEG2000_SETTINGS_FILES``: Pillow's ``save`` at the options other
    encoders' files carry: the 9/7 wavelet in L, RGB, LA, RGBA and I;16,
    with and without the ICT (``mct=1``; Pillow writes none for LA); quality
    layers by rate and by dB, with either wavelet; precincts of 16, 32 and
    64 with either wavelet (16 at five resolutions or fewer: OpenJPEG reads
    no precinct exponent of 0 above the lowest resolution); the five
    progression orders on one multi-resolution, multi-precinct, three-layer
    file, and RPCL and CPRL under 9/7; tiles with tile and image offsets
    (a last tile column 1 px wide, a last tile row 1 px high, tiles at odd
    origins) and an image offset in one tile; one resolution; PLT markers; signed
    samples (L, RGB, I;16, 9/7); the three cinema profiles at 1x1, and
    4K's at 48x64 (its POC in a tile-part header); the edge sizes under 9/7
    and under tiles; ICNS whose 128^2 entry is a JP2 of 9/7 with two layers
    and one whose entry's code-block style is patched to 1, which the port
    refuses; the 640x480 frame of ``seeded_images()`` three ways
    (``JPEG2000_TIMED``); the blob's base colour as a layered 9/7 + ICT JP2
    and the checker as a tiled codestream (``JPEG2000_SCENE``)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import seeded_images
    from stillleben_tpu_torch.assets.procedural import base_color_texture, checker_texture

    rgb, rgba = smooth(40, 56, 3, 40), smooth(40, 56, 4, 41)
    grey, la = rgb[..., 1].copy(), rgba[..., ::3].copy()
    noise = np.random.default_rng(42).integers(0, 256, (40, 56))
    deep = (smooth(40, 56, 1, 43)[..., 0].astype(np.int64) * 256 + noise).astype(np.uint16)
    big = smooth(70, 90, 3, 44)
    ramp = (np.arange(640) * 255 // 639).astype(np.uint8)[None]
    frame = seeded_images()["frame"]
    nine, ict = {"irreversible": True}, {"irreversible": True, "mct": 1}
    layered = {"precinct_size": (32, 32), "quality_layers": [40, 20, 10]}
    specs = {
        "i97_l.j2k": (grey, nine), "i97_rgb.jp2": (rgb, nine), "i97_la.jp2": (la, nine),
        "i97_rgba.j2k": (rgba, nine), "i97_i16.j2k": (deep, nine), "i97_i16.jp2": (deep, nine),
        "ict_rgb.j2k": (rgb, ict), "ict_rgba.jp2": (rgba, ict), "ict_la.j2k": (la, ict),
        "layers_rates.j2k": (big, {"quality_layers": [40, 20, 10]}),
        "layers_db.jp2": (big, {"quality_mode": "dB", "quality_layers": [30, 40, 50]}),
        "layers_97.j2k": (big, {**ict, "quality_layers": [60, 20, 5]}),
        "layers_db_97.j2k": (big, {**nine, "quality_mode": "dB", "quality_layers": [25, 35]}),
        "prec16.j2k": (big, {"precinct_size": (16, 16), "num_resolutions": 5}),
        "prec32.j2k": (big, {"precinct_size": (32, 32)}),
        "prec64.jp2": (big, {"precinct_size": (64, 64)}),
        "prec16_97.j2k": (big, {**nine, "precinct_size": (16, 16), "num_resolutions": 4}),
        "prec32_97.j2k": (big, {**ict, "precinct_size": (32, 32)}),
        "prec64_97.jp2": (big, {**nine, "precinct_size": (64, 64)}),
        **{f"order_{o.lower()}.j2k": (big, {**layered, "progression": o})
           for o in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
        "order_rpcl_97.jp2": (rgba, {**ict, **layered, "progression": "RPCL",
                                     "precinct_size": (16, 16), "num_resolutions": 5}),
        "order_cprl_97.j2k": (big, {**ict, **layered, "progression": "CPRL"}),
        "tiles_col1.j2k": (smooth(50, 61, 3, 45),
                           {"tile_size": (32, 32), "tile_offset": (5, 7), "offset": (9, 11)}),
        "tiles_row1.jp2": (smooth(63, 70, 3, 46),
                           {"tile_size": (32, 32), "tile_offset": (2, 3), "offset": (3, 5)}),
        "tiles_odd_97.j2k": (smooth(45, 60, 4, 47),
                             {**ict, "tile_size": (17, 23), "tile_offset": (1, 3),
                              "offset": (3, 4), "quality_layers": [30, 10]}),
        "tiles_rgba.jp2": (rgba, {"tile_size": (24, 16), "precinct_size": (16, 16),
                                  "progression": "PCRL"}),
        "offset.j2k": (rgb, {"offset": (7, 3), "tile_size": (63, 43)}),
        "res1.j2k": (rgb, {"num_resolutions": 1}),
        "res1_97.jp2": (rgba, {**nine, "num_resolutions": 1}),
        "plt.j2k": (big, {"plt": True, "quality_layers": [40, 10]}),
        "plt_97.jp2": (big, {**ict, "plt": True, "progression": "PCRL",
                             "precinct_size": (32, 32)}),
        "signed_l.j2k": (grey, {"signed": True}), "signed_rgb.jp2": (rgb, {"signed": True}),
        "signed_i16.j2k": (deep, {"signed": True}), "signed_97.j2k": (rgb, {**ict, "signed": True}),
        "cinema2k24.j2k": (smooth(1, 1, 3, 48), {"cinema_mode": "cinema2k-24"}),
        "cinema2k48.j2k": (smooth(1, 1, 3, 49), {"cinema_mode": "cinema2k-48"}),
        "cinema4k24.j2k": (smooth(1, 1, 3, 50), {"cinema_mode": "cinema4k-24"}),
        "cinema4k24_48x64.j2k": (smooth(48, 64, 3, 51), {"cinema_mode": "cinema4k-24"}),
        "i97_1x1.j2k": (smooth(1, 1, 3, 52), nine), "i97_1x640.j2k": (ramp, nine),
        "i97_3x5.jp2": (smooth(3, 5, 4, 53), ict), "i97_33x33.j2k": (smooth(33, 33, 3, 54), ict),
        "i97_65x130.j2k": (smooth(65, 130, 3, 55), {**nine, "quality_layers": [20, 5]}),
        "tiled_1x1.j2k": (smooth(1, 1, 3, 56), {"tile_size": (2, 2), "offset": (1, 1)}),
        "tiled_1x640.j2k": (ramp, {"tile_size": (100, 4), "tile_offset": (0, 1),
                                   "offset": (5, 2)}),
        "tiled_3x5.j2k": (deep[:3, :5].copy(), {"tile_size": (2, 2), "offset": (1, 0)}),
        "tiled_33x33.jp2": (smooth(33, 33, 4, 57), {"tile_size": (16, 16), "tile_offset": (1, 1),
                                                    "offset": (2, 3)}),
        "tiled_65x130.j2k": (smooth(65, 130, 3, 58), {**ict, "tile_size": (64, 32),
                                                      "offset": (1, 1)}),
        "frame_ict.j2k": (frame, {**ict, "quality_layers": [20]}),
        "frame_layers.jp2": (frame, {**ict, "quality_layers": [40, 20, 10]}),
        "frame_tiles.j2k": (frame, {**ict, "tile_size": (256, 256), "precinct_size": (64, 64),
                                    "progression": "PCRL", "quality_layers": [20]}),
        "blob_basecolor_97.jp2": (np.ascontiguousarray(base_color_texture(0)[..., :3]),
                                  {**ict, "quality_layers": [40, 20, 10]}),
        "checker_tiles.j2k": (np.ascontiguousarray(checker_texture()[..., :3]),
                              {"tile_size": (160, 96), "tile_offset": (1, 2), "offset": (3, 5)}),
    }
    files = {n: pillow_file(a, n, **kw) for n, (a, kw) in specs.items()}
    files["j2k_layers.icns"] = icns_file([(b"ic07", pillow_file(
        smooth(128, 128, 4, 59), "x.jp2", **ict, quality_layers=[30, 10]))])
    files["j2k_style.icns"] = icns_file([(b"ic07", patch_cod_style(
        pillow_file(smooth(128, 128, 3, 60), "x.j2k"), 1))])
    return files


J2K_SWEEP_SIZES = ((1, 1), (1, 64), (5, 1), (3, 5), (16, 16), (31, 40), (33, 33), (64, 64),
                   (65, 130), (100, 77), (130, 65))


def jpeg2000_sweep_case(i: int) -> tuple[np.ndarray, dict]:
    """Seeded case ``i`` of Pillow's JPEG 2000 settings: a mode (L, LA, RGB, RGBA,
    I;16), a size (480x640 for every tenth), random or smooth content, and
    ``save`` options: the 9/7 wavelet (with the ICT for colour), quality
    layers by rate or dB, precincts, an order, code-block sizes, a number
    of resolutions that fits the image, tiles with offsets (under 5/3:
    OpenJPEG's encoder aborts on a 9/7 line of one sample), signed samples,
    PLT markers."""
    rng = np.random.default_rng(500 + i)
    mode = ("L", "LA", "RGB", "RGBA", "I;16")[i % 5]
    h, w = (480, 640) if i % 10 == 9 else J2K_SWEEP_SIZES[int(rng.integers(len(J2K_SWEEP_SIZES)))]
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    if rng.random() < 0.5:
        a = rng.integers(0, 65536 if mode == "I;16" else 256, (h, w, c))
    else:
        a = smooth(h, w, c, i).astype(np.int64) * (257 if mode == "I;16" else 1)
    a = a.astype(np.uint16 if mode == "I;16" else np.uint8)
    a = a[..., 0] if c == 1 else a
    kw = {}
    nine = rng.random() < 0.5
    if nine:
        kw["irreversible"] = True
        if c >= 3 and rng.random() < 0.7:
            kw["mct"] = 1
    if rng.random() < 0.5:
        if rng.random() < 0.5:
            rates = rng.choice([2, 5, 10, 20, 40, 80], rng.integers(1, 4))
            kw["quality_layers"] = sorted(rates)[::-1]
        else:
            kw["quality_mode"] = "dB"
            kw["quality_layers"] = sorted(rng.choice([20, 30, 40, 50], rng.integers(1, 4)))
        kw["quality_layers"] = [int(v) for v in kw["quality_layers"]]
    fit = int(np.log2(min(h, w))) + 1
    if rng.random() < 0.4:
        kw["num_resolutions"] = int(rng.integers(1, fit + 1))
    if rng.random() < 0.4:
        kw["precinct_size"] = tuple(int(v) for v in rng.choice([16, 32, 64, 128], 2))
    if rng.random() < 0.6:
        kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]))
    if rng.random() < 0.3:
        kw["codeblock_size"] = tuple(int(v) for v in rng.choice([8, 16, 32, 64], 2))
    if not nine and rng.random() < 0.4:
        ox, oy = (int(v) for v in rng.integers(0, 9, 2))
        kw["tile_size"] = tuple(int(v) for v in rng.integers(1, 80, 2))
        kw["offset"] = (ox, oy)
        kw["tile_offset"] = (int(rng.integers(0, ox + 1)), int(rng.integers(0, oy + 1)))
    if rng.random() < 0.15:
        kw["signed"] = True
    if rng.random() < 0.15:
        kw["plt"] = True
    return a, kw


def pillow_file_forked(pixels: np.ndarray, name: str, **kw) -> bytes | None:
    """``pillow_file`` in a forked child (``forked``): None where OpenJPEG's
    encoder aborts the process (it does on some lines of one sample, such
    as a 1x1 image in tiles at an offset); raises what Pillow's ``save``
    raises."""
    return forked(pillow_file, pixels, name, **kw)


def jpeg2000_sweep_one(i: int) -> tuple[int, str]:
    """Case ``i`` of ``jpeg2000_sweep_case`` through Pillow's writer and the
    port's readings: "" where both match the libraries' (or the port
    raises where Pillow's reading does), "skipped" where Pillow's save
    refuses the options or its encoder aborts, else what differed."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import jpeg2000

    a, kw = jpeg2000_sweep_case(i)
    name = ("x.j2k", "x.jp2")[i % 2]
    try:
        d = pillow_file_forked(a, name, **kw)
    except (OSError, ValueError):
        d = None
    if d is None:
        return i, "skipped"
    try:
        ref = np.asarray(Image.open(io.BytesIO(d)).convert("RGBA"))
    except OSError:
        try:
            jpeg2000.decode_jpeg2000(d, name)
        except (OSError, ValueError):
            return i, ""
        return i, f"{a.shape} {kw}: read where Pillow raises"
    try:
        pil = np.array_equal(jpeg2000.decode_jpeg2000(d, name), ref)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(d)
            cv = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        got = jpeg2000.decode_jpeg2000_cv2(d, name)
        ocv = (cv is None) == (got is None) and (cv is None or np.array_equal(got, cv))
    except Exception as e:  # noqa: BLE001  (a refusal is a difference too)
        return i, f"{a.shape} {kw}: {type(e).__name__}: {e}"
    return i, "" if pil and ocv else f"{a.shape} {kw}: Pillow {pil}, OpenCV {ocv}"


def jpeg2000_sweep(n: int, start: int = 0, workers: int = 3) -> list[str]:
    """``--jpeg2000-sweep N [START]``: cases START .. START + N - 1 of
    ``jpeg2000_sweep_case`` through Pillow's writer and the port's
    readings; prints and returns what differed."""
    import multiprocessing

    bad, skipped = [], 0
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for i, diff in pool.imap_unordered(jpeg2000_sweep_one, range(start, start + n)):
            skipped += diff == "skipped"
            if diff and diff != "skipped":
                bad.append(f"case {i}: {diff}")
                print(bad[-1], flush=True)
    print(f"{n} cases from {start}: {skipped} not written (Pillow refused or its encoder "
          f"aborted), {n - skipped - len(bad)} read as Pillow and OpenCV read them")
    return bad


def jpeg2000_times(reps: int = 5) -> None:
    """``--jpeg2000-times``: the least ms of ``reps`` of Pillow's
    ``convert("RGBA")`` and of the port's ``decode_jpeg2000`` on each of
    ``JPEG2000_TIMED``, one after the other, on this host."""
    import time

    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import jpeg2000
    from stillleben_tpu_torch.assets.image_fixtures import JPEG2000_TIMED, path

    for what, name in JPEG2000_TIMED.items():
        with open(path(name), "rb") as f:
            d = f.read()
        pil, port = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            ref = np.asarray(Image.open(io.BytesIO(d)).convert("RGBA"))
            t1 = time.perf_counter()
            got = jpeg2000.decode_jpeg2000(d, name)
            pil.append(t1 - t0)
            port.append(time.perf_counter() - t1)
        print(f"{what} ({name}, {len(d)} B): Pillow {min(pil) * 1e3:.1f} ms, the port "
              f"{min(port) * 1e3:.1f} ms, the least of {reps}; equal {np.array_equal(got, ref)}")


def write_jpeg2000_fixtures() -> None:
    """Writes ``make_jpeg2000_fixtures()``'s files and rewrites
    ``digests.py`` with new ``JPEG2000_FILE``, ``JPEG2000_DECODE`` and
    ``JPEG2000_DECODE_CV2`` tables and every other table as it stands
    (``--jpeg2000``: no other fixture is made again)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    files = make_jpeg2000_fixtures()
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    tables = {k: dict(v) for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    new = jpeg2000_digests(files)
    for key in ("JPEG2000_FILE", "JPEG2000_DECODE", "JPEG2000_DECODE_CV2"):
        tables[key] = new[key]
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))
    print({k: len(v) for k, v in files.items()}, sum(map(len, files.values())))


def any_reading(data: bytes) -> str:
    """SHA-256 of Pillow's ``convert("RGBA")`` of ``data``, or the type and
    message of the exception it raises."""
    try:
        return pillow_rgba_sha(data)
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        return f"{type(e).__name__}: {e}"


def cv2_file_reading(data: bytes, name: str) -> str:
    """``cv2_reading`` of ``data`` saved under ``name``."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(data)
        img = cv2.imread(p, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return "None" if img is None else hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def jpeg2000_digests(files: dict[str, bytes]) -> dict:
    """``JPEG2000_FILE`` / ``JPEG2000_DECODE`` / ``JPEG2000_DECODE_CV2``:
    each JPEG 2000 fixture's SHA-256 and Pillow's and OpenCV's readings of
    it; ``JPEG2000_ENCODE``: the SHA-256 of Pillow's file of each of
    ``jpeg2000_saver_sources()`` under its name (PDFs at ``PDF_CLOCK``)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import PDF_CLOCK, jpeg2000_saver_sources

    with fixed_clock(PDF_CLOCK):
        encode = {n: hashlib.sha256(pillow_file(a, n)).hexdigest()
                  for n, a in jpeg2000_saver_sources().items()}
    return {"JPEG2000_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "JPEG2000_DECODE": {n: any_reading(d) for n, d in sorted(files.items())},
            "JPEG2000_DECODE_CV2": {n: cv2_file_reading(d, n) for n, d in sorted(files.items())},
            "JPEG2000_ENCODE": encode}


def make_avif_fixtures() -> dict[str, bytes]:
    """The AVIF fixtures (``AVIF_FILES``): Pillow's ``save`` of
    ``avif_sources()`` with their options, and ``anim.avifs``: three smooth
    frames saved with ``save_all`` (a sequence; libavif writes its first
    frame as the still item too, with CDEF on)."""
    import tempfile

    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import avif_sources

    files = {n: pillow_file(a, n, **kw) for n, (a, kw) in avif_sources().items()}
    frames = [Image.fromarray(smooth(32, 48, 3, 50 + i)) for i in range(3)]
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "anim.avifs")
        frames[0].save(p, save_all=True, append_images=frames[1:])
        with open(p, "rb") as f:
            files["anim.avifs"] = f.read()
    return files


def make_avif_tool_fixtures() -> dict[str, bytes]:
    """The AVIF fixtures of the decoder's other tools (``AVIF_TOOL_FILES``):
    Pillow's ``save`` of ``avif_tool_sources()`` with their options, then
    ``avif_colr_variants()``: a file of those with its ``colr`` box patched,
    and ``alpha_limited.avif``: ``lr_rgba.avif`` with its alpha item's
    sequence header saying limited range."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import (avif_colr_variants, avif_tool_sources,
                                                            patch_colr)

    files = {n: pillow_file(a, n, **kw) for n, (a, kw) in avif_tool_sources().items()}
    for n, (src, matrix, full) in avif_colr_variants().items():
        files[n] = patch_colr(files[src], matrix, full)
    files["alpha_limited.avif"] = limited_alpha(files["lr_rgba.avif"])
    return files


def limited_alpha(data: bytes) -> bytes:
    """``data`` with its alpha item's ``color_range`` bit cleared, where the
    decoder's sequence header parser finds it (``av1_info``), so Pillow and
    OpenCV widen the alpha as they widen a limited-range one."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import avif, native_image

    alpha = avif.parse_avif(data).alpha
    bit = native_image.av1_info(alpha)["color_range_bit"]
    b = bytearray(alpha)
    b[bit // 8] &= ~(0x80 >> (bit % 8))
    return data.replace(alpha, bytes(b), 1)


def add_avif_tool_fixtures() -> None:
    """Writes ``make_avif_tool_fixtures()``'s files and rewrites
    ``digests.py`` with their entries added to ``AVIF_FILE``,
    ``AVIF_DECODE`` and ``AVIF_DECODE_CV2`` and every other entry as it
    stands (``--avif-tools``: no other fixture is made again)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    files = make_avif_tool_fixtures()
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    tables = {k: dict(v) for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    for key, table in avif_digests(files).items():
        tables[key].update(table)
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))
    print({k: len(v) for k, v in files.items()}, sum(map(len, files.values())))


class AvifImageHead(ctypes.Structure):
    """The head of libavif's ``avifImage`` (1.3.0 and 1.4.2 alike)."""
    _fields_ = [(k, ctypes.c_uint32) for k in ("width", "height", "depth")] + [
        (k, ctypes.c_int) for k in ("yuvFormat", "yuvRange", "chromaSamplePosition")] + [
        ("planes", ctypes.c_void_p * 3), ("rowBytes", ctypes.c_uint32 * 3),
        ("ownsPlanes", ctypes.c_int), ("alpha", ctypes.c_void_p), ("alphaRowBytes", ctypes.c_uint32),
        ("ownsAlpha", ctypes.c_int), ("premultiplied", ctypes.c_int), ("icc", ctypes.c_void_p),
        ("iccSize", ctypes.c_size_t), ("colorPrimaries", ctypes.c_uint16),
        ("transferCharacteristics", ctypes.c_uint16), ("matrixCoefficients", ctypes.c_uint16)]


AVIF_FORMATS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}  # avifPixelFormat


def libavif_library(which: str) -> ctypes.CDLL:
    """Pillow's bundled libavif 1.3.0 (``which`` "pillow") or OpenCV's 1.4.2
    ("opencv") through ctypes, with the argument types of the image calls
    the fixture writers and the tests make."""
    import glob

    if which == "pillow":
        import PIL
        base = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    else:
        import cv2
        base = os.path.join(os.path.dirname(cv2.__file__), os.pardir, "opencv_python.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(base, "libavif-*"))[0])
    lib.avifImageCreate.restype = lib.avifEncoderCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = (ctypes.c_uint32,) * 3 + (ctypes.c_int,)
    lib.avifImageAllocatePlanes.argtypes = (ctypes.c_void_p, ctypes.c_int)
    lib.avifImageDestroy.argtypes = lib.avifEncoderDestroy.argtypes = (ctypes.c_void_p,)
    lib.avifImageYUVToRGB.argtypes = lib.avifRGBImageSetDefaults.argtypes = (ctypes.c_void_p,) * 2
    lib.avifEncoderSetCodecSpecificOption.argtypes = (ctypes.c_void_p,) + (ctypes.c_char_p,) * 2
    return lib


def libavif_image(lib: ctypes.CDLL, planes: list, alpha, depth: int, subsampling: str,
                  full: bool = True, matrix: int = 6) -> int:
    """A new ``avifImage`` (its address) holding YUV ``planes`` of ``depth``
    bits (and ``alpha``), BT.709 primaries and sRGB transfer; the caller
    destroys it."""
    h, w = planes[0].shape
    img = lib.avifImageCreate(w, h, depth, AVIF_FORMATS[subsampling])
    im = AvifImageHead.from_address(img)
    im.yuvRange, im.matrixCoefficients = int(full), matrix
    im.colorPrimaries, im.transferCharacteristics = 1, 13
    assert lib.avifImageAllocatePlanes(img, 1 | (2 if alpha is not None else 0)) == 0
    dt = np.uint16 if depth > 8 else np.uint8

    def put(ptr, row_bytes, a):
        buf = (ctypes.c_uint8 * (row_bytes * a.shape[0])).from_address(ptr)
        np.frombuffer(buf, dt).reshape(a.shape[0], -1)[:, :a.shape[1]] = a

    for i, plane in enumerate(planes):
        put(im.planes[i], im.rowBytes[i], plane)
    if alpha is not None:
        put(im.alpha, im.alphaRowBytes, alpha)
    return img


def libavif_encode_planes(planes: list, depth: int, subsampling: str, options: dict) -> bytes:
    """OpenCV's bundled libavif 1.4.2 (over aom) encoding YUV ``planes`` of
    ``depth`` bits (BT.601, full range) at its defaults with aom's
    codec-specific ``options`` (``film-grain-test``: the bitstreams with film
    grain at every depth, which neither Python writer makes), through
    ctypes."""
    class RWData(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t)]

    lib = libavif_library("opencv")
    lib.avifEncoderWrite.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(RWData))
    lib.avifRWDataFree.argtypes = (ctypes.POINTER(RWData),)
    img = libavif_image(lib, planes, None, depth, subsampling)
    enc = lib.avifEncoderCreate()
    out = RWData()
    try:
        for k, v in options.items():
            assert lib.avifEncoderSetCodecSpecificOption(enc, k.encode(), str(v).encode()) == 0
        assert lib.avifEncoderWrite(enc, img, ctypes.byref(out)) == 0
        return ctypes.string_at(out.data, out.size)
    finally:
        lib.avifRWDataFree(ctypes.byref(out))
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(img)


def make_avif_cv2_fixtures() -> dict[str, bytes]:
    """The files of ``AVIF_CV2_FILES``: ``avif_cv2_sources()`` through their
    writers (OpenCV's ``imwrite``, Pillow's ``save``, OpenCV's libavif on
    YUV planes), then ``avif_cv2_variants()``'s patched ``colr`` boxes."""
    import cv2

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import (avif_cv2_sources, avif_cv2_variants,
                                                            patch_colr)

    files = {}
    for name, (writer, pixels, opts) in avif_cv2_sources().items():
        if writer == "cv2":
            params = []
            for k, v in opts.items():
                params += [getattr(cv2, f"IMWRITE_AVIF_{k}"), v]
            files[name] = _cv2_file(pixels, ".avif", params)
        elif writer == "pillow":
            files[name] = pillow_file(pixels, name, **opts)
        else:
            files[name] = libavif_encode_planes(
                pixels, opts["depth"], opts["subsampling"],
                {k: v for k, v in opts.items() if k not in ("depth", "subsampling")})
    for name, (src, matrix, full) in avif_cv2_variants().items():
        files[name] = patch_colr(files[src], matrix, full)
    return files


def add_avif_cv2_fixtures() -> None:
    """Writes ``make_avif_cv2_fixtures()``'s files and rewrites
    ``digests.py`` with their entries added to ``AVIF_FILE``,
    ``AVIF_DECODE`` and ``AVIF_DECODE_CV2`` and every other entry as it
    stands (``--avif-cv2``: no other fixture is made again)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    files = make_avif_cv2_fixtures()
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    tables = {k: dict(v) for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    for key, table in avif_digests(files).items():
        tables[key].update(table)
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))
    print({k: len(v) for k, v in files.items()}, sum(map(len, files.values())))


def avif_cv2_sweep_case(i: int) -> tuple[str, object, dict]:
    """Seeded case ``i`` of ``avif_cv2_sweep`` as (writer, pixels, options)
    of ``avif_cv2_sources()``: OpenCV's ``imwrite`` of grey, BGR or BGRA at
    depth 8, 10 or 12 and quality 0-100 (sizes 1 to 160 a side; smooth,
    random or few-colour content), or Pillow's 4:0:0 RGB or RGBA, or its
    quantizer matrices at random ``qm-min`` <= ``qm-max`` (speeds 0-6)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import _deep, _few_colours

    rng = np.random.default_rng(20000 + i)
    h, w = (int(v) for v in rng.integers(1, 161, 2))
    kind = int(rng.integers(0, 3))
    c = int(rng.choice([1, 3, 4]))
    a = (rng.integers(0, 256, (h, w, 3)).astype(np.uint8) if kind == 0 else smooth(h, w, 3, i)
         if kind == 1 else _few_colours(h, w, i, n=int(rng.integers(2, 6))))
    if c == 4:
        a = np.concatenate([a, smooth(h, w, 1, i + 1)], -1)
    writer = str(rng.choice(["cv2", "cv2", "pillow"]))
    if writer == "cv2":
        depth = int(rng.choice([8, 10, 12]))
        px = a[..., 0] if c == 1 else np.ascontiguousarray(a[..., [2, 1, 0, 3][:c]])
        if depth > 8:
            px = _deep(px, depth, i)
        opts = {"QUALITY": int(rng.integers(0, 101))}
        if depth > 8:
            opts["DEPTH"] = depth
        return writer, px, opts
    px = a if c != 1 else a[..., :3]
    kw = {"quality": int(rng.integers(10, 100)), "speed": int(rng.integers(0, 7)) if max(h, w) < 80
          else int(rng.integers(4, 7))}
    if rng.random() < 0.5:
        kw["subsampling"] = "4:0:0"
    else:
        lo = int(rng.integers(0, 16))
        kw["advanced"] = {"enable-qm": "1", "qm-min": str(lo),
                          "qm-max": str(int(rng.integers(lo, 16)))}
    return writer, px, kw


def avif_cv2_sweep_one(i: int) -> tuple[int, str]:
    """Case ``i`` written, then read by the port as Pillow and OpenCV read
    it (values, dtype, shape): (i, "" or what differed)."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import avif

    writer, px, opts = avif_cv2_sweep_case(i)
    if writer == "cv2":
        params = []
        for k, v in opts.items():
            params += [getattr(cv2, f"IMWRITE_AVIF_{k}"), v]
        d = _cv2_file(px, ".avif", params)
    else:
        d = pillow_file(px, "x.avif", **opts)
    what = f"{writer} {px.dtype} {px.shape} {opts}"
    try:
        pil = avif.decode_avif(d)
        ref = np.asarray(Image.open(io.BytesIO(d)).convert("RGBA"))
        ok_pil = pil.dtype == ref.dtype and np.array_equal(pil, ref)
        with tempfile.NamedTemporaryFile(suffix=".avif") as f:
            f.write(d)
            f.flush()
            ref = cv2.imread(f.name, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        got = avif.decode_avif_cv2(d)
        ok_cv = (got is None and ref is None) or (got is not None and ref is not None and
                                                   got.dtype == ref.dtype and got.shape == ref.shape
                                                   and np.array_equal(got, ref))
    except Exception as e:  # noqa: BLE001  (a refusal is a difference too)
        return i, f"{what}: {type(e).__name__}: {e}"
    return i, "" if ok_pil and ok_cv else f"{what}: Pillow {ok_pil}, OpenCV {ok_cv}"


def avif_cv2_sweep(n: int, start: int = 0, workers: int = 3) -> list[str]:
    """``--avif-cv2-sweep N [START]``: cases START .. START + N - 1 of
    ``avif_cv2_sweep_case`` through their writers and the port's readings;
    prints and returns what differed."""
    import multiprocessing

    bad = []
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for i, diff in pool.imap_unordered(avif_cv2_sweep_one, range(start, start + n)):
            if diff:
                bad.append(f"case {i}: {diff}")
                print(bad[-1], flush=True)
    print(f"{n} cases from {start}: {n - len(bad)} read as Pillow and OpenCV read them")
    return bad


def avif_sweep_case(i: int) -> tuple[np.ndarray, dict]:
    """Seeded case ``i`` of ``avif_sweep``: an array (random, smooth, a cut
    of the 640x480 frame, or few colours; RGB or RGBA; up to 199 a side, 79
    at speeds 0 and 1) and Pillow ``save`` options (speed 0-6, quality
    20-100, each subsampling; CDEF, 64x64 or 128x128 superblocks, intra
    block copy off, 2x2 tiles, premultiplied alpha, limited range at
    random)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import _few_colours, seeded_images

    rng = np.random.default_rng(10000 + i)
    speed = int(rng.integers(0, 7))
    top = 80 if speed <= 1 else 200
    h, w = (int(v) for v in rng.integers(1, top, 2))
    c = int(rng.choice([3, 4]))
    kind = int(rng.integers(0, 4))
    if kind == 0:
        a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    elif kind == 1:
        a = smooth(h, w, c, i)
    else:
        if kind == 2:
            y0, x0 = int(rng.integers(0, 480 - h)), int(rng.integers(0, 640 - w))
            a = np.ascontiguousarray(seeded_images()["frame"][y0:y0 + h, x0:x0 + w])
        else:
            a = _few_colours(h, w, i, n=int(rng.integers(2, 6)), cell=int(rng.integers(1, 9)))
        if c == 4:
            a = np.concatenate([a, smooth(h, w, 1, i)], -1)
    kw = {"speed": speed, "quality": int(rng.integers(20, 101)),
          "subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4"]))}
    adv = {}
    if rng.random() < 0.4:
        adv["enable-cdef"] = "1"
    if rng.random() < 0.2:
        adv["sb-size"] = str(rng.choice(["64", "128"]))
    if rng.random() < 0.1:
        adv["enable-intrabc"] = "0"
    if adv:
        kw["advanced"] = adv
    if rng.random() < 0.15:
        kw["tile_rows"] = kw["tile_cols"] = 1
    if c == 4 and rng.random() < 0.2:
        kw["alpha_premultiplied"] = True
    if rng.random() < 0.15:
        kw["range"] = "limited"
    return a, kw


def avif_sweep_one(i: int) -> tuple[int, str]:
    """Case ``i`` through Pillow's writer, read by the port as Pillow and
    OpenCV read it: (i, "" or what differed)."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import avif

    a, kw = avif_sweep_case(i)
    b = io.BytesIO()
    Image.fromarray(a).save(b, "AVIF", **kw)
    d = b.getvalue()
    try:
        pil = np.array_equal(avif.decode_avif(d), np.asarray(Image.open(io.BytesIO(d)).convert("RGBA")))
        with tempfile.NamedTemporaryFile(suffix=".avif") as f:
            f.write(d)
            f.flush()
            ref = cv2.imread(f.name, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        ocv = ref is not None and np.array_equal(avif.decode_avif_cv2(d), ref)
    except Exception as e:  # noqa: BLE001  (a refusal is a difference too)
        return i, f"{a.shape} {kw}: {type(e).__name__}: {e}"
    return i, "" if pil and ocv else f"{a.shape} {kw}: Pillow {pil}, OpenCV {ocv}"


def avif_sweep(n: int, start: int = 0, workers: int = 3) -> list[str]:
    """``--avif-sweep N [START]``: cases START .. START + N - 1 of
    ``avif_sweep_case`` through Pillow's writer and the port's readings;
    prints and returns what differed."""
    import multiprocessing

    bad = []
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for i, diff in pool.imap_unordered(avif_sweep_one, range(start, start + n)):
            if diff:
                bad.append(f"case {i}: {diff}")
                print(bad[-1], flush=True)
    print(f"{n} cases from {start}: {n - len(bad)} read as Pillow and OpenCV read them")
    return bad


def avif_digests(files: dict[str, bytes]) -> dict:
    """``AVIF_FILE`` / ``AVIF_DECODE`` / ``AVIF_DECODE_CV2``: each AVIF
    fixture's SHA-256 and Pillow's and OpenCV's readings of it (or the
    exception Pillow raises)."""
    return {"AVIF_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(files.items())},
            "AVIF_DECODE": {n: any_reading(d) for n, d in sorted(files.items())},
            "AVIF_DECODE_CV2": {n: cv2_file_reading(d, n) for n, d in sorted(files.items())}}


def avif_encode_digests() -> dict:
    """``AVIF_ENCODE``: the SHA-256 of the port's own AVIF file of each of
    ``avif_write_sources()`` (``avif.encode_avif``, which the saver calls;
    the same bytes on every host)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.avif import encode_avif
    from stillleben_tpu_torch.assets.image_fixtures import avif_write_sources

    return {"AVIF_ENCODE": {n: hashlib.sha256(encode_avif(a)).hexdigest()
                            for n, a in sorted(avif_write_sources().items())}}


def rewrite_avif_encode_digests() -> None:
    """Rewrites ``digests.py`` with a new ``AVIF_ENCODE`` table and every
    other table as it stands (``--avif-encode``: no other fixture is made
    again)."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    tables = {k: v for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    tables.update(avif_encode_digests())
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))


# ---------------------------------------------------------------------------
# Pillow's rarer formats
# ---------------------------------------------------------------------------


def make_pillow_format_fixtures() -> dict[str, bytes]:
    """The committed files of Pillow's rarer formats (``PILLOW_FORMAT_FILES``):
    Pillow's ``save`` of BLP1 and BLP2 palette images (RGB and RGBA
    palettes), XBM and MSP; OpenCV's ``imwrite`` of grey and colour ``.ras``
    (8 and 24 bits); the scene's blob base colour as BLP2 DXT5 and the
    checker plane as a run-length Sun raster of its two colours' indices
    and a palette; and
    ``rare_formats.pillow_format_files()``."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import rare_formats
    from stillleben_tpu_torch.assets.procedural import base_color_texture, checker_texture

    img = rare_formats.integer_image(31, 45, 4, 60)
    grey = img[..., 0]
    files = {}

    def save(im, fmt, **kw):
        b = io.BytesIO()
        im.save(b, fmt, **kw)
        return b.getvalue()

    for version in ("BLP1", "BLP2"):
        for alpha in (False, True):
            pal = Image.fromarray((grey // 16).astype(np.uint8), "P")
            colours = rare_formats.integer_image(16, 1, 4 if alpha else 3, 61)[:, 0]
            pal.putpalette(colours.tobytes(), "RGBA" if alpha else "RGB")
            name = f"{version.lower()}_palette{'_rgba' if alpha else ''}.blp"
            files[name] = save(pal, "BLP", blp_version=version)
    files["frame.xbm"] = save(Image.fromarray(grey).convert("1"), "XBM")
    files["frame.msp"] = save(Image.fromarray(grey).convert("1"), "MSP")
    with tempfile.TemporaryDirectory() as d:
        for name, a in (("cv2_grey.ras", grey), ("cv2_bgr.ras", img[..., :3])):
            cv2.imwrite(os.path.join(d, name), a)
            with open(os.path.join(d, name), "rb") as f:
                files[name] = f.read()
    files["blob_basecolor_dxt5.blp"] = rare_formats.blp_dxt(base_color_texture(0), 5)
    colours, index = np.unique(checker_texture()[..., :3].reshape(-1, 3), axis=0,
                               return_inverse=True)
    files["checker_rle.ras"] = rare_formats.sun_raster(index.reshape(512, 512), 8,
                                                       palette=colours, rle=True)
    files.update(rare_formats.pillow_format_files())
    return files


def pillow_format_digests(files: dict[str, bytes]) -> dict:
    """``PILLOW_FORMAT_FILE`` / ``PILLOW_FORMAT_DECODE`` /
    ``PILLOW_FORMAT_DECODE_CV2``: each file's SHA-256 and Pillow's and
    OpenCV's readings (or the exception; OpenCV's of the Sun rasters only);
    ``PCD_FILE`` / ``PCD_DECODE``: the same of ``rare_formats.pcd_files()``."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import rare_formats

    pcd = rare_formats.pcd_files()
    return {"PILLOW_FORMAT_FILE": {n: hashlib.sha256(d).hexdigest()
                                   for n, d in sorted(files.items())},
            "PILLOW_FORMAT_DECODE": {n: any_reading(d) for n, d in sorted(files.items())},
            "PILLOW_FORMAT_DECODE_CV2": {n: cv2_file_reading(d, n) for n, d in sorted(files.items())
                                         if n.endswith(".ras")},
            "PCD_FILE": {n: hashlib.sha256(d).hexdigest() for n, d in sorted(pcd.items())},
            "PCD_DECODE": {n: any_reading(d) for n, d in sorted(pcd.items())}}


def write_pillow_format_fixtures() -> None:
    """``--pillow-formats``: writes ``make_pillow_format_fixtures()``'s
    files and their five tables into ``digests.py``, every other table as it
    stands."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import digests as current

    files = make_pillow_format_fixtures()
    for name, data in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
    tables = {k: dict(v) for k, v in vars(current).items() if k.isupper() and isinstance(v, dict)}
    tables.update(pillow_format_digests(files))
    with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
        f.write(digest_module(tables))
    print({k: len(v) for k, v in files.items()}, sum(map(len, files.values())))


def pillow_formats_times(reps: int = 5) -> None:
    """``--pillow-formats-times``: per format of ``rare_formats.timing_files()``
    (one 640x480 file each), the least ms of ``reps`` of Pillow's
    ``Image.open`` (the header) and ``convert("RGBA")`` and of the port's
    ``decode_image``, one after the other, on this host."""
    import time

    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import image
    from stillleben_tpu_torch.assets.image_fixtures import rare_formats

    for fmt, data in rare_formats.timing_files().items():
        opened, pil, port = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            im = Image.open(io.BytesIO(data))
            t1 = time.perf_counter()
            ref = np.asarray(im.convert("RGBA"))
            t2 = time.perf_counter()
            got = image.decode_image(data, fmt)
            opened.append(t1 - t0)
            pil.append(t2 - t0)
            port.append(time.perf_counter() - t2)
        print(f"{fmt}: Pillow open {min(opened) * 1e3:.2f} ms, open + convert "
              f"{min(pil) * 1e3:.1f} ms; the port {min(port) * 1e3:.1f} ms (least of {reps}); "
              f"equal {np.array_equal(got, ref)}")


PILLOW_SWEEP_SIZES = ((1, 1), (3, 5), (33, 33), (65, 130))
PILLOW_SWEEP_FORMATS = ("sun", "sun_rle", "blp_dxt", "blp_palette", "ftex", "xbm", "xpm", "msp",
                        "gbr", "fits", "fli", "spider", "mcidas", "pixar", "imt", "xv", "iptc")


def pillow_formats_sweep_case(i: int) -> tuple[str, bytes]:
    """Seeded case ``i``: a format (in turn) at a size of
    ``PILLOW_SWEEP_SIZES`` with seeded content (noise, flat, or runs) and
    the writer's options drawn from the seed; (name, bytes)."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import rare_formats as rf

    rng = np.random.default_rng(7000 + i)
    fmt = PILLOW_SWEEP_FORMATS[i % len(PILLOW_SWEEP_FORMATS)]
    h, w = PILLOW_SWEEP_SIZES[int(rng.integers(len(PILLOW_SWEEP_SIZES)))]
    if rng.random() < 0.5:
        h, w = w, h
    kind = int(rng.integers(3))
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    if kind == 1:
        rgba[:] = rgba[:1, :1]
    elif kind == 2:
        rgba = np.repeat(rgba[:, : -(-w // 7)], 7, axis=1)[:, :w]
    rgb, grey = rgba[..., :3], rgba[..., 0]
    bits = (grey > 127).astype(np.uint8)

    def pick(*options):
        return options[int(rng.integers(len(options)))]

    if fmt == "sun":
        depth = pick(1, 4, 8, 24, 32)
        vals = {1: bits, 4: grey >> 4, 8: grey}.get(depth, rgb)
        pal = None
        if depth in (4, 8) and rng.random() < 0.5:
            pal = rng.integers(0, 256, (int(rng.integers(1, 257)), 3))
        return "x.ras", rf.sun_raster(vals, depth, ftype=pick(0, 1, 3, 4, 5), palette=pal)
    if fmt == "sun_rle":
        depth = pick(1, 8, 24, 32)
        vals = {1: bits, 8: grey}.get(depth, rgb)
        return "x.ras", rf.sun_raster(vals, depth, rle=True)
    if fmt == "blp_dxt":
        kind = pick(1, 3, 5)
        return "x.blp", rf.blp_dxt(rgba, kind, alpha=bool(rng.random() < 0.7))
    if fmt == "blp_palette":
        pal = Image.fromarray(grey, "P")
        raw = pick("RGB", "RGBA")
        pal.putpalette(rng.integers(0, 256, 256 * len(raw)).astype(np.uint8).tobytes(), raw)
        b = io.BytesIO()
        pal.save(b, "BLP", blp_version=pick("BLP1", "BLP2"))
        return "x.blp", b.getvalue()
    if fmt == "ftex":
        return pick(("x.ftc", rf.ftex(w, h, 0, rf.dxt_blocks(rgba, 1))),
                    ("x.ftu", rf.ftex(w, h, 1, rgb.tobytes())))
    if fmt == "xbm":
        b = io.BytesIO()
        Image.fromarray(bits * 255).convert("1").save(b, "XBM")
        return "x.xbm", b.getvalue()
    if fmt == "xpm":
        n = pick(2, 16, 256, 300)
        palette = rng.integers(0, 256, (n, 3))
        return "x.xpm", rf.xpm(rng.integers(0, n, (h, w)), palette, chars=1 if n <= 80 else 2,
                               pixels_comment=bool(rng.random() < 0.5))
    if fmt == "msp":
        if rng.random() < 0.5:
            b = io.BytesIO()
            Image.fromarray(bits * 255).convert("1").save(b, "MSP")
            return "x.msp", b.getvalue()
        return "x.msp", rf.msp_v2(bits, blank_rows=(0,) if rng.random() < 0.3 else ())
    if fmt == "gbr":
        return "x.gbr", rf.gbr(pick(grey, rgba), version=pick(1, 2))
    if fmt == "fits":
        bitpix = pick(8, 16, 32, -32, -64)
        vals = grey.astype(np.int64) * pick(1, 3) - pick(0, 40)
        if rng.random() < 0.25:
            return "x.fits", rf.fits_gzip(vals, bitpix)
        return "x.fits", rf.fits(vals if bitpix > 0 else vals / 1.7, bitpix)
    if fmt == "fli":
        chunks = [rf.fli_palette(rng.integers(0, 256, (256, 3)), colour64=bool(rng.random() < .5))]
        chunks.append(pick(rf.fli_brun, rf.fli_copy, rf.fli_lc, rf.fli_ss2)(grey))
        if rng.random() < 0.3:
            chunks.append(rf.fli_pstamp())
        return "x.flc", rf.fli_file(w, h, chunks, flc=bool(rng.random() < 0.5))
    if fmt == "spider":
        return "x.spi", rf.spider(grey.astype(np.float32) * 1.3 - 20, order=pick(">", "<"))
    if fmt == "mcidas":
        nbytes = pick(1, 2, 4)
        return "x.area", rf.mcidas(grey.astype(np.int64) * nbytes, nbytes,
                                   prefix_bytes=int(rng.integers(0, 5)))
    if fmt == "pixar":
        return "x.pxr", rf.pixar(rgb)
    if fmt == "imt":
        return "x.imt", rf.imt(grey)
    if fmt == "xv":
        return "x.xv", rf.xvthumb(grey)
    if rng.random() < 0.5:
        return "x.iim", rf.iptc(w, h, grey.tobytes(), chunk=int(rng.integers(1, 900)))
    return "x.iim", rf.iptc(w, h, grey.tobytes(), layers=pick(3, 4), component=1,
                            band=int(rng.integers(1, 4)))


def pillow_formats_sweep_one(i: int) -> tuple[int, str]:
    """Case ``i`` through Pillow and the port: "" where ``read_image``
    equals ``Image.open(p).convert("RGBA")`` (and a Sun raster's
    ``read_image_cv2`` OpenCV's ``imread``), or raises as Pillow raises;
    else what differed."""
    import tempfile

    import cv2
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets import image

    name, d = pillow_formats_sweep_case(i)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(d)
        try:
            ref = np.asarray(Image.open(path).convert("RGBA"))
        except Exception as e:  # noqa: BLE001  (the reading is the exception)
            ref = type(e)
        try:
            got = image.read_image(path)
        except Exception as e:  # noqa: BLE001
            got = type(e)
        if name.endswith(".ras"):
            cv = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
            ours = image.read_image_cv2(path)
            if not ((cv is None and ours is None) or (cv is not None and ours is not None
                                                      and cv.dtype == ours.dtype
                                                      and np.array_equal(cv, ours))):
                return i, f"{name}: OpenCV's reading differs"
    if isinstance(ref, type) or isinstance(got, type):
        same = isinstance(ref, type) and isinstance(got, type) and issubclass(got, (
            OSError if issubclass(ref, OSError) else ref))
        return i, "" if same else f"{name}: Pillow {ref}, the port {got}"
    return i, "" if np.array_equal(ref, got) else f"{name}: pixels differ"


def pillow_formats_sweep(n: int, start: int = 0, workers: int = 3) -> list[str]:
    """``--pillow-formats-sweep N [START]``: cases START .. START + N - 1 of
    ``pillow_formats_sweep_case`` held to Pillow's (and OpenCV's) reading;
    prints and returns what differed."""
    import multiprocessing

    bad = []
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for i, diff in pool.imap_unordered(pillow_formats_sweep_one, range(start, start + n)):
            if diff:
                bad.append(f"case {i}: {diff}")
                print(bad[-1], flush=True)
    print(f"{n} cases from {start}: {n - len(bad)} read as Pillow (and OpenCV) read them")
    return bad


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------


def make_fixtures() -> dict[str, bytes]:
    from PIL import Image

    def save(img, fmt, **kw):
        b = io.BytesIO()
        img.save(b, fmt, **kw)
        return b.getvalue()

    rgb = smooth(67, 91, 3, 1)
    rgba = np.concatenate([rgb, smooth(67, 91, 1, 2)], -1)
    pal = Image.fromarray(rgb).quantize(32, method=Image.Quantize.MEDIANCUT)
    idx = np.asarray(pal)
    palette = np.asarray(pal.getpalette()[: 3 * 32], np.uint8).reshape(-1, 3)
    return {
        "progressive.jpg": save(Image.fromarray(rgb), "JPEG", progressive=True),
        "interlaced.gif": save(pal, "GIF", interlace=True, transparency=5),
        "lzw.tif": save(Image.fromarray(rgb), "TIFF", compression="tiff_lzw"),
        "deflate.tif": save(Image.fromarray(rgba), "TIFF", compression="tiff_adobe_deflate"),
        "rle8.bmp": rle8_bmp(idx, palette),
        "rle.tga": save(Image.fromarray(rgba), "TGA", compression="tga_rle"),
    }


def pillow_rgba_sha(data: bytes) -> str:
    from PIL import Image

    rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return hashlib.sha256(rgba.tobytes()).hexdigest()


def digests(files: dict[str, bytes]) -> dict:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.image_fixtures import seeded_images

    decode = {name: pillow_rgba_sha(data) for name, data in sorted(files.items())}
    encode, encode_decode = {}, {}
    for name, img in seeded_images().items():
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG")
        encode[name] = hashlib.sha256(b.getvalue()).hexdigest()
        encode_decode[name] = pillow_rgba_sha(b.getvalue())
    return {"DECODE": decode, "JPEG_ENCODE": encode, "JPEG_ENCODE_DECODE": encode_decode}


def digest_module(d: dict) -> str:
    lines = ['"""SHA-256 digests of Pillow 12.1.0\'s readings of the fixtures beside this',
             "module and of its JPEG encodes (``save``, quality 75, 4:2:0) of",
             "``seeded_images()``; each decode is ``convert(\"RGBA\")``'s bytes. The WebP",
             "files' also as OpenCV 5.0.0 reads them (``WEBP_DECODE_CV2``: the bytes of",
             "``imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``). ``ENCODE``: the SHA-256",
             "of each encode fixture's bytes (Pillow's ``save`` of its source);",
             "``PLAIN_FILE`` / ``PLAIN_DECODE``: the plain formats' fixtures (QOI, SGI,",
             "PCX, DCX, IM, DDS) and Pillow's ``convert(\"RGBA\")`` of each;",
             "``ALPHA_WEBP_FILE``: the RGBA WebP fixtures' bytes. ``JPEG_VARIANT_FILE``:",
             "the JPEG variant fixtures' bytes; ``JPEG_VARIANT_DECODE`` /",
             "``JPEG_VARIANT_DECODE_CV2``: Pillow's and OpenCV's readings of each",
             "(``refused:`` and Pillow's words where Pillow raises, ``None`` where",
             "OpenCV reads nothing). ``ICON_FILE`` / ``ICON_DECODE``: the ICO, CUR,",
             "ICNS and PSD fixtures' bytes and Pillow's reading of each (``refused:``",
             "and Pillow's words, or the exception); ``ICON_ENCODE``: Pillow's ``save``",
             "of ``icon_sources()`` as ICO and ICNS. ``JPEG2000_FILE`` /",
             "``JPEG2000_DECODE`` / ``JPEG2000_DECODE_CV2``: the JPEG 2000 fixtures'",
             "bytes and Pillow's and OpenCV's readings of each (or the exception);",
             "``JPEG2000_ENCODE``: Pillow's ``save`` of ``jpeg2000_saver_sources()``",
             "under their names (JPEG 2000, EPS, PS, and PDF at ``PDF_CLOCK``).",
             "``AVIF_FILE`` / ``AVIF_DECODE`` / ``AVIF_DECODE_CV2``: the AVIF fixtures'",
             "bytes and Pillow's and OpenCV's readings of each (or the exception);",
             "``AVIF_ENCODE``: the port's own AVIF file of each of ``avif_write_sources()``",
             "(``avif.encode_avif``). Written by ``tests/torch_image_fixtures.py --write``",
             "(``--avif-encode`` rewrites ``AVIF_ENCODE`` alone; ``--avif-tools`` writes",
             "``AVIF_TOOL_FILES`` and adds their AVIF entries; ``--jpeg2000`` writes the",
             "JPEG 2000 fixtures and their three tables; ``--pillow-formats`` writes the",
             "files of Pillow's rarer formats and their tables). ``PILLOW_FORMAT_FILE`` /",
             "``PILLOW_FORMAT_DECODE`` / ``PILLOW_FORMAT_DECODE_CV2``: those files' bytes",
             "and Pillow's and OpenCV's (Sun rasters) readings, or the exception;",
             "``PCD_FILE`` / ``PCD_DECODE``: the same of the seeded PhotoCD files",
             "(``rare_formats.pcd_files()``). ``TIFF_FILE`` / ``TIFF_DECODE`` /",
             "``TIFF_DECODE_CV2``: the TIFF slice's files (``--tiff``) and Pillow's",
             "reading (or the exception) and OpenCV's (dtype, shape and SHA-256, or",
             '``None``) of each."""', ""]
    for key, table in d.items():
        lines.append(f"{key} = {{")
        lines += [f'    "{k}": "{v}",' for k, v in table.items()]
        lines.append("}")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    if "--tiff" in sys.argv:
        write_tiff_fixtures()
        sys.exit(0)
    if "--tiff-sweep" in sys.argv:
        k = sys.argv.index("--tiff-sweep")
        args = [int(a) for a in sys.argv[k + 1: k + 3]]
        sys.exit(1 if tiff_sweep(*args) else 0)
    if "--alph" in sys.argv:  # the port's ALPH chunks against libwebp's
        print("\n".join(alph_report(alph_cases())))
        sys.exit(0)
    if "--avif-encode" in sys.argv:
        rewrite_avif_encode_digests()
        sys.exit(0)
    if "--avif-tools" in sys.argv:
        add_avif_tool_fixtures()
        sys.exit(0)
    if "--jpeg2000" in sys.argv:
        write_jpeg2000_fixtures()
        sys.exit(0)
    if "--jpeg2000-sweep" in sys.argv:
        k = sys.argv.index("--jpeg2000-sweep")
        args = [int(v) for v in sys.argv[k + 1:k + 3]]
        sys.exit(1 if jpeg2000_sweep(*args) else 0)
    if "--jpeg2000-times" in sys.argv:
        jpeg2000_times()
        sys.exit(0)
    if "--pillow-formats" in sys.argv:
        write_pillow_format_fixtures()
        sys.exit(0)
    if "--pillow-formats-times" in sys.argv:
        pillow_formats_times()
        sys.exit(0)
    if "--pillow-formats-sweep" in sys.argv:
        k = sys.argv.index("--pillow-formats-sweep")
        args = [int(v) for v in sys.argv[k + 1:k + 3]]
        sys.exit(1 if pillow_formats_sweep(*args) else 0)
    if "--avif-sweep" in sys.argv:
        k = sys.argv.index("--avif-sweep")
        args = [int(v) for v in sys.argv[k + 1:k + 3]]
        sys.exit(1 if avif_sweep(*args) else 0)
    if "--avif-cv2" in sys.argv:
        add_avif_cv2_fixtures()
        sys.exit(0)
    if "--avif-cv2-sweep" in sys.argv:
        k = sys.argv.index("--avif-cv2-sweep")
        args = [int(v) for v in sys.argv[k + 1:k + 3]]
        sys.exit(1 if avif_cv2_sweep(*args) else 0)
    files = make_fixtures()
    webp_files = make_webp_fixtures()
    encode_files = make_encode_fixtures()
    plain_files = make_plain_fixtures()
    jpeg_files = make_jpeg_variant_fixtures()
    icon_files = make_icon_fixtures()
    j2k_files = make_jpeg2000_fixtures()
    avif_files = {**make_avif_fixtures(), **make_avif_tool_fixtures(), **make_avif_cv2_fixtures()}
    rare_files = make_pillow_format_fixtures()
    if "--write" in sys.argv:
        for name, data in {**files, **webp_files, **encode_files, **plain_files,
                           **jpeg_files, **icon_files, **j2k_files, **avif_files,
                           **rare_files}.items():
            with open(os.path.join(FIXTURES, name), "wb") as f:
                f.write(data)
        with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
            f.write(digest_module({**digests(files), **webp_digests(webp_files),
                                   **alpha_webp_digests(webp_files),
                                   **encode_digests(encode_files),
                                   **plain_digests(plain_files),
                                   **jpeg_variant_digests(jpeg_files),
                                   **icon_digests(icon_files),
                                   **jpeg2000_digests(j2k_files),
                                   **avif_digests(avif_files), **avif_encode_digests(),
                                   **pillow_format_digests(rare_files)}))
    for group in (files, webp_files, encode_files, plain_files, jpeg_files, icon_files, j2k_files,
                  avif_files, rare_files):
        print({k: len(v) for k, v in group.items()}, sum(map(len, group.values())))
