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

``vp8_divergence`` names the first stage at which two lossy WebP files
part (the divergence finder of the port's encoder), ``vp8l_divergence``
(and ``alph_divergence`` for two files' ALPH chunks) the first part of two
VP8L streams (``vp8l_parse``); ``libwebp_alpha_stream`` is libwebp's own
stream of an alpha plane, the oracle; ``--alph`` prints the port's ALPH
chunks against libwebp's.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "stillleben_tpu_torch", "assets", "image_fixtures")


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


def tiff(samples: np.ndarray, photometric: int, *, endian: str = "<", tile=None, rows: int = 0,
         compression: int = 1, predictor: int = 1, extra=(), colormap=None, bits: int = 0) -> bytes:
    """A TIFF of (h, w, spp) uint8/uint16 samples (or sub-byte grey with
    ``bits``): strips of ``rows`` rows or tiles of ``tile`` = (w, h),
    uncompressed, Deflate (8) or PackBits (32773), with the horizontal
    predictor."""
    h, w, spp = samples.shape
    bits = bits or samples.dtype.itemsize * 8
    dt = np.dtype(endian + ("u2" if bits == 16 else "u1"))
    cw, ch = tile or (w, rows or h)
    chunks = []
    for ty in range(0, h, ch):
        for tx in range(0, w if tile else 1, cw if tile else 1):
            part = np.zeros((ch, cw, spp), np.int64)
            src = samples[ty: ty + ch, tx: tx + cw].astype(np.int64)
            part[: src.shape[0], : src.shape[1]] = src
            if not tile:
                part = part[: src.shape[0]]
            if predictor == 2:
                part[:, 1:] = (part[:, 1:] - part[:, :-1]) & ((1 << bits) - 1)
            if bits < 8:
                per = 8 // bits
                v = part[..., 0]
                v = np.concatenate([v, np.zeros((v.shape[0], (-v.shape[1]) % per), np.int64)], 1)
                v = v.reshape(v.shape[0], -1, per)
                raw = (v << (bits * np.arange(per - 1, -1, -1))).sum(-1).astype(np.uint8).tobytes()
            else:
                raw = part.astype(dt).tobytes()
            if compression == 8:
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = packbits(raw, len(raw) // part.shape[0])
            chunks.append(raw)
    e = endian
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [spp])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap, np.uint16).reshape(-1))))
    if extra:
        entries.append((338, 3, list(extra)))
    if tile:
        entries += [(322, 4, [cw]), (323, 4, [ch]), (324, 4, None),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, None), (278, 4, [ch]), (279, 4, [len(c) for c in chunks])]
    entries.sort(key=lambda t: t[0])
    n = len(entries)
    head = (b"II*\x00" if e == "<" else b"MM\x00*") + struct.pack(e + "I", 8)
    at = 8 + 2 + 12 * n + 4
    blobs, offsets_tag = bytearray(), None
    fmt = {3: "H", 4: "I"}
    ifd = struct.pack(e + "H", n)
    # lay out: IFD, the out-of-line values, then the chunks
    values = []
    for tag, typ, vals in entries:
        if vals is None:
            vals = [0] * len(chunks)
            offsets_tag = len(values)
        values.append((tag, typ, vals))
    sizes = [len(v) * (2 if t == 3 else 4) for _, t, v in values]
    out_of_line = sum(s for s in sizes if s > 4)
    data_at = at + out_of_line
    pos, offs = data_at, []
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    values[offsets_tag] = (values[offsets_tag][0], 4, offs)
    for (tag, typ, vals), size in zip(values, sizes):
        packed = struct.pack(f"{e}{len(vals)}{fmt[typ]}", *vals)
        if size > 4:
            ifd += struct.pack(e + "HHII", tag, typ, len(vals), at + len(blobs))
            blobs += packed
        else:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
    ifd += b"\0\0\0\0"
    return head + ifd + bytes(blobs) + b"".join(chunks)


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
             "OpenCV reads nothing). Written by",
             '``tests/torch_image_fixtures.py --write``."""', ""]
    for key, table in d.items():
        lines.append(f"{key} = {{")
        lines += [f'    "{k}": "{v}",' for k, v in table.items()]
        lines.append("}")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    if "--alph" in sys.argv:  # the port's ALPH chunks against libwebp's
        print("\n".join(alph_report(alph_cases())))
        sys.exit(0)
    files = make_fixtures()
    webp_files = make_webp_fixtures()
    encode_files = make_encode_fixtures()
    plain_files = make_plain_fixtures()
    jpeg_files = make_jpeg_variant_fixtures()
    if "--write" in sys.argv:
        for name, data in {**files, **webp_files, **encode_files, **plain_files,
                           **jpeg_files}.items():
            with open(os.path.join(FIXTURES, name), "wb") as f:
                f.write(data)
        with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
            f.write(digest_module({**digests(files), **webp_digests(webp_files),
                                   **alpha_webp_digests(webp_files),
                                   **encode_digests(encode_files),
                                   **plain_digests(plain_files),
                                   **jpeg_variant_digests(jpeg_files)}))
    for group in (files, webp_files, encode_files, plain_files, jpeg_files):
        print({k: len(v) for k, v in group.items()}, sum(map(len, group.values())))
