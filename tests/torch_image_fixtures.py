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

``vp8_divergence`` names the first stage at which two lossy WebP files
part (the divergence finder of the port's encoder); ``--alph`` prints the
port's ALPH chunks against libwebp's (ROADMAP C-19).
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


def alph_report(cases: dict[str, np.ndarray]) -> list[str]:
    """For each RGBA array: the port's ALPH chunk against the one Pillow's
    ``save`` writes (libwebp), as one line: header bytes, sizes and their
    ratio, whether equal, the first byte at which they part, and each
    stream's transforms."""
    sys.path.insert(0, ROOT)
    from stillleben_tpu_torch.assets.webp import encode_webp

    lines = []
    for name, a in cases.items():
        ours = dict(webp_chunks(encode_webp(a)))[b"ALPH"]
        ref = dict(webp_chunks(webp_save(a)))[b"ALPH"]
        part = next((i for i, (x, y) in enumerate(zip(ours, ref)) if x != y), min(len(ours), len(ref)))
        tf = [vp8l_transforms(c[1:]) if c[0] & 3 else ["raw"] for c in (ours, ref)]
        lines.append(f"{name}: header {ours[0]:#04x} / libwebp {ref[0]:#04x}; {len(ours)} / "
                     f"{len(ref)} bytes (ratio {len(ours) / len(ref):.4f}); "
                     + ("bitwise equal" if ours == ref else f"part at byte {part}")
                     + f"; transforms {tf[0]} / libwebp {tf[1]}")
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
    }


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
             "``imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``). Written by",
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
    if "--write" in sys.argv:
        for name, data in {**files, **webp_files}.items():
            with open(os.path.join(FIXTURES, name), "wb") as f:
                f.write(data)
        with open(os.path.join(FIXTURES, "digests.py"), "w") as f:
            f.write(digest_module({**digests(files), **webp_digests(webp_files)}))
    for group in (files, webp_files):
        print({k: len(v) for k, v in group.items()}, sum(map(len, group.values())))
