"""Writers of the image formats Pillow reads but neither Pillow's ``save`` nor
OpenCV writes (or writes only some kinds of): numpy and the standard
library only, so the card's host, which has no Pillow, can make the same
bytes from a seed.

Sun raster of every depth and type with palettes and its run-length
coding, MSP v2, BLP2 of DXT1/DXT3/DXT5 blocks (a plain block encoder) and
raw BGRA, FTEX, FITS (plain and gzip-compressed), FLI/FLC frames of each
chunk kind, GIMP brushes, SPIDER, McIdas, PIXAR, IM Tools, XV thumbnails,
IPTC records and Kodak PhotoCD. ``pillow_format_files()`` are the
committed fixtures made by these writers (``pcd_file(seed)`` is made at
run time, 786 KB); the tests' sweep draws their options from a seed.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

SUN_MAGIC = 0x59A66A95


def _planar_palette(palette: np.ndarray) -> bytes:
    p = np.asarray(palette, np.uint8).reshape(-1, 3)
    return p.T.tobytes()


def sun_rle(raw: bytes) -> bytes:
    """Sun's byte encoding: runs of 3 or more (and any 0x80) as
    ``0x80, n - 1, value``, a single 0x80 as ``0x80, 0``."""
    out = bytearray()
    a = np.frombuffer(raw, np.uint8)
    i, n = 0, len(a)
    while i < n:
        j = i + 1
        while j < n and a[j] == a[i] and j - i < 256:
            j += 1
        run, v = j - i, int(a[i])
        if run >= 3 or (v == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, v])
            i = j
        elif v == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out += bytes([v]) * run
            i = j
    return bytes(out)


def sun_raster(pixels: np.ndarray, depth: int, ftype: int = 1, palette: np.ndarray | None = None,
               rle: bool = False, maptype: int = 1) -> bytes:
    """A Sun raster: ``pixels`` are the stored values ((h, w) bits, nibbles
    or bytes at depths 1, 4, 8; (h, w, 3) RGB at 24 and 32, written BGR and
    XBGR, or RGB and XRGB for type 3); rows padded to 16 bits, or with
    ``rle`` (type 2) the unpadded rows run-length coded as one stream."""
    p = np.asarray(pixels, np.uint8)
    h, w = p.shape[:2]
    if depth == 1:
        rows = np.packbits(p.reshape(h, w) & 1, axis=1)
    elif depth == 4:
        q = np.zeros((h, w + (w & 1)), np.uint8)
        q[:, :w] = p & 15
        rows = (q[:, 0::2] << 4) | q[:, 1::2]
    elif depth == 8:
        rows = p.reshape(h, w)
    else:
        px = p if ftype == 3 else p[..., ::-1]
        if depth == 32:
            px = np.concatenate([np.zeros((h, w, 1), np.uint8), px], -1)
        rows = np.ascontiguousarray(px).reshape(h, -1)
    if rle:
        body = sun_rle(np.ascontiguousarray(rows).tobytes())
        ftype = 2
    else:
        stride = ((w * depth + 15) // 16) * 2
        padded = np.zeros((h, stride), np.uint8)
        padded[:, : rows.shape[1]] = rows
        body = padded.tobytes()
    pal = b"" if palette is None else _planar_palette(palette)
    head = struct.pack(">8I", SUN_MAGIC, w, h, depth, len(body), ftype, maptype if pal else 0,
                       len(pal))
    return head + pal + body


def _msp_rle_row(row: bytes) -> bytes:
    out = bytearray()
    a = np.frombuffer(row, np.uint8)
    i = 0
    while i < len(a):
        j = i + 1
        while j < len(a) and a[j] == a[i] and j - i < 255:
            j += 1
        if j - i >= 3:
            out += bytes([0, j - i, int(a[i])])
            i = j
            continue
        k = i
        while k < len(a) and k - i < 255 and not (k + 2 < len(a) and a[k] == a[k + 1] == a[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i]) + a[i:k].tobytes()
        i = k
    return bytes(out)


def msp_v2(bits: np.ndarray, blank_rows=()) -> bytes:
    """MSP version 2 (``LinS``) of (h, w) 0/1 pixels (1 white): the row map
    and run-length rows; ``blank_rows`` are written with length 0 (read as
    white)."""
    h, w = bits.shape
    rows = np.packbits(np.asarray(bits, np.uint8), axis=1)
    enc = [b"" if y in blank_rows else _msp_rle_row(rows[y].tobytes()) for y in range(h)]
    words = [0x694C, 0x536E, w, h, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    head = struct.pack("<16H", *words, check)
    return head + struct.pack(f"<{h}H", *(len(e) for e in enc)) + b"".join(enc)


def msp_v1(bits: np.ndarray) -> bytes:
    """MSP version 1 (``DanM``) of (h, w) 0/1 pixels (1 white), as Pillow's
    ``save`` writes it."""
    h, w = bits.shape
    words = [0x6144, 0x4D6E, w, h, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    return struct.pack("<16H", *words, check) + np.packbits(np.asarray(bits, np.uint8), 1).tobytes()


def xbm(bits: np.ndarray, name: bytes = b"im") -> bytes:
    """An X11 bitmap of (h, w) 0/1 pixels (1 white, as Pillow reads it)."""
    h, w = bits.shape
    data = np.packbits(np.asarray(bits, np.uint8), axis=1, bitorder="little").reshape(-1)
    body = b",".join(b"0x%02x" % v for v in data)
    return (b"#define %s_width %d\n#define %s_height %d\nstatic char %s_bits[] = {\n" % (
        name, w, name, h, name) + body + b"\n};\n")


def xpm(index: np.ndarray, palette: np.ndarray, chars: int = 1, transparent: int | None = None,
        pixels_comment: bool = True) -> bytes:
    """An X11 pixmap of (h, w) indices into (n, 3) ``palette``, ``chars``
    characters a key; ``transparent`` names an entry written as ``None``."""
    h, w = index.shape
    n = len(palette)
    alphabet = [bytes([c]) for c in range(35, 127) if c not in (34, 92)]
    keys = []
    for i in range(n):
        k, j = b"", i
        for _ in range(chars):
            k, j = k + alphabet[j % len(alphabet)], j // len(alphabet)
        keys.append(k)
    lines = [b"/* XPM */", b"static char *image[] = {", b"/* width height ncolors chars */",
             b'"%d %d %d %d",' % (w, h, n, chars)]
    for i, (k, c) in enumerate(zip(keys, np.asarray(palette, np.int64))):
        colour = b"None" if i == transparent else b"#%02x%02x%02x" % tuple(int(v) for v in c)
        lines.append(b'"%s c %s",' % (k, colour))
    if pixels_comment:
        lines.append(b"/* pixels */")
    rows = [b'"' + b"".join(keys[int(v)] for v in row) + b'"' for row in np.asarray(index)]
    lines.append(b",\n".join(rows))
    return b"\n".join(lines) + b"\n};\n"


def _565(rgb: np.ndarray) -> np.ndarray:
    c = rgb.astype(np.int64)
    return ((c[..., 0] >> 3) << 11) | ((c[..., 1] >> 2) << 5) | (c[..., 2] >> 3)


def dxt_blocks(rgba: np.ndarray, kind: int) -> bytes:
    """DXT1 (``kind`` 1), DXT3 (3) or DXT5 (5) blocks of (h, w, 4) pixels
    (the edges padded by repetition): each block's brightest and darkest
    pixels (by the sum of R, G, B; the first of equals) as endpoints, every
    pixel the nearest of the four colours (the first of equals); DXT3's
    alpha in 4 bits, DXT5's the nearest of the eight levels between the
    block's alpha extremes."""
    a = np.asarray(rgba, np.uint8)
    h, w = a.shape[:2]
    H, W = -(-h // 4) * 4, -(-w // 4) * 4
    a = np.pad(a, ((0, H - h), (0, W - w), (0, 0)), mode="edge").astype(np.int64)
    blk = a.reshape(H // 4, 4, W // 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    n = len(blk)
    luma = blk[..., :3].sum(-1)
    ends = np.take_along_axis(blk[..., :3], np.stack([luma.argmax(1), luma.argmin(1)], 1)[..., None],
                              1)
    c = _565(ends)
    c0, c1 = c.max(1), c.min(1)
    e = np.stack([np.stack([(v >> 11) << 3, ((v >> 5) & 63) << 2, (v & 31) << 3], -1)
                  for v in (c0, c1)], 1)
    pal = np.stack([e[:, 0], e[:, 1], (2 * e[:, 0] + e[:, 1]) // 3, (e[:, 0] + 2 * e[:, 1]) // 3], 1)
    idx = ((blk[:, :, None, :3] - pal[:, None]) ** 2).sum(-1).argmin(-1)
    idx[c0 == c1] = 0
    code = (idx << (2 * np.arange(16))).sum(1)
    colour = np.zeros((n, 8), np.uint8)
    colour[:, 0:2] = np.stack([c0 & 255, c0 >> 8], 1)
    colour[:, 2:4] = np.stack([c1 & 255, c1 >> 8], 1)
    colour[:, 4:8] = (code[:, None] >> (8 * np.arange(4))) & 255
    if kind == 1:
        return colour.tobytes()
    alpha = np.zeros((n, 8), np.uint8)
    if kind == 3:
        al = blk[..., 3] >> 4
        alpha[:] = al[:, 0::2] | (al[:, 1::2] << 4)
    else:
        a0, a1 = blk[..., 3].max(1), blk[..., 3].min(1)
        k = np.arange(1, 7)
        levels = np.concatenate([a0[:, None], a1[:, None],
                                 ((7 - k) * a0[:, None] + k * a1[:, None]) // 7], 1)
        ai = np.abs(blk[..., 3, None] - levels[:, None]).argmin(-1)
        ai[a0 == a1] = 0
        bits = (ai << (3 * np.arange(16))).sum(1)
        alpha[:, 0], alpha[:, 1] = a0, a1
        alpha[:, 2:] = (bits[:, None] >> (8 * np.arange(6))) & 255
    return np.concatenate([alpha, colour], 1).tobytes()


def blp2(width: int, height: int, encoding: int, body: bytes, *, alpha: int = 0,
         alpha_encoding: int = 0, palette: bytes = bytes(1024), compression: int = 1) -> bytes:
    """A BLP2 file: the 20-byte header, one mip level at offset 1172 (after
    the offset and length tables and the 256-entry BGRA palette)."""
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0,
                                 width, height)
    offset = 20 + 128 + 1024
    tables = struct.pack("<16I", offset, *[0] * 15) + struct.pack("<16I", len(body), *[0] * 15)
    return head + tables + palette[:1024].ljust(1024, b"\0") + body


def blp_dxt(rgba: np.ndarray, kind: int, alpha: bool = True) -> bytes:
    """BLP2 of DXT1, DXT3 or DXT5 blocks of (h, w, 4) pixels."""
    h, w = rgba.shape[:2]
    return blp2(w, h, 2, dxt_blocks(rgba, kind), alpha=int(alpha),
                alpha_encoding={1: 0, 3: 1, 5: 7}[kind])


def ftex(width: int, height: int, fmt: int, body: bytes) -> bytes:
    """FTEX with one format: DXT1 blocks (``fmt`` 0) or raw RGB (1)."""
    head = b"FTEX" + struct.pack("<5i", 0x10, width, height, 1, 1)
    where = len(head) + 8
    return head + struct.pack("<2i", fmt, where) + struct.pack("<i", len(body)) + body


def _card(text: str) -> bytes:
    return text.ljust(80).encode("ascii")


def fits(values: np.ndarray, bitpix: int, extra: tuple[str, ...] = ()) -> bytes:
    """A FITS primary image: (h, w) samples big-endian, rows as given
    (FITS stores the bottom row first)."""
    h, w = values.shape
    cards = [f"SIMPLE  = {'T':>20}", f"BITPIX  = {bitpix:>20}", f"NAXIS   = {2:>20}",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}", *extra, "END"]
    head = b"".join(_card(c) for c in cards)
    head = head.ljust(-(-len(head) // 2880) * 2880, b" ")
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    data = np.asarray(values).astype(dtype).tobytes()
    return head + data.ljust(-(-len(data) // 2880) * 2880, b"\0")


def fits_gzip(values: np.ndarray, bitpix: int) -> bytes:
    """A FITS file whose image is a gzip-compressed binary table
    (``ZIMAGE``, ``GZIP_1``), as Pillow's ``FitsGzipDecoder`` reads it:
    each sample in 4 bytes, big-endian, rows as given."""
    h, w = values.shape
    primary = b"".join(_card(c) for c in (f"SIMPLE  = {'T':>20}", f"BITPIX  = {8:>20}",
                                          f"NAXIS   = {0:>20}", "EXTEND  =                    T",
                                          "END"))
    primary = primary.ljust(2880, b" ")
    packed = gzip.compress(np.asarray(values).astype(">i4").tobytes(), mtime=0)
    cards = ["XTENSION= 'BINTABLE'", f"BITPIX  = {8:>20}", f"NAXIS   = {2:>20}",
             f"NAXIS1  = {8:>20}", f"NAXIS2  = {0:>20}", "ZIMAGE  =                    T",
             f"ZBITPIX = {bitpix:>20}", f"ZNAXIS  = {2:>20}", f"ZNAXIS1 = {w:>20}",
             f"ZNAXIS2 = {h:>20}", "ZCMPTYPE= 'GZIP_1  '", "END"]
    ext = b"".join(_card(c) for c in cards)
    ext = ext.ljust(-(-len(ext) // 2880) * 2880, b" ")
    return primary + ext + packed


def _fli_chunk(kind: int, body: bytes) -> bytes:
    if len(body) % 2:
        body += b"\0"
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_palette(palette: np.ndarray, colour64: bool = False) -> bytes:
    """A COLOR_256 (or COLOR_64, values / 4) chunk of 256 entries."""
    p = np.asarray(palette, np.uint8).reshape(256, 3)
    p = p >> 2 if colour64 else p
    return _fli_chunk(11 if colour64 else 4, struct.pack("<H", 1) + b"\x00\x00" + p.tobytes())


def fli_brun(index: np.ndarray) -> bytes:
    """BRUN: each row as runs (count, value) and literal packets."""
    body = bytearray()
    for row in np.asarray(index, np.uint8):
        body.append(0)
        x, w = 0, len(row)
        while x < w:
            j = x + 1
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 2:
                body += bytes([j - x, int(row[x])])
                x = j
                continue
            k = x + 1
            while k < w and k - x < 128 and not (k + 1 < w and row[k] == row[k + 1]):
                k += 1
            body += bytes([256 - (k - x)]) + row[x:k].tobytes()
            x = k
    return _fli_chunk(15, bytes(body))


def fli_copy(index: np.ndarray) -> bytes:
    return _fli_chunk(16, np.asarray(index, np.uint8).tobytes())


def fli_black() -> bytes:
    return _fli_chunk(13, bytes(4))  # 10 bytes: the decoder wants 10 before any chunk


def fli_pstamp() -> bytes:
    return _fli_chunk(18, struct.pack("<HHH", 1, 1, 1) + b"\0\0")


def fli_lc(index: np.ndarray, y0: int = 0) -> bytes:
    """LC (byte delta) of rows ``y0`` on: per row, skip 0 and literal
    packets of up to 100 bytes, and a run where 4 or more repeat."""
    rows = np.asarray(index, np.uint8)
    body = bytearray(struct.pack("<HH", y0, len(rows)))
    for row in rows:
        packets, x, w = bytearray(), 0, len(row)
        n = 0
        while x < w:
            j = x + 1
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 4:
                packets += bytes([0, 256 - (j - x), int(row[x])])
                x = j
            else:
                k = min(w, x + 100)
                packets += bytes([0, k - x]) + row[x:k].tobytes()
                x = k
            n += 1
        body += bytes([n]) + packets
    return _fli_chunk(12, bytes(body))


def fli_ss2(index: np.ndarray) -> bytes:
    """SS2 (word delta) of every row: a skip-line word for a row of zeros
    after the first, the last byte of an odd width by its flag word, and
    word packets (literal words, or runs of a repeated word)."""
    rows = np.asarray(index, np.uint8)
    h, w = rows.shape
    body, lines, y = bytearray(), 0, 0
    while y < h:
        skip = 0
        while 0 < y + skip < h - 1 and not rows[y + skip].any():
            skip += 1
        words = bytearray()
        if skip:
            words += struct.pack("<H", (65536 - skip) & 0xFFFF)
        y += skip
        row = rows[y]
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(row[-1]))
        pairs = row[: w - w % 2].reshape(-1, 2)
        packets, x = bytearray(), 0
        n = 0
        while x < len(pairs):
            j = x + 1
            while j < len(pairs) and (pairs[j] == pairs[x]).all() and j - x < 127:
                j += 1
            if j - x >= 2:
                packets += bytes([0, 256 - (j - x)]) + pairs[x].tobytes()
                x = j
            else:
                k = min(len(pairs), x + 100)
                packets += bytes([0, k - x]) + pairs[x:k].tobytes()
                x = k
            n += 1
        body += words + struct.pack("<H", n) + packets
        lines += 1
        y += 1
    return _fli_chunk(7, struct.pack("<H", lines) + bytes(body))


def fli_file(width: int, height: int, chunks: list[bytes], *, flc: bool = True,
             frames: int = 1, prefix: bytes = b"") -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file whose frame 0 holds ``chunks``;
    ``prefix`` is an 0xF100 prefix chunk's body, put before the frame."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 0, 0xAF12 if flc else 0xAF11, frames, width, height,
                     8, 0, 70)
    out = bytes(head)
    if prefix:
        out += struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    frame = b"".join(chunks)
    out += struct.pack("<IHH8x", 16 + len(frame), 0xF1FA, len(chunks)) + frame
    size = len(out)
    return out[:0] + struct.pack("<I", size) + out[4:]


def gbr(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush") -> bytes:
    """A GIMP brush: (h, w) L or (h, w, 4) RGBA; version 1 or 2 (``GIMP``
    magic and a spacing)."""
    p = np.asarray(pixels, np.uint8)
    h, w = p.shape[:2]
    depth = 1 if p.ndim == 2 else 4
    name = comment + b"\0"
    size = (20 if version == 1 else 28) + len(name)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + name + p.tobytes()


def spider(values: np.ndarray, order: str = ">") -> bytes:
    """A SPIDER 2-D image (``iform`` 1) of float32 in ``order``."""
    h, w = values.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float64)
    for i, v in ((1, 1.0), (2, h), (3, h), (5, 1.0), (12, w), (13, labrec), (22, labbyt),
                 (23, lenbyt)):
        hdr[i - 1] = v
    return hdr.astype(order + "f4").tobytes() + np.asarray(values, order + "f4").tobytes()


def mcidas(values: np.ndarray, nbytes: int = 1, prefix_bytes: int = 0) -> bytes:
    """A McIdas area file: (h, w) samples of ``nbytes`` (1, 2, 4),
    big-endian; ``prefix_bytes`` of line prefix before each row."""
    h, w = values.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13] = h, w, nbytes, 1
    words[14] = prefix_bytes
    words[33] = 256
    dtype = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    rows = np.asarray(values).astype(dtype).view(np.uint8).reshape(h, w * nbytes)
    rows = np.concatenate([np.full((h, prefix_bytes), 7, np.uint8), rows], 1)
    return struct.pack(">64i", *words) + rows.tobytes()


def pixar(rgb: np.ndarray) -> bytes:
    """A PIXAR raster: the 512-byte header (RGB: channels 14, depth 2),
    padding to 1024, the RGB rows."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HHHHHH", head, 416, h, w, 0, 0, 14, 2)
    return bytes(head) + np.asarray(rgb, np.uint8).tobytes()


def imt(grey: np.ndarray, comment: bytes = b"") -> bytes:
    """An IM Tools file: ``width``, ``height`` and ``pixel n8`` lines, a
    form feed, the rows."""
    h, w = grey.shape
    head = (b"*" + comment + b"\n" if comment else b"") + b"width %d\nheight %d\npixel n8\n\x0c" % (
        w, h)
    return head + np.asarray(grey, np.uint8).tobytes()


def xvthumb(index: np.ndarray,
            comments: tuple[bytes, ...] = (b"#XVVERSION:Version 2.28",)) -> bytes:
    """An XV thumbnail of (h, w) 3-3-2 indices."""
    h, w = index.shape
    head = b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"%d %d 255\n" % (w, h)
    return head + np.asarray(index, np.uint8).tobytes()


def iptc_field(record: int, dataset: int, data: bytes) -> bytes:
    n = len(data)
    if n < 0x8000:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", n) + data
    return bytes([0x1C, record, dataset, 0x80 | 4, 0]) + struct.pack(">I", n)[1:] + data


def iptc(width: int, height: int, body: bytes, *, compression: int = 1, layers: int = 1,
         component: int = 0, band: int | None = None, chunk: int = 8000) -> bytes:
    """An IPTC record: the image fields (3, 20/30/60/65/120), then the image
    data in object data fields (8, 10) of ``chunk`` bytes."""
    fields = [iptc_field(2, 0, b"\x00\x04"), iptc_field(3, 20, struct.pack(">H", width)),
              iptc_field(3, 30, struct.pack(">H", height)),
              iptc_field(3, 60, bytes([layers, component])),
              iptc_field(3, 120, bytes([compression]))]
    if band is not None:
        fields.append(iptc_field(3, 65, bytes([band])))
    parts = [body[i: i + chunk] for i in range(0, len(body), chunk)] or [b""]
    return b"".join(fields) + b"".join(iptc_field(8, 10, p) for p in parts)


PCD_OFFSET = 96 * 2048


def pcd_file(seed: int, orientation: int = 0, smooth: bool = True) -> bytes:
    """A Kodak PhotoCD base image from ``seed``: ``PCD_`` at 2048, the
    orientation byte, the 768x512 PhotoYCC chunks (smooth planes with
    noise, or uniform noise)."""
    rng = np.random.default_rng(seed)
    head = bytearray(PCD_OFFSET)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation & 3
    if smooth:
        yy, xx = np.mgrid[0:256, 0:2304]
        base = (128 + 90 * np.sin(xx / 97.0 + seed) * np.cos(yy / 41.0 - seed)).astype(np.int64)
        data = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255).astype(np.uint8)
    else:
        data = rng.integers(0, 256, (256, 2304), dtype=np.uint8)
    return bytes(head) + data.tobytes()


def integer_image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded uint8 (h, w, c) from integer arithmetic only (so every host's
    numpy makes the same bytes): diagonal ramps of seeded slopes, bands and
    a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for a, b, k in rng.integers(1, 9, (c, 3)):
        out.append((a * x + b * y + 40 * ((x // (8 * k) + y // 16) % 3)
                    + rng.integers(0, 6, (h, w))) % 256)
    return np.stack(out, -1).astype(np.uint8)


def pillow_format_files() -> dict[str, bytes]:
    """The committed fixtures these writers make, by name (the other
    committed files of these formats are Pillow's and OpenCV's own
    writes): Sun raster raw at depths 1, 4 (palette), 8 (grey and
    palette), 24 (type 1 and type 3) and 32, run-length at 8 and 24; BLP2 of
    DXT1 (with and without alpha), DXT3, DXT5 at an odd size, and raw BGRA
    (which Pillow refuses); FTEX of DXT1 and raw RGB; MSP v2 with blank
    rows; XPM of 1 and 2 characters a pixel (over 256 colours: RGB);
    GIMP brushes v1 (L) and v2 (RGBA); FITS at BITPIX 8, 16, 32, -32, -64
    and gzip-compressed; FLI and FLC frames of BRUN, COPY, LC, SS2 and
    BLACK with COLOR_64 and COLOR_256 palettes; SPIDER in both byte orders;
    McIdas of 1, 2 and 4 bytes a pixel; PIXAR; IM Tools; an XV thumbnail;
    IPTC records of raw data in several fields and of one band of an RGB
    image."""
    img = integer_image
    rgba = img(29, 37, 4, 1)
    rgb = rgba[..., :3]
    grey = rgba[..., 0]
    bits = (grey > 127).astype(np.uint8)
    idx = (grey // 16).astype(np.uint8)
    pal16 = img(16, 1, 3, 2)[:, 0]
    pal256 = img(256, 1, 3, 3)[:, 0]
    out = {
        "bits1.ras": sun_raster(bits, 1),
        "palette4.ras": sun_raster(idx, 4, palette=pal16),
        "grey8.ras": sun_raster(grey, 8),
        "palette8.ras": sun_raster(grey, 8, palette=pal256),
        "bgr24.ras": sun_raster(rgb, 24),
        "rgb24_type3.ras": sun_raster(rgb, 24, ftype=3),
        "xbgr32.ras": sun_raster(rgb, 32),
        "rle8.ras": sun_raster((grey // 32) * 32, 8, palette=pal256, rle=True),
        "rle24.ras": sun_raster((rgb // 64) * 64, 24, rle=True),
        "dxt1.blp": blp_dxt(rgba, 1, alpha=False),
        "dxt1_alpha.blp": blp_dxt(rgba, 1),
        "dxt3.blp": blp_dxt(rgba, 3),
        "dxt5.blp": blp_dxt(rgba, 5),
        "bgra.blp": blp2(37, 29, 3, rgba.tobytes(), alpha=1),
        "dxt1.ftc": ftex(37, 29, 0, dxt_blocks(rgba, 1)),
        "rgb.ftu": ftex(37, 29, 1, rgb.tobytes()),
        "lins.msp": msp_v2(bits, blank_rows=(3, 4)),
        "palette.xpm": xpm(idx, pal16),
        "rgb.xpm": xpm((grey.astype(np.int64) * 300 // 256), img(300, 1, 3, 4)[:, 0], chars=2),
        "brush_v1.gbr": gbr(grey, version=1),
        "brush_rgba.gbr": gbr(rgba),
        "int8.fits": fits(grey, 8),
        "int16.fits": fits(grey.astype(np.int64) * 3 - 100, 16),
        "int32.fits": fits(grey.astype(np.int64) - 60, 32),
        "float32.fits": fits(grey / 0.9 - 20.0, -32),
        "float64.fits": fits(grey / 0.9 - 20.0, -64),
        "gzip.fits": fits_gzip(grey.astype(np.int64), 8),
        "brun.flc": fli_file(37, 29, [fli_palette(pal256), fli_brun(grey // 8 * 8)]),
        "copy.fli": fli_file(37, 29, [fli_palette(pal256, colour64=True), fli_copy(grey)],
                             flc=False),
        "lc.fli": fli_file(37, 29, [fli_palette(pal256, colour64=True), fli_lc(grey // 64 * 64)],
                           flc=False),
        "ss2.flc": fli_file(37, 29, [fli_palette(pal256), fli_black(), fli_ss2(grey // 64 * 64),
                                     fli_pstamp()]),
        "float_be.spi": spider(grey.astype(np.float32) * 1.5 - 30),
        "float_le.spi": spider(grey.astype(np.float32) * 0.7, order="<"),
        "area1.mcidas": mcidas(grey, 1, prefix_bytes=4),
        "area2.mcidas": mcidas(grey.astype(np.int64) * 2, 2),
        "area4.mcidas": mcidas(grey.astype(np.int64) - 50, 4),
        "frame.pxr": pixar(rgb),
        "frame.imt": imt(grey, comment=b"IM Tools"),
        "thumb.xv": xvthumb(grey),
        "raw.iim": iptc(37, 29, grey.tobytes(), chunk=500),
        "band.iim": iptc(37, 29, grey.tobytes(), layers=3, component=1, band=2),
    }
    return out


PCD_SEEDS = {"base.pcd": (5, 0), "turned.pcd": (6, 1), "noise.pcd": (7, 3)}


def pcd_files() -> dict[str, bytes]:
    """PhotoCD files from seeds (786 KB each, so made, not committed): a
    smooth base image, the same turned (orientation 1) and uniform PhotoYCC
    noise turned the other way (orientation 3)."""
    return {n: pcd_file(seed, orientation, smooth=n != "noise.pcd")
            for n, (seed, orientation) in PCD_SEEDS.items()}


def timing_files() -> dict[str, bytes]:
    """One 640x480 file per format the phase's timings read, by format."""
    rgba = integer_image(480, 640, 4, 40)
    rgb, grey = rgba[..., :3], rgba[..., 0]
    bits = (grey > 127).astype(np.uint8)
    return {"BLP (DXT5)": blp_dxt(rgba, 5), "BLP (palette)": blp2(640, 480, 1, grey.tobytes()),
            "FTEX (DXT1)": ftex(640, 480, 0, dxt_blocks(rgba, 1)),
            "Sun (raw 24)": sun_raster(rgb, 24), "Sun (RLE 8)": sun_raster(grey // 64 * 64, 8,
                                                                           rle=True),
            "XBM": xbm(bits), "XPM": xpm(grey // 16, integer_image(16, 1, 3, 41)[:, 0]),
            "MSP (v1)": msp_v1(bits), "MSP (v2)": msp_v2(bits), "GBR": gbr(rgba),
            "FITS": fits(grey, 16), "FLI (BRUN)": fli_file(640, 480, [fli_brun(grey // 64)]),
            "SPIDER": spider(grey.astype(np.float32)), "McIdas": mcidas(grey, 2),
            "PIXAR": pixar(rgb), "IMT": imt(grey), "XV thumbnail": xvthumb(grey),
            "IPTC": iptc(640, 480, grey.tobytes())}
