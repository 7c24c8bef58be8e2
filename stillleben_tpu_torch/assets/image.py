"""The port's own image codec: what its fixtures write, and nothing else.

``read_image`` decodes 8-bit non-interlaced RGB or RGBA PNG (zlib from the
standard library, the five scanline filters) and binary PPM (``P6``, maxval
255) into an (H, W, 4) uint8 array; ``write_png`` encodes one. Any other
format, bit depth, colour type or interlacing raises with its name: there
is no substitute image. numpy and the standard library only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {2: 3, 6: 4}  # PNG colour types: truecolour, with alpha
_COLOR_NAMES = {0: "greyscale", 3: "palette", 4: "greyscale with alpha"}


def _rgba(arr: np.ndarray) -> np.ndarray:
    if arr.shape[2] == 4:
        return np.ascontiguousarray(arr)
    return np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=2)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype == 1:
            # Sub is a running sum per channel, modulo 256
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 255
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 255
        else:
            raise ValueError(f"PNG: unknown scanline filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise NotImplementedError(f"{name}: PNG with {depth}-bit samples is not supported")
    if ctype not in _COLOR_CHANNELS:
        raise NotImplementedError(
            f"{name}: {_COLOR_NAMES.get(ctype, f'colour type {ctype}')} PNG is not supported"
        )
    if interlace:
        raise NotImplementedError(f"{name}: interlaced (Adam7) PNG is not supported")
    ch = _COLOR_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * ch + 1):
        raise ValueError(f"{name}: PNG data has {raw.size} bytes, expected {height * (width * ch + 1)}")
    return _rgba(_unfilter(raw, height, width * ch, ch).reshape(height, width, ch))


def decode_ppm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Binary PPM (``P6``), comments allowed in the header."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        while data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    if tokens[0] != b"P6":
        raise NotImplementedError(f"{name}: PNM type {tokens[0].decode()} is not supported (P6 only)")
    width, height, maxval = (int(t) for t in tokens[1:])
    if maxval != 255:
        raise NotImplementedError(f"{name}: PPM with maxval {maxval} is not supported")
    pix = np.frombuffer(data, np.uint8, count=width * height * 3, offset=pos + 1)
    return _rgba(pix.reshape(height, width, 3))


def read_image(path: str) -> np.ndarray:
    """(H, W, 4) uint8 from a PNG or binary PPM file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_MAGIC:
        return decode_png(data, path)
    if data[:1] == b"P" and data[1:2].isdigit():
        return decode_ppm(data, path)
    known = {b"\xff\xd8": "JPEG", b"BM": "BMP", b"GI": "GIF", b"II": "TIFF", b"MM": "TIFF",
             b"#?": "Radiance HDR"}
    fmt = known.get(data[:2], "unknown")
    raise NotImplementedError(f"{path}: {fmt} images are not supported (PNG and binary PPM only)")


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> an 8-bit non-interlaced PNG, filter None."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[2] not in (3, 4):
        raise ValueError("encode_png expects (H, W, 3|4) uint8")
    height, width, ch = pixels.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8), pixels.reshape(height, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2 if ch == 3 else 6, 0, 0, 0)
    return (PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))
