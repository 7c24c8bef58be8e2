"""Apple icons (``.icns``): written as Pillow 12.1.0's ``save`` writes them,
read as ``Image.open(p).convert("RGBA")`` reads them.

Writing (``encode_icns``, Pillow's ``IcnsImagePlugin._save``): the image
resized (BICUBIC, ``resize``'s default; ``resample.resize``) to 32, 64,
128, 256, 512 and 1024 squared, each stored as a PNG
(``image.encode_png``), under eight types: ``ic07`` 128, ``ic08`` 256,
``ic09`` 512, ``ic10`` 1024, ``ic11`` 32, ``ic12`` 64, ``ic13`` 256,
``ic14`` 512. The file is the header, a ``TOC `` block listing the eight
types and their lengths, then the eight blocks.

Reading (``decode_icns``, Pillow's ``IcnsFile``): the blocks by type (a
later block of a type replaces an earlier one), the largest (size,
scale) that any of its types gives, and every reader of that size run in
Pillow's order: a PNG entry is the PNG as Pillow holds it, without its
``tRNS`` (Pillow copies the PNG's pixels, not its transparency); the
run-length ``is32``/``il32``/``ih32``/``it32`` planes (R, G, B one after
another; a byte with the high bit set repeats the next byte ``n - 125``
times, else ``n + 1`` bytes follow; ``it32`` after four zero bytes; a
block of exactly 3 x w x h bytes is raw RGB) take their
``s8mk``/``l8mk``/``h8mk``/``t8mk`` mask as alpha. A PNG entry wins over
the planes of its size. A JPEG 2000 entry (a codestream or JP2) is read
as Pillow reads it, ``convert("RGBA")`` (``jpeg2000.decode_jpeg2000``),
at the entry's own size (which, as for a PNG entry, some size of the
file scaled by a whole factor must give: Pillow's ``ValueError``
otherwise); one the port does not decode (of another shape,
or damaged) raises ``NotImplementedError`` naming JPEG 2000 (ROADMAP.md,
the reading queue); other
entries raise Pillow's ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from . import resample
from .jpeg2000 import JP2_MAGIC, decode_jpeg2000

MAGIC = b"icns"
HEADERSIZE = 8
# the types Pillow's save writes, in its order, and their sizes
SAVE_TYPES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512), (b"ic10", 1024),
              (b"ic11", 32), (b"ic12", 64), (b"ic13", 256), (b"ic14", 512))
_PNG, _RLE, _RLE_T, _MASK = "png", "rle", "rle32t", "mask"
# (size, size, scale) -> its types and readers, in Pillow's order
SIZES = {
    (512, 512, 2): ((b"ic10", _PNG),),
    (512, 512, 1): ((b"ic09", _PNG),),
    (256, 256, 2): ((b"ic14", _PNG),),
    (256, 256, 1): ((b"ic08", _PNG),),
    (128, 128, 2): ((b"ic13", _PNG),),
    (128, 128, 1): ((b"ic07", _PNG), (b"it32", _RLE_T), (b"t8mk", _MASK)),
    (64, 64, 1): ((b"icp6", _PNG),),
    (32, 32, 2): ((b"ic12", _PNG),),
    (48, 48, 1): ((b"ih32", _RLE), (b"h8mk", _MASK)),
    (32, 32, 1): ((b"icp5", _PNG), (b"il32", _RLE), (b"l8mk", _MASK)),
    (16, 16, 2): ((b"ic11", _PNG),),
    (16, 16, 1): ((b"icp4", _PNG), (b"is32", _RLE), (b"s8mk", _MASK)),
}
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def encode_icns(pixels: np.ndarray) -> bytes:
    """The ICNS Pillow's ``save`` writes for uint8 (H, W) L, (H, W, 3) RGB,
    (H, W, 4) RGBA or uint16 (H, W) I;16."""
    from .image import encode_png

    a = np.asarray(pixels)
    streams = {s: encode_png(resample.resize(a, (s, s), resample.BICUBIC))
               for s in sorted({s for _, s in SAVE_TYPES})}
    entries = [(kind, HEADERSIZE + len(streams[s]), streams[s]) for kind, s in SAVE_TYPES]
    length = HEADERSIZE + HEADERSIZE + 8 * len(entries) + sum(n for _, n, _ in entries)
    out = [MAGIC, struct.pack(">i", length), b"TOC ",
           struct.pack(">i", HEADERSIZE + len(entries) * HEADERSIZE)]
    out += [kind + struct.pack(">i", n) for kind, n, _ in entries]
    out += [kind + struct.pack(">i", n) + body for kind, n, body in entries]
    return b"".join(out)


def blocks(data: bytes, name: str = "<bytes>") -> dict:
    """type -> (start, length) of each block's body, as ``IcnsFile`` reads
    the file's list of blocks."""
    if len(data) < HEADERSIZE or not data.startswith(MAGIC):
        raise OSError(f"cannot identify image file {name!r}")
    filesize = struct.unpack_from(">I", data, 4)[0]
    dct, i = {}, HEADERSIZE
    while i < filesize:
        if i + HEADERSIZE > len(data):
            raise OSError(f"cannot identify image file {name!r}")
        sig, blocksize = struct.unpack_from(">4sI", data, i)
        if blocksize < HEADERSIZE:  # Pillow: "invalid block header" (or a loop)
            raise OSError(f"cannot identify image file {name!r}")
        i += HEADERSIZE
        dct[sig] = (i, blocksize - HEADERSIZE)
        i += blocksize - HEADERSIZE
    return dct


def best_size(dct: dict, name: str = "<bytes>") -> tuple[int, int, int]:
    sizes = [size for size, kinds in SIZES.items() if any(k in dct for k, _ in kinds)]
    if not sizes:
        raise OSError(f"cannot identify image file {name!r}")
    return max(sizes)


def _planes(data: bytes, start: int, length: int, w: int, h: int) -> np.ndarray:
    """Pillow's ``read_32``: (h, w, 3) uint8."""
    n = w * h
    if length == n * 3:
        return np.frombuffer(data, np.uint8, count=length, offset=start).reshape(h, w, 3).copy()
    out = np.empty((h, w, 3), np.uint8)
    pos = start
    for band in range(3):
        parts, left = [], n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                parts.append(data[pos: pos + 1] * count)
                pos += 1
            else:
                count = b + 1
                parts.append(data[pos: pos + count])
                pos += count
            left -= count
        if left != 0:
            raise SyntaxError(f"Error reading channel [{left!r} left]")
        plane = b"".join(parts)
        if len(plane) < n:
            raise ValueError("buffer is not large enough")
        out[..., band] = np.frombuffer(plane, np.uint8, count=n).reshape(h, w)
    return out


def _read(data: bytes, reader: str, start: int, length: int, w: int, h: int, name: str) -> dict:
    from .image import PNG_MAGIC, _pil_rgba, decode_png_samples

    if reader == _PNG:
        sig = data[start: start + 12]
        if sig.startswith(PNG_MAGIC):  # Pillow takes its pixels and palette, not its tRNS
            return {"RGBA": _pil_rgba(decode_png_samples(data[start:], name)._replace(trns=None))}
        if sig.startswith(_J2K) or sig == JP2_MAGIC:
            try:
                return {"RGBA": decode_jpeg2000(data[start: start + length], name)}
            except Exception as e:
                raise NotImplementedError(f"{name}: an ICNS entry in JPEG 2000 the port does not "
                                          f"read ({e})") from e
        raise ValueError("Unsupported icon subimage format")
    if reader == _RLE_T:
        if data[start: start + 4] != b"\0\0\0\0":
            raise SyntaxError("Unknown signature, expecting 0x00000000")
        return {"RGB": _planes(data, start + 4, length - 4, w, h)}
    if reader == _RLE:
        return {"RGB": _planes(data, start, length, w, h)}
    if start + w * h > len(data):
        raise ValueError("buffer is not large enough")
    return {"A": np.frombuffer(data, np.uint8, count=w * h, offset=start).reshape(h, w)}


def _check_size(dct: dict, w: int, h: int) -> None:
    """Pillow's ``IcnsImageFile.size`` setter, run on the loaded entry's
    size: some size of the file, scaled by a whole factor, must give it."""
    for (sw, sh, scale), kinds in SIZES.items():
        if any(k in dct for k, _ in kinds) and (sh * scale) / h == (sw * scale) // w:
            return
    raise ValueError("This is not one of the allowed sizes of this image")


def decode_icns(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``Image.open(p).convert("RGBA")``."""
    dct = blocks(data, name)
    size = best_size(dct, name)
    w, h = size[0] * size[2], size[1] * size[2]
    channels = {}
    for kind, reader in SIZES[size]:
        if kind in dct:
            channels.update(_read(data, reader, *dct[kind], w, h, name))
    if "RGBA" in channels:
        rgba = channels["RGBA"]
        _check_size(dct, rgba.shape[1], rgba.shape[0])
        return rgba
    rgb = channels["RGB"]
    out = np.empty(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = channels.get("A", 255)
    return out
