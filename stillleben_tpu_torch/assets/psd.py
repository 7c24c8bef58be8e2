"""Photoshop documents (``.psd``) read as Pillow 12.1.0's
``Image.open(p).convert("RGBA")`` reads them: the composite image after
the layers, never a layer.

Pillow's ``PsdImageFile`` (``MODES``): bitmap (1 bit a pixel, a set bit
white, as Pillow's raw "1"), grey, duotone and multichannel (the first
channel, as L), indexed (a colour-mode block of exactly 768 bytes is the
palette, 256 reds then greens then blues; otherwise no palette, and every
index black), RGB (and with exactly four channels RGBA), CMYK
(stored inverted; Pillow's CMYK to RGB: ``255 - k - c * (255 - k) / 255``
rounded as its ``MULDIV255``). Data raw (channel after channel) or
PackBits (a table of 2-byte row lengths for as many channels as Pillow
uses, then the rows; Pillow's decoder drops what a run puts past a row's
end). The image resources and the layer block are skipped as Pillow
skips them.

Refusals as Pillow's: a mode or depth outside ``MODES`` (16 and 32 bits
among them) is not identified (``OSError("cannot identify image
file")``); fewer channels than the mode needs ``OSError("not enough
channels")``; a file that ends inside its header or row-length table is
not identified either; ZIP data has no decoder (``OSError("cannot load
this image")``); pixel data that ends early ``OSError("image file is
truncated")``.
LAB, which Pillow converts to RGBA through LittleCMS, raises
``NotImplementedError`` (ROADMAP.md's reading queue).
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"8BPS"
# (Photoshop mode, bits) -> (Pillow's mode, the channels it reads)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


def _u16(d: bytes, p: int) -> int:
    return struct.unpack_from(">H", d, p)[0]


def _unidentified(name: str) -> OSError:
    return OSError(f"cannot identify image file {name!r}")


def _u32(d: bytes, p: int, name: str) -> int:
    """A length of the header's sections: where the file ends first,
    Pillow's ``_open`` fails in a way ``Image.open`` catches."""
    if p + 4 > len(d):
        raise _unidentified(name)
    return struct.unpack_from(">I", d, p)[0]


def packbits_rows(data: bytes, pos: int, rows: int, row_bytes: int) -> np.ndarray:
    """Pillow's PackBits decoder from ``pos``: ``rows`` rows of
    ``row_bytes``; a run or literal that crosses a row's end loses its
    excess; 0x80 is skipped."""
    out = bytearray(rows * row_bytes)
    y = x = 0
    n = len(data)
    while y < rows:
        if pos >= n:
            raise OSError("image file is truncated")
        b = data[pos]
        if b == 0x80:
            pos += 1
            continue
        if b & 0x80:
            if pos + 2 > n:
                raise OSError("image file is truncated")
            count = min(257 - b, row_bytes - x)
            base = y * row_bytes + x
            out[base: base + count] = data[pos + 1: pos + 2] * count
            pos += 2
        else:
            if pos + b + 2 > n:
                raise OSError("image file is truncated")
            count = min(b + 1, row_bytes - x)
            base = y * row_bytes + x
            out[base: base + count] = data[pos + 1: pos + 1 + count]
            pos += b + 2
        x += count
        if x >= row_bytes:
            x, y = 0, y + 1
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, row_bytes)


def _header(data: bytes, name: str):
    if len(data) < 26 or not data.startswith(MAGIC) or _u16(data, 4) != 1:
        raise _unidentified(name)
    channels, height, width, bits, psd_mode = struct.unpack_from(">HIIHH", data, 12)
    if (psd_mode, bits) not in MODES:  # Pillow's KeyError, caught by Image.open
        raise _unidentified(name)
    mode, used = MODES[(psd_mode, bits)]
    if mode == "LAB":
        raise NotImplementedError(f"{name}: a LAB PSD is not supported (Pillow converts LAB to "
                                  "RGBA through LittleCMS, which the port does not carry)")
    if used > channels:
        raise OSError("not enough channels")
    if mode == "RGB" and channels == 4:
        mode, used = "RGBA", 4
    return mode, used, width, height


def decode_psd(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``Image.open(p).convert("RGBA")``."""
    from .image_limits import check_size
    from .native_image import cmyk_convert

    mode, used, width, height = _header(data, name)
    pos = 26
    size = _u32(data, pos, name)
    palette = None
    if size and mode == "P" and size == 768 and pos + 4 + 768 <= len(data):
        palette = np.frombuffer(data, np.uint8, count=768, offset=pos + 4).reshape(3, 256).T
    pos += 4 + size
    size = _u32(data, pos, name)  # image resources, walked as Pillow walks them
    pos += 4
    end = pos + size
    while size and pos < end:
        if pos + 6 >= len(data):
            raise _unidentified(name)
        n = data[pos + 6]
        pos += 7 + n + (0 if n & 1 else 1)
        length = _u32(data, pos, name)
        pos += 4 + length + (length & 1)
    size = _u32(data, pos, name)  # layer and mask information
    pos += 4 + size
    check_size(width, height, name, "PSD")
    if pos + 2 > len(data):
        raise _unidentified(name)
    compression = _u16(data, pos)
    pos += 2
    row = (width + 7) // 8 if mode == "1" else width
    if compression == 0:
        need = row * height
        planes = []
        for c in range(used):
            at = pos + c * width * height
            if at + need > len(data):
                raise OSError("image file is truncated")
            planes.append(np.frombuffer(data, np.uint8, count=need, offset=at).reshape(height, row))
    elif compression == 1:
        table = pos
        pos += used * height * 2
        if pos > len(data):  # Pillow reads the row lengths in _open
            raise _unidentified(name)
        planes = []
        for c in range(used):
            planes.append(packbits_rows(data, pos, height, row))
            counts = np.frombuffer(data, ">u2", count=height, offset=table + 2 * c * height)
            pos += int(counts.sum(dtype=np.int64))
    else:
        raise OSError("cannot load this image")

    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if mode == "1":
        bits = np.unpackbits(planes[0], axis=1)[:, :width]
        out[..., :3] = (bits * 255)[..., None]
    elif mode == "L":
        out[..., :3] = planes[0][..., None]
    elif mode == "P":
        pal = palette if palette is not None else np.zeros((256, 3), np.uint8)
        out[..., :3] = pal[planes[0]]
    elif mode in ("RGB", "RGBA"):
        for c in range(used):
            out[..., c] = planes[c]
    else:  # CMYK, stored as Pillow's "CMYK;I"
        out = cmyk_convert(np.stack(planes, -1), opencv=False)
    return out
