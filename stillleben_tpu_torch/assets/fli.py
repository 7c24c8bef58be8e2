"""Autodesk FLI/FLC animation (``.fli .flc``), frame 0 read as Pillow reads
it (``FliImagePlugin``).

The 128-byte header (its reserved bytes zero), the palette from the first
frame's first COLOR_256 (chunk 4) or COLOR_64 (chunk 11, values shifted
left by 2 and kept to 8 bits) chunk over a grey ramp, a prefix chunk
skipped in that search; then frame 0 at byte 128 through Pillow's C
decoder (native ``sl_fli_decode``, FliDecode.c: BRUN, COPY, BLACK, LC, SS2,
the palette and PSTAMP chunks skipped) on a black image, fed as
``ImageFile.load`` feeds it: reads of the frame's size, the decoder
called on what has been read so far. Pillow's failures are kept: a header
it does not take falls through (``NotThisFormat``), a frame that ends
early raises "image file is truncated", a damaged chunk the decoder's
``OSError``.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size
from .pillow_open import NotThisFormat, codec_error, to_rgba, truncated


def _i16(d: bytes, pos: int) -> int:
    if len(d) < pos + 2:
        raise NotThisFormat("unpack_from requires a buffer of at least 2 bytes")
    return struct.unpack_from("<H", d, pos)[0]


def _i32(d: bytes, pos: int) -> int:
    if len(d) < pos + 4:
        raise NotThisFormat("unpack_from requires a buffer of at least 4 bytes")
    return struct.unpack_from("<I", d, pos)[0]


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 16 and struct.unpack_from("<H", prefix, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", prefix, 14)[0] in (0, 3))


def _palette(data: bytes, pos: int, shift: int, palette: np.ndarray) -> None:
    """``FliImageFile._palette`` from ``pos``, into ``palette`` (256, 3)."""
    i = 0
    packets = _i16(data, pos)
    pos += 2
    for _ in range(packets):
        s = data[pos: pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise NotThisFormat("index out of range")
        i += s[0]
        n = s[1] or 256
        s = data[pos: pos + 3 * n]
        pos += len(s)
        if len(s) % 3:
            raise NotThisFormat("index out of range")
        rgb = (np.frombuffer(s, np.uint8).reshape(-1, 3).astype(np.int64) << shift) & 255
        if i + len(rgb) > 256:
            raise NotThisFormat("list assignment index out of range")
        palette[i: i + len(rgb)] = rgb
        i += len(rgb)


def decode_fli(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")`` of frame 0."""
    s = data[:128]
    if not (accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise NotThisFormat("not an FLI/FLC file")
    frames = _i16(s, 6)
    w, h = _i16(s, 8), _i16(s, 10)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    s = data[128:144]
    if _i16(s, 4) == 0xF100:  # a prefix chunk, skipped
        at = 128 + _i32(s, 0)
        s = data[at: at + 16]
        pos = at + len(s)
    else:
        pos = 128 + len(s)
    if _i16(s, 4) == 0xF1FA:
        size = None
        for _ in range(_i16(s, 6)):
            if size is not None:
                pos += size - 6
            c = data[pos: pos + 6] if pos >= 0 else b""
            pos += len(c)
            kind = _i16(c, 4)
            if kind in (4, 11):
                _palette(data, pos, 2 if kind == 11 else 0, palette)
                break
            size = _i32(c, 0)
            if not size:
                break
    if frames < 1:
        raise NotThisFormat("attempt to seek outside sequence")
    head = data[128:132]
    if not head:
        raise NotThisFormat("missing frame size")
    framesize = _i32(head, 0)
    if w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "FLI")
    frame = np.zeros((h, w), np.uint8)
    # ImageFile.load: reads of the frame's size fed to the decoder
    b, at = b"", 128
    while True:
        chunk = data[at: at + framesize] if framesize > 0 else b""
        at += len(chunk)
        if not chunk:
            raise truncated(len(b))
        b += chunk
        n, err = native_image.fli_decode(b, frame)
        if n < 0:
            break
        b = b[n:]
    if err < 0:
        raise codec_error(err)
    return to_rgba("P", frame, palette)
