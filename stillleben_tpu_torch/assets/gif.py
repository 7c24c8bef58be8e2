"""GIF, frame 0: decode as Pillow and as OpenCV read it.

The LZW codes are decoded by the native codec core (``native_image``);
the blocks around them here. ``decode_gif`` gives Pillow 12's
``Image.open(p).convert("RGBA")`` of the first frame: the frame's local
colour table or else the global one (a local table that is the grey ramp
0, 1, 2, ... gives way to the global one; with neither, Pillow's mode "L":
the index is the grey), the graphic control
extension's transparent index (alpha 0 where a pixel holds it),
interlacing, and Pillow's canvas: the logical screen (grown to hold the
frame), filled with the transparent index when there is one and with
index 0 otherwise. ``decode_gif_cv2`` gives ``cv2.imread(p,
IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``: (H, W, 3) BGR of the same frame,
the screen's background colour where it is transparent, None for a frame
that does not fit its screen. A screen over Pillow's or OpenCV's size
limit raises, as does (for Pillow's reading) a canvas grown past Pillow's
limit, which Pillow would allocate.
Encoding GIF (Pillow quantises RGB to an adaptive palette) is not ported.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import native_image
from .image_limits import check_size


class _Frame(NamedTuple):
    index: np.ndarray  # (H, W) canvas of indices
    palette: np.ndarray | None  # (N, 3) RGB, None for Pillow's mode "L"
    transparency: int | None
    drawn: np.ndarray  # (H, W) bool: the frame's pixels
    table: np.ndarray  # (256, 3) the frame's colour table as stored
    background: np.ndarray  # (3,) the screen's background colour


def _grey_ramp(p: bytes) -> bool:
    return all(i // 3 == p[i] == p[i + 1] == p[i + 2] for i in range(0, len(p), 3))


def _blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The sub-blocks from ``pos`` joined, and the position after them."""
    out = []
    while pos < len(data):
        size = data[pos]
        pos += 1
        if size == 0:
            break
        out.append(data[pos: pos + size])
        pos += size
    return b"".join(out), pos


def _interlaced_rows(h: int) -> np.ndarray:
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def _parse(data: bytes, name: str, cv2: bool = False) -> _Frame | None:
    """Frame 0 on its canvas; None when ``cv2`` and the frame does not fit
    its screen (OpenCV reads no image then)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    check_size(width, height, name, "GIF", cv2)
    pos = 13
    global_pal = global_raw = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_raw = data[pos: pos + n]
        pos += n
        global_pal = None if _grey_ramp(global_raw) else global_raw
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{name}: GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # extension
            label = data[pos]
            body, pos = _blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"{name}: GIF block 0x{kind:02x} is not valid")
        x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        pal, raw = global_pal, global_raw
        if iflags & 128:  # a local grey ramp leaves Pillow on the global table
            n = 3 << ((iflags & 7) + 1)
            raw = data[pos: pos + n]
            pos += n
            if not _grey_ramp(raw):
                pal = raw
        min_code = data[pos]
        lzw, _ = _blocks(data, pos + 1)
        break
    if cv2 and not (x0 + w <= width and y0 + h <= height):
        return None
    width, height = max(width, x0 + w), max(height, y0 + h)
    check_size(width, height, name, "GIF canvas")
    canvas = np.full((height, width), transparency or 0, np.uint8)
    if w and h:
        got = native_image.gif_lzw(lzw, min_code, w * h, name)
        frame = canvas[y0: y0 + h, x0: x0 + w].reshape(-1)
        frame[: got.size] = got
        frame = frame.reshape(h, w)
        if iflags & 64:
            frame = frame[np.argsort(_interlaced_rows(h), kind="stable")]
        canvas[y0: y0 + h, x0: x0 + w] = frame
    drawn = np.zeros((height, width), bool)
    drawn[y0: y0 + h, x0: x0 + w] = True
    palette = None if pal is None else np.frombuffer(pal, np.uint8).reshape(-1, 3)

    def table(b):
        t = np.zeros((256, 3), np.uint8)
        if b:
            t[: len(b) // 3] = np.frombuffer(b, np.uint8).reshape(-1, 3)[:256]
        return t

    background = table(global_raw or raw)[data[11]]
    return _Frame(canvas, palette, transparency, drawn, table(raw), background)


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 of frame 0 as Pillow's ``convert("RGBA")``."""
    f = _parse(data, name)
    out = np.empty(f.index.shape + (4,), np.uint8)
    if f.palette is None:
        out[..., :3] = f.index[..., None]
    else:
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        pal[: min(256, len(f.palette))] = f.palette[:256]
        out[..., :3] = pal[f.index]
    out[..., 3] = 255
    if f.transparency is not None:
        out[..., 3] = np.where(f.index == f.transparency, 0, 255)
    return out


def decode_gif_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """(H, W, 3) BGR of frame 0 as ``cv2.imread``: the stored colour table
    (grey ramps too), and the screen's background colour where the frame
    draws nothing or holds the transparent index; None for a frame that
    does not fit its screen, as OpenCV reads none."""
    f = _parse(data, name, cv2=True)
    if f is None:
        return None
    out = np.broadcast_to(f.background, f.index.shape + (3,)).copy()
    show = f.drawn if f.transparency is None else f.drawn & (f.index != f.transparency)
    out[show] = f.table[f.index[show]]
    return np.ascontiguousarray(out[..., ::-1])
