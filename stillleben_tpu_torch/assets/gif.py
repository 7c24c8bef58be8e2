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

``encode_gif`` gives Pillow 12's ``Image.fromarray(a, mode).save(p)`` to a
``.gif`` path, byte for byte, for the modes the JAX ``ImageSaver`` hands
Pillow: ``GifImagePlugin``'s Python layer here (``_normalize_mode``,
``_normalize_palette`` with ``_get_optimize`` and ``remap_palette``, the
header, the graphic control extension and the image descriptor), the
quantisers and the LZW in the native encoder (``csrc/sl_gif_enc.cpp``).
"""

from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _optimize(index: np.ndarray, n_palette: int) -> np.ndarray | None:
    """``_get_optimize`` of a P image: the used entries, ascending, where
    Pillow prunes the palette; None where it keeps it."""
    h, w = index.shape
    if w * h >= 512 * 512:
        return None
    used = np.flatnonzero(np.bincount(index.ravel(), minlength=256))
    if used[-1] >= len(used):
        return used
    current = 1 << (n_palette - 1).bit_length()
    if len(used) <= current // 2 and current > 2:
        return used
    return None


def _remap(index: np.ndarray, palette: np.ndarray, used: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``remap_palette(used)``: the used entries in their order, the
    indices moved onto them."""
    positions = np.zeros(256, np.uint8)
    positions[used] = np.arange(len(used))
    return positions[index], palette[used]


def _table_bits(n: int) -> int:
    """``_get_color_table_size`` of ``n`` entries (the colour table holds
    ``2 << bits``)."""
    return 1 if n < 3 else math.ceil(math.log(n, 2)) - 1


def gif_index(pixels: np.ndarray) -> tuple[np.ndarray, np.ndarray, int | None]:
    """The image GifImagePlugin writes for ``pixels`` as the JAX
    ``ImageSaver`` hands them over: the (H, W) uint8 indices, the (N, 3)
    RGB palette and the transparent index (or None).

    - (H, W) uint8 (mode L) and uint16 (mode I;16, which Pillow converts to
      L clipped at 255): the grey values used, ascending;
    - (H, W, 3) RGB: the median cut;
    - (H, W, 4) RGBA: the fast octree; the first entry of alpha 0 is the
      transparent index.

    Then ``_get_optimize``: an L image always, a P image under 512 x 512
    pixels whose palette has holes or would halve, keeps only its used
    entries."""
    a = np.asarray(pixels)
    transparency = None
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        grey = np.minimum(a, 255).astype(np.uint8)
        used = np.flatnonzero(np.bincount(grey.ravel(), minlength=256))
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        return (*_remap(grey, ramp, used), None)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"cannot write mode {a.dtype} {a.shape} as GIF")
    if a.shape[2] == 3:
        palette, index = native_image.quantize_median(a)
    else:
        palette, index = native_image.quantize_octree(a)
        clear = np.flatnonzero(palette[:, 3] == 0)
        transparency = int(clear[0]) if len(clear) else None
        palette = palette[:, :3]
    used = _optimize(index, len(palette))
    if used is not None:
        index, palette = _remap(index, palette, used)
        if transparency is not None:
            hit = np.flatnonzero(used == transparency)
            transparency = int(hit[0]) if len(hit) else None
    return index, palette, transparency


def encode_gif(pixels: np.ndarray) -> bytes:
    """The GIF file Pillow's ``save`` writes for ``pixels`` (see
    ``gif_index``): GIF87a, or GIF89a with a graphic control extension
    when there is a transparent index; the palette padded to a power of
    two (at least 4 entries); interlaced unless a side is under 16
    pixels; LZW at minimum code size 8."""
    h, w = np.shape(pixels)[:2]
    if not (0 < w <= 0xFFFF and 0 < h <= 0xFFFF):
        raise ValueError(f"cannot write a {w}x{h} image as GIF")
    index, palette, transparency = gif_index(pixels)
    bits = _table_bits(len(palette))
    table = np.zeros((2 << bits, 3), np.uint8)
    table[: len(palette)] = palette
    out = [b"GIF89a" if transparency is not None else b"GIF87a",
           struct.pack("<HHBBB", w, h, bits + 128, 0, 0), table.tobytes()]
    if transparency is not None:
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 1, 0, transparency, 0))
    interlace = min(w, h) >= 16
    out.append(struct.pack("<BHHHHBB", 0x2C, 0, 0, w, h, 64 if interlace else 0, 8))
    out.append(native_image.gif_lzw_encode(index, interlace))
    out.append(b"\0;")
    return b"".join(out)
