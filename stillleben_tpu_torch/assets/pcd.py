"""Kodak PhotoCD (``.pcd``), read as Pillow reads it (``PcdImagePlugin``):
the 768x512 base image at byte 96 x 2048, two luma rows and their shared
chroma a chunk of 2304 bytes (PcdDecode.c), PhotoYCC converted to RGB by
Pillow's fixed tables (UnpackYCC.c: r = L[y] + CR[c2], g = L[y] + GR[c2] +
GB[c1], b = L[y] + CB[c1], each clipped to 0..255; not JPEG's YCbCr), then
turned by the orientation bits of byte 2048 + 1538 (1: 90 degrees
counter-clockwise, 3: 270). No magic at the start: Pillow tries PCD on any
file no earlier plugin took and takes it where ``PCD_`` stands at 2048.
"""

from __future__ import annotations

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, to_rgba, truncated

WIDTH, HEIGHT = 768, 512
OFFSET = 96 * 2048
CHUNK = 3 * WIDTH  # two luma rows and their chroma


def _table(start: int, low: int, steps: str) -> np.ndarray:
    """A table of 256 from its first value and its steps (each ``low`` plus
    a digit)."""
    return np.cumsum([start] + [low + int(c) for c in steps]).astype(np.int64)


# UnpackYCC.c's tables; L is round(1.3584 * i)
L = np.floor(1.3584 * np.arange(256) + 0.5).astype(np.int64)
CR = _table(-249, 1, "11111011110111110111110111101111101111011111011111011110111110111101111101111"
                     "10111101111101111011111011111011110111110111101111101111101011011111011111011"
                     "11011111011110111110111110111101111101111011111011111011110111110111101111101"
                     "111101111011111011110111")
GR = _table(127, -1, "00000010000000000000100000000000001000000000000100000000000001000000000000010"
                     "00000000000100000000000001000000000000010000000000000100000010000010000000000"
                     "00010000000000000100000000000001000000000000100000000000001000000000000010000"
                     "000000001000000000000010")
GB = _table(67, -1, "101011010101101010110101011010101011010101101010110101011010101101010110101011"
                    "010101101010110101011010101101010110101010110101011010101101010110101011010101"
                    "111010110101011010101101010110101011010101011010101101010110101011010101101010"
                    "110101011010101101010")
CB = _table(-345, 1, "11211121111211112111211112111211112111211112111121112111121112111121111211121"
                     "11121112111121111211121111211121111211121111211112111211112111211112111121112"
                     "10112111211112111121112111121112111121111211121111211121111211121111211112111"
                     "211112111211112111121112")


def ycc_to_rgb(y: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Pillow's PhotoYCC -> RGB of uint8 planes: (..., 3) uint8."""
    lum = L[y]
    rgb = np.stack([lum + CR[c2], lum + GR[c2] + GB[c1], lum + CB[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    s = data[2048: 2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        raise NotThisFormat("not a PCD file")
    orientation = s[1538] & 3
    check_size(WIDTH, HEIGHT, name, "PCD")
    avail = max(0, len(data) - OFFSET)
    need = CHUNK * HEIGHT // 2
    if avail < need:
        raise truncated(avail % CHUNK)
    chunks = np.frombuffer(data, np.uint8, need, OFFSET).reshape(HEIGHT // 2, CHUNK)
    luma = chunks[:, : 2 * WIDTH].reshape(HEIGHT, WIDTH)
    half = np.arange(WIDTH) // 2
    c1 = np.repeat(chunks[:, 2 * WIDTH: 2 * WIDTH + WIDTH // 2][:, half], 2, axis=0)
    c2 = np.repeat(chunks[:, 2 * WIDTH + WIDTH // 2:][:, half], 2, axis=0)
    rgb = ycc_to_rgb(luma, c1, c2)
    if orientation in (1, 3):
        rgb = np.rot90(rgb, 1 if orientation == 1 else 3)
    return to_rgba("RGB", np.ascontiguousarray(rgb))
