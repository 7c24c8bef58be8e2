"""Texture wrappers (host side).

Counterpart of ``stillleben_tpu/assets/texture.py:15-54``: ``Texture`` (not
mip-mapped: background images and stickers) and ``Texture2D`` (mip-mapped
where consumed: the background plane). Both take a file name or an
(H, W, 3|4) uint8 array; files are decoded by the port's own codec
(``assets/image.py``: PNG, PPM, JPEG, BMP, TGA, GIF, TIFF), as Pillow's
``convert("RGBA")`` gives them.
"""

from __future__ import annotations

import os

import numpy as np

from .image import read_image


class Texture:
    def __init__(self, source):
        if isinstance(source, os.PathLike):
            source = os.fspath(source)
        if isinstance(source, str):
            self.pixels = read_image(source)
        else:
            arr = np.asarray(source)
            if arr.dtype != np.uint8:
                raise TypeError("Texture expects uint8 data")
            if arr.ndim != 3 or arr.shape[2] not in (3, 4):
                raise ValueError("Texture expects (H, W, 3|4)")
            if arr.shape[2] == 3:
                arr = np.concatenate(
                    [arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=2
                )
            self.pixels = arr.copy()

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    def linear_f32(self) -> np.ndarray:
        """(H, W, 4) f32 linear (gamma 2.2 on RGB, alpha as it is)."""
        arr = self.pixels.astype(np.float32) / 255.0
        arr[..., :3] = arr[..., :3] ** 2.2
        return arr


class Texture2D(Texture):
    """Mip-mapped variant; the mip chain is built where it is consumed."""
