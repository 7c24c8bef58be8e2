"""Pillow 12.1.0's ``Image.resize`` and ``thumbnail`` size, in numpy.

Three filters, the ones the JAX package reaches through Pillow: BILINEAR
(the texture atlas and the background image), LANCZOS (ICO's thumbnails)
and BICUBIC (ICNS, through ``resize``'s default). Four modes, the ones the
JAX ``ImageSaver`` builds: L, RGB, RGBA (uint8) and I;16 (uint16, 2-D).

The rule is Pillow's two-pass convolution (``Resample.c``):

- Per axis, each output sample ``xx`` reads the band of inputs
  ``[xmin, xmin + n)`` around its centre ``(xx + 0.5) * scale``; the
  filter's support grows with the reduction (``filterscale = max(scale,
  1)``), and its weights are normalised to sum to one.
- The horizontal pass runs first (when the width changes), the vertical
  one second (when the height changes); each rounds to the mode's samples.
- 8-bit samples: weights rounded to 22 fractional bits, integer sums with
  a half added, clipped to 0..255.
- I;16 samples: float64 sums in tap order, rounded half away from zero,
  then stored byte by byte as Pillow stores them: the low byte is the
  value mod 256 clipped to 0..255 (C's ``%``) and the high byte the value
  shifted down 8 clipped to 0..255. A sum past 65535 keeps its low byte
  under a high byte of 255 (65540 -> 65284); a negative one gives 0.
- RGBA goes through Pillow's premultiplied ``RGBa`` and back.

Each output reads only its band (at most ``2 * ceil(support) + 1`` taps);
the filter weights are computed with ``math`` as Pillow's C computes them.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Pillow's Image.Resampling values
LANCZOS, BILINEAR, BICUBIC = 1, 2, 3
PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0), LANCZOS: (_lanczos, 3.0)}
NAMES = {BILINEAR: "BILINEAR", BICUBIC: "BICUBIC", LANCZOS: "LANCZOS"}


@functools.lru_cache(maxsize=128)
def _taps(in_size: int, out_size: int, filt: int):
    """Pillow's ``precompute_coeffs`` for one axis: (out, k) input indices
    (clamped into range where a band is shorter than k), their float64
    weights (0 past the band) and the same weights rounded to 22 bits
    (int32: at most 1.3 x 2^22)."""
    fn, base = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale * base
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(n)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :n] = w
        idx[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    scaled = kk * (1 << PRECISION_BITS)
    k8 = np.trunc(np.where(kk < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    for arr in (idx, kk, k8):  # shared by every caller through the cache
        arr.setflags(write=False)
    return idx, kk, k8


def _pass(a: np.ndarray, axis: int, out_size: int, filt: int) -> np.ndarray:
    """One pass of the convolution along ``axis``, rounded to ``a``'s dtype:
    per tap, the band's ``k``-th inputs gathered and weighted (8-bit sums
    fit int32: at most 255 x 1.3 x 2^22)."""
    idx, kk, k8 = _taps(a.shape[axis], out_size, filt)
    shape = [1] * a.ndim
    shape[axis] = -1
    out_shape = list(a.shape)
    out_shape[axis] = out_size
    if a.dtype == np.uint8:
        acc = np.full(out_shape, 1 << (PRECISION_BITS - 1), np.int32)
        tmp = np.empty(out_shape, np.int32)
        for k in range(idx.shape[1]):
            np.multiply(np.take(a, idx[:, k], axis=axis), k8[:, k].reshape(shape), out=tmp)
            acc += tmp
        acc >>= PRECISION_BITS
        return np.clip(acc, 0, 255).astype(np.uint8)
    acc = np.zeros(out_shape, np.float64)
    tmp = np.empty(out_shape, np.float64)
    for k in range(idx.shape[1]):
        np.multiply(np.take(a, idx[:, k], axis=axis), kk[:, k].reshape(shape), out=tmp)
        acc += tmp
    v = np.where(acc >= 0, np.floor(acc + 0.5), -np.floor(np.abs(acc) + 0.5)).astype(np.int64)
    lo = np.clip(np.fmod(v, 256), 0, 255)
    hi = np.clip(v >> 8, 0, 255)
    return (hi * 256 + lo).astype(np.uint16)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b.astype(np.int32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def resize(img: np.ndarray, size, resample: int = BICUBIC) -> np.ndarray:
    """``Image.fromarray(img).resize(size, resample)`` for uint8 (H, W) L,
    (H, W, 3) RGB, (H, W, 4) RGBA or uint16 (H, W) I;16; ``size`` is
    (width, height). The same size gives a copy, as in Pillow."""
    a = np.asarray(img)
    if resample not in _FILTERS:
        raise ValueError(f"resample filter {resample} is not ported (BILINEAR, BICUBIC, LANCZOS)")
    if not ((a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))))
            or (a.dtype == np.uint16 and a.ndim == 2)):
        raise ValueError(f"resize takes uint8 L, RGB, RGBA or uint16 I;16, not {a.dtype} {a.shape}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError("height and width must be > 0")
    h, w = a.shape[:2]
    if (w, h) == (out_w, out_h):
        return a.copy()
    rgba = a.ndim == 3 and a.shape[2] == 4
    if rgba:  # Pillow's RGBA -> RGBa
        alpha = a[..., 3:4]
        a = np.concatenate([_muldiv255(a[..., :3], alpha), alpha], axis=-1)
    if w != out_w:
        a = _pass(a, 1, out_w, resample)
    if h != out_h:
        a = _pass(a, 0, out_h, resample)
    if rgba:  # RGBa -> RGBA
        al = a[..., 3:4].astype(np.int32)
        rgb = a[..., :3].astype(np.int32)
        unmul = np.clip(255 * rgb // np.maximum(al, 1), 0, 255)
        rgb = np.where((al == 255) | (al == 0), rgb, unmul)
        a = np.concatenate([rgb, al], axis=-1).astype(np.uint8)
    return a


def thumbnail_size(width: int, height: int, box) -> tuple[int, int] | None:
    """The size ``Image.thumbnail(box)`` resizes a ``width`` x ``height``
    image to (Pillow's ``preserve_aspect_ratio``), or None where it leaves
    the image as it is (the box holds it)."""
    x, y = math.floor(box[0]), math.floor(box[1])
    if x >= width and y >= height:
        return None

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(img: np.ndarray, box, resample: int = BICUBIC) -> np.ndarray:
    """``Image.thumbnail(box, resample, reducing_gap=None)`` on a copy of
    ``img``: the image itself where the box holds it."""
    a = np.asarray(img)
    size = thumbnail_size(a.shape[1], a.shape[0], box)
    if size is None or size == (a.shape[1], a.shape[0]):
        return a.copy()
    return resize(a, size, resample)
