"""CIELab to RGB, as the two libraries convert a CIELab TIFF.

- ``lab_to_rgba``: Pillow 12.1.0's ``convert("RGBA")`` of a mode "LAB"
  image, which ``Image.convert`` hands to LittleCMS 2.17 (``ImageCms``: a
  D50 Lab profile to sRGB, perceptual intent, ``TYPE_Lab_8`` in). Pillow's
  LAB unpacker flips the sign bit of a and b, and LittleCMS reads the
  bytes it is given as unsigned, offset by 128. LittleCMS optimises the
  8-bit transform into a 33^3 grid of 16-bit RGB nodes (its pipeline
  evaluated at each node) read by tetrahedral interpolation; the nodes are
  ``lab_srgb_clut.z`` (zlib, little-endian uint16, L slowest, then a, b,
  then R, G, B), the interpolation is ``TetrahedralInterp16`` and the output
  ``FROM_16_TO_8``. Equal to Pillow's conversion at all 2^24 inputs.
- ``lab_to_rgb_libtiff``: libtiff's RGBA reader (OpenCV's path for an
  8-bit file): ``TIFFCIELabToXYZ`` against the file's WhitePoint (D50 by
  default) and ``TIFFXYZToRGB`` with tif_getimage.c's sRGB display, in
  single precision as tif_color.c computes them.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

_GRID = 33
_NODES: np.ndarray | None = None


def _nodes() -> np.ndarray:
    global _NODES
    if _NODES is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lab_srgb_clut.z")
        with open(path, "rb") as f:
            raw = zlib.decompress(f.read())
        _NODES = np.frombuffer(raw, "<u2").astype(np.int64).reshape(_GRID, _GRID, _GRID, 3)
    return _NODES


def _tetrahedral(v: np.ndarray) -> np.ndarray:
    """LittleCMS's ``TetrahedralInterp16`` of (n, 3) 16-bit inputs."""
    nodes = _nodes()
    f = v * (_GRID - 1)
    f = f + (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    i0, rs = f >> 16, f & 0xFFFF
    i1 = np.where(v == 0xFFFF, i0, i0 + 1)
    n = len(v)
    ar = np.arange(n)
    # the six tetrahedra, in LittleCMS's order of tests
    x, y, z = rs[:, 0], rs[:, 1], rs[:, 2]
    a, b, c, d = x >= y, y >= z, z >= x, x >= z
    order = np.empty((n, 3), np.int64)
    for mask, o in ((a & b, (0, 1, 2)), (a & ~b & c, (2, 0, 1)), (a & ~b & ~c, (0, 2, 1)),
                    (~a & d, (1, 0, 2)), (~a & ~d & b, (1, 2, 0)), (~a & ~d & ~b, (2, 1, 0))):
        order[mask] = o
    idx = i0.copy()
    c0 = prev = nodes[i0[:, 0], i0[:, 1], i0[:, 2]]
    rest = np.zeros_like(c0)
    for k in range(3):
        ax = order[:, k]
        idx[ar, ax] = i1[ar, ax]
        cur = nodes[idx[:, 0], idx[:, 1], idx[:, 2]]
        rest += (cur - prev) * rs[ar, ax][:, None]
        prev = cur
    rest += 0x8001
    return c0 + ((rest + (rest >> 16)) >> 16)


def lab_to_rgba(s: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8: Pillow's ``convert("RGBA")`` of a CIELab TIFF's
    (H, W, 3) samples as stored (L unsigned, a and b signed)."""
    h, w = s.shape[:2]
    v = (s[..., :3].reshape(-1, 3) ^ np.array([0, 0x80, 0x80], np.uint8)).astype(np.int64) * 257
    out = np.empty((h * w, 4), np.uint8)
    for i in range(0, len(v), 1 << 18):
        rgb16 = _tetrahedral(v[i: i + (1 << 18)])
        out[i: i + (1 << 18), :3] = (rgb16 * 65281 + 8388608) >> 24  # FROM_16_TO_8
    out[:, 3] = 255
    return out.reshape(h, w, 4)


def lab_to_rgb_libtiff(s: np.ndarray, tags: dict) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a CIELab TIFF's samples through libtiff's RGBA
    reader; ``tags`` may hold the WhitePoint (318)."""
    f32 = np.float32
    l = s[..., 0].astype(f32)  # noqa: E741
    a = s[..., 1].view(np.int8).astype(f32)
    b = s[..., 2].view(np.int8).astype(f32)
    if 318 in tags and len(tags[318]) >= 2:
        wx, wy = f32(tags[318][0]), f32(tags[318][1])
    else:  # tif_aux.c's default: CIE D50
        total = f32(96.4250) + f32(100.0) + f32(82.4680)
        wx, wy = f32(96.4250) / total, f32(100.0) / total
    x0 = wx / wy * f32(100.0)
    y0 = f32(100.0)
    z0 = (f32(1.0) - wx - wy) / wy * f32(100.0)
    big_l = l * f32(100.0) / f32(255.0)
    low = big_l < f32(8.856)
    y_low = big_l * y0 / f32(903.292)
    cby = np.where(low, f32(7.787) * (y_low / y0) + f32(16.0) / f32(116.0),
                   (big_l + f32(16.0)) / f32(116.0)).astype(f32)
    y = np.where(low, y_low, y0 * cby * cby * cby).astype(f32)

    def xz(t, white):
        return np.where(t < f32(0.2069), white * (t - f32(0.13793)) / f32(7.787),
                        white * t * t * t).astype(f32)
    x = xz(a / f32(500.0) + cby, x0)
    z = xz(cby - b / f32(200.0), z0)
    step = (f32(100.0) - f32(1.0)) / f32(1500)
    gamma = 1.0 / float(f32(2.4))  # in double, as TIFFCIELabToRGBInit takes it
    table = np.array([f32(255) * f32((i / 1500.0) ** gamma) for i in range(1501)], np.float64)
    out = []
    for row in ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416), (0.0556, -0.2040, 1.0570)):
        lum = f32(row[0]) * x + f32(row[1]) * y + f32(row[2]) * z
        lum = np.minimum(np.maximum(lum, f32(1.0)), f32(100.0))
        i = np.minimum(((lum - f32(1.0)) / step).astype(np.int64), 1500)
        out.append(np.minimum(np.floor(table[i] + 0.5), 255))  # RINT of a positive value
    return np.stack(out, -1).astype(np.uint8)
