"""Axis-aligned 3D range (bounding box).

Copied from ``stillleben_tpu/core/range3d.py``.

API parity with the reference's Magnum Range3D binding
(python/src/py_magnum.cpp: Range3D with min/max/center/size/diagonal and
corner accessors used by Scene::chooseRandomCameraPose, src/scene.cpp:521-535).
"""

from __future__ import annotations

import numpy as np


class Range3D:
    __slots__ = ("_min", "_max")

    def __init__(self, min=(0.0, 0.0, 0.0), max=(0.0, 0.0, 0.0)):
        self._min = np.asarray(min, dtype=np.float32).reshape(3)
        self._max = np.asarray(max, dtype=np.float32).reshape(3)

    @property
    def min(self) -> np.ndarray:
        return self._min

    @property
    def max(self) -> np.ndarray:
        return self._max

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self._min + self._max)

    @property
    def size(self) -> np.ndarray:
        return self._max - self._min

    @property
    def diagonal(self) -> float:
        return float(np.linalg.norm(self.size))

    def corners(self) -> np.ndarray:
        """All 8 corners, order matching the reference's enumeration
        (back/front x bottom/top x left/right, src/scene.cpp:527-534)."""
        mn, mx = self._min, self._max
        return np.array(
            [
                [mn[0], mn[1], mn[2]],
                [mx[0], mn[1], mn[2]],
                [mn[0], mx[1], mn[2]],
                [mx[0], mx[1], mn[2]],
                [mn[0], mn[1], mx[2]],
                [mx[0], mn[1], mx[2]],
                [mn[0], mx[1], mx[2]],
                [mx[0], mx[1], mx[2]],
            ],
            dtype=np.float32,
        )

    def contains(self, p) -> bool:
        p = np.asarray(p, dtype=np.float32)
        return bool(np.all(p >= self._min) and np.all(p <= self._max))

    @staticmethod
    def from_points(points: np.ndarray) -> "Range3D":
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        if points.size == 0:
            return Range3D()
        return Range3D(points.min(axis=0), points.max(axis=0))

    def union(self, other: "Range3D") -> "Range3D":
        return Range3D(np.minimum(self._min, other._min), np.maximum(self._max, other._max))

    def __repr__(self):
        return f"Range3D(min={self._min.tolist()}, max={self._max.tolist()})"

    def __eq__(self, other):
        return (
            isinstance(other, Range3D)
            and np.allclose(self._min, other._min)
            and np.allclose(self._max, other._max)
        )
