"""Arcball camera (Shoemake 1992): drag-to-orbit with quaternion composition.

Counterpart of ``stillleben_tpu/utils/arcball.py``, a copy: plain float64
numpy, no device. The reference viewer's camera control (reference
src/utils/arc_ball.cpp, used by src/viewer.cpp): NDC points map
onto a virtual unit sphere; a drag rotates the eye around the view center by
the quaternion between the two sphere points. Zoom dollies along the view
ray; lagging (smoothed) update is omitted — matplotlib event cadence is
coarse enough that direct updates feel right.
"""

from __future__ import annotations

import numpy as np


def _ndc_to_sphere(p: np.ndarray) -> np.ndarray:
    """(2,) NDC in [-1, 1] -> unit-ish sphere point (3,)."""
    d = float(p[0] * p[0] + p[1] * p[1])
    if d <= 1.0:
        return np.array([p[0], p[1], np.sqrt(1.0 - d)], np.float64)
    q = p / np.sqrt(d)
    return np.array([q[0], q[1], 0.0], np.float64)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float64,
    )


def _quat_rotate(q, v):
    w, x, y, z = q
    qv = np.array([x, y, z])
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


class ArcBall:
    """Orbit an eye around ``center`` from mouse drags in a (W, H) window."""

    def __init__(self, eye, center, up, window_size):
        self.center = np.asarray(center, np.float64)
        self.eye = np.asarray(eye, np.float64)
        self.up = np.asarray(up, np.float64)
        self.window = (float(window_size[0]), float(window_size[1]))
        self._drag_from: np.ndarray | None = None

    def _to_ndc(self, x: float, y: float) -> np.ndarray:
        w, h = self.window
        return np.array([2.0 * x / w - 1.0, 1.0 - 2.0 * y / h], np.float64)

    def start(self, x: float, y: float) -> None:
        self._drag_from = _ndc_to_sphere(self._to_ndc(x, y))

    def drag(self, x: float, y: float) -> bool:
        """Rotate for a drag to window point (x, y). Returns True if moved."""
        if self._drag_from is None:
            return False
        a = self._drag_from
        b = _ndc_to_sphere(self._to_ndc(x, y))
        self._drag_from = b
        # rotation taking a -> b: q = (dot, cross) (double-angle arcball)
        q = np.concatenate([[np.dot(a, b)], np.cross(a, b)])
        nq = np.linalg.norm(q)
        if nq < 1e-12:
            return False
        q = q / nq
        # the sphere lives in CAMERA space: conjugate into world space
        R = self.camera_rotation()  # world <- camera columns
        qv_world = R @ q[1:]
        q_world = np.concatenate([[q[0]], qv_world])
        # rotate the eye (and up) around the center by the INVERSE rotation
        q_world[1:] = -q_world[1:]
        self.eye = self.center + _quat_rotate(q_world, self.eye - self.center)
        self.up = _quat_rotate(q_world, self.up)
        return True

    def stop(self) -> None:
        self._drag_from = None

    def zoom(self, factor: float) -> None:
        """Dolly: factor > 1 moves closer."""
        d = self.eye - self.center
        self.eye = self.center + d / float(factor)

    def camera_rotation(self) -> np.ndarray:
        """(3,3) world<-camera, matching core.math.look_at's +z-forward
        convention: z = fwd, x = z x up, y = z x x."""
        z = self.center - self.eye
        z = z / max(np.linalg.norm(z), 1e-12)
        x = np.cross(z, self.up)
        n = np.linalg.norm(x)
        if n < 1e-9:  # looking along up: pick any perpendicular
            x = np.array([1.0, 0.0, 0.0])
            x = x - z * np.dot(x, z)
            n = np.linalg.norm(x)
        x = x / n
        y = np.cross(z, x)
        return np.stack([x, y, z], axis=1)

    def camera_pose(self) -> np.ndarray:
        """(4,4) camera-to-world pose (CV convention, +z looks at center)."""
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.camera_rotation().astype(np.float32)
        T[:3, 3] = self.eye.astype(np.float32)
        return T
