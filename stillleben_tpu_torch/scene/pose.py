"""Pose samplers (reference include/stillleben/pose.h:40-218).

Counterpart of ``stillleben_tpu/scene/pose.py``. Every sampler returns a
4x4 float32 numpy pose in the camera frame (z forward) and draws from a
numpy ``Generator``, in the JAX package's order, so one seed gives both
packages the same poses; the rotation math runs on CPU tensors through
``core.math`` and ``render.camera``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..render.camera import minimum_distance_for_object_diameter, rotation_correction_for_translation

DEFAULT_MIN_SIZE_FACTOR = 0.4  # reference pose.h:54


def random_quaternion_np(rng: np.random.Generator) -> np.ndarray:
    """4 iid normals normalized, wxyz (reference src/scene.cpp:302-312)."""
    q = rng.normal(size=4).astype(np.float32)
    return q / max(np.linalg.norm(q), 1e-12)


def random_rotation_np(rng: np.random.Generator) -> np.ndarray:
    return m.quat_to_matrix(torch.from_numpy(random_quaternion_np(rng))).numpy()


class RandomPositionSampler:
    """z in [1.2, 1 / min_size_factor] x the distance at which the object
    just fits; x and y inside 80% of the frustum (reference pose.h:56-99)."""

    def __init__(self, P: np.ndarray, diameter: float):
        self.P = np.asarray(P, np.float32)
        self.diameter = float(diameter)
        self.fully_visible = float(
            minimum_distance_for_object_diameter(self.diameter, torch.from_numpy(self.P))
        )
        self.min_size_factor = DEFAULT_MIN_SIZE_FACTOR

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        z = rng.uniform(1.2 * self.fully_visible, self.fully_visible / self.min_size_factor)
        x_range = 0.8 * z / float(self.P[0, 0])
        y_range = 0.8 * z / float(self.P[1, 1])
        return np.array(
            [rng.uniform(-x_range, x_range), rng.uniform(-y_range, y_range), z], np.float32
        )


class RandomPoseSampler:
    """A random position and a uniformly random orientation (reference pose.h:101-120)."""

    def __init__(self, position_sampler: RandomPositionSampler):
        self.position_sampler = position_sampler

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        R = random_rotation_np(rng)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = self.position_sampler(rng)
        return T


def _perpendicular(x: np.ndarray) -> np.ndarray:
    v = np.cross(x, [0.0, 1.0, 0.0]) if abs(x[0]) > 0.8 else np.cross(x, [1.0, 0.0, 0.0])
    return v / max(np.linalg.norm(v), 1e-12)


class ViewPointPoseSampler:
    """The object seen from a fixed direction, with a random roll about the
    viewing axis (reference pose.h:132-192)."""

    def __init__(self, position_sampler: RandomPositionSampler):
        self.position_sampler = position_sampler
        self.view_point = np.array([1.0, 0.0, 0.0], np.float32)

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        pos = self.position_sampler(rng)
        x_facing = np.zeros((3, 3), np.float32)
        x_facing[:, 0] = -pos / max(np.linalg.norm(pos), 1e-12)
        x_facing[:, 1] = _perpendicular(x_facing[:, 0])
        x_facing[:, 2] = np.cross(x_facing[:, 0], x_facing[:, 1])
        angle = rng.uniform(-np.pi, np.pi)
        x_rot = m.rotation_x(torch.tensor(angle, dtype=torch.float32)).numpy()
        vp = np.zeros((3, 3), np.float32)
        vp[0, :] = self.view_point
        vp[1, :] = _perpendicular(self.view_point)
        vp[2, :] = np.cross(vp[0, :], vp[1, :])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = x_facing @ x_rot @ vp
        T[:3, 3] = pos
        return T


class ViewCorrectedPoseSampler:
    """A fixed orientation, corrected for the perspective of the sampled
    position (reference pose.h:194-218)."""

    def __init__(self, position_sampler: RandomPositionSampler, orientation: np.ndarray):
        self.position_sampler = position_sampler
        self.orientation = np.asarray(orientation, np.float32).reshape(3, 3)

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        pos = self.position_sampler(rng)
        correction = rotation_correction_for_translation(torch.from_numpy(pos)).numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = correction @ self.orientation
        T[:3, 3] = pos
        return T
