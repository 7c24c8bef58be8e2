"""Pose animator: linear position + quaternion slerp over N ticks.

Counterpart of ``stillleben_tpu/scene/animator.py`` (reference
src/animator.cpp:17-50, python/src/py_animator.cpp:46-63 iterator
protocol). An animator is host data: the keyframes are numpy, and
``pose_at`` interpolates with the port's torch quaternion math on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import math as m


class Animator:
    def __init__(self, poses, ticks: int):
        """:param poses: list of 4x4 keyframe poses
        :param ticks: total number of interpolation steps across the track"""
        poses = [np.asarray(p, np.float32).reshape(4, 4) for p in poses]
        if len(poses) < 2:
            raise ValueError("Animator needs at least 2 keyframe poses")
        self._positions = np.stack([p[:3, 3] for p in poses])
        self._quats = m.matrix_to_quat(torch.from_numpy(np.stack(poses))).numpy()
        # keep quaternion hemispheres consistent for shortest-path slerp
        for i in range(1, len(self._quats)):
            if np.dot(self._quats[i - 1], self._quats[i]) < 0:
                self._quats[i] = -self._quats[i]
        self._ticks = int(ticks)
        self._i = 0

    @property
    def total_ticks(self) -> int:
        return self._ticks

    def __len__(self) -> int:
        return self._ticks

    def __call__(self) -> np.ndarray:
        """Return the pose at the current tick and advance."""
        pose = self.pose_at(self._i)
        self._i += 1
        return pose

    def pose_at(self, tick: int) -> np.ndarray:
        t = 0.0 if self._ticks <= 1 else min(tick / (self._ticks - 1), 1.0)
        n_seg = len(self._positions) - 1
        seg = min(int(t * n_seg), n_seg - 1)
        local_t = t * n_seg - seg

        pos = (1 - local_t) * self._positions[seg] + local_t * self._positions[seg + 1]
        q = m.quat_slerp(torch.from_numpy(self._quats[seg]), torch.from_numpy(self._quats[seg + 1]),
                         np.float32(local_t))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = m.quat_to_matrix(q).numpy()
        T[:3, 3] = pos
        return T

    def __iter__(self):
        self._i = 0
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= self._ticks:
            raise StopIteration
        return self()
