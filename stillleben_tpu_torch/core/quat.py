"""User-facing quaternion helpers on numpy arrays.

Counterpart of ``stillleben_tpu/core/quat.py`` (reference
python/src/py_magnum.cpp bindings): quaternions in the reference's
Python order (x, y, z, w), while ``core.math`` works in (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch

from . import math as _m


def quat_to_matrix(q) -> np.ndarray:
    """xyzw quaternion(s) -> 3x3 rotation matrix."""
    q = np.asarray(q, dtype=np.float32)
    wxyz = np.concatenate([q[..., 3:4], q[..., 0:3]], axis=-1)
    return _m.quat_to_matrix(torch.from_numpy(wxyz)).numpy()


def matrix_to_quat(m) -> np.ndarray:
    """3x3 (or 4x4) rotation matrix -> xyzw quaternion."""
    m = np.ascontiguousarray(np.asarray(m, dtype=np.float32))
    wxyz = _m.matrix_to_quat(torch.from_numpy(m)).numpy()
    return np.concatenate([wxyz[..., 1:4], wxyz[..., 0:1]], axis=-1)
