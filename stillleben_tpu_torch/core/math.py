"""Core 3D math on torch tensors: quaternions, rigid transforms.

Counterpart of ``stillleben_tpu/core/math.py``, every function of it.
Conventions are the same:

- quaternions are (w, x, y, z), scalar first, unit norm;
- 4x4 transforms are row-major and act on column vectors: ``p' = T @ [p, 1]``.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``.
    Written as separate elementwise ops so no multiply-add is contracted on
    any device (the raster's edge lines are built from it)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [v]x with [v]x @ u = v x u (reference src/pose.cpp:13-22)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``v / |v|``; vectors with ``|v|^2 < eps`` pass through unscaled."""
    n2 = (v * v).sum(dim=dim, keepdim=True)
    safe = torch.where(n2 < eps, torch.ones_like(n2), n2)
    return v * torch.rsqrt(safe)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return normalize(q, dim=-1, eps=eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q``."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) -> 3x3 rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(M: torch.Tensor) -> torch.Tensor:
    """3x3 (or the upper left of a 4x4) rotation -> unit quaternion, w >= 0.
    Shepperd's method without branches, as ``math.py:112-168``: the four
    candidates, the one of the largest diagonal combination kept."""
    M = M[..., :3, :3]
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    trace = m00 + m11 + m22
    d01, s01 = M[..., 0, 1] - M[..., 1, 0], M[..., 0, 1] + M[..., 1, 0]
    d02, s02 = M[..., 0, 2] - M[..., 2, 0], M[..., 0, 2] + M[..., 2, 0]
    d21, s12 = M[..., 2, 1] - M[..., 1, 2], M[..., 1, 2] + M[..., 2, 1]
    cands = torch.stack(
        [
            torch.stack([1.0 + trace, d21, d02, -d01], dim=-1),
            torch.stack([d21, 1.0 + m00 - m11 - m22, s01, s02], dim=-1),
            torch.stack([d02, s01, 1.0 + m11 - m00 - m22, s12], dim=-1),
            torch.stack([-d01, s02, s12, 1.0 + m22 - m00 - m11], dim=-1),
        ],
        dim=-2,
    )
    scores = torch.stack([trace, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def random_quaternion(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """4 iid standard normals, normalized (reference src/scene.cpp:302-312).
    Drawn on the CPU generator so a seed gives the same numbers on every
    device; the caller moves the result."""
    q = torch.randn(tuple(shape) + (4,), generator=generator, dtype=torch.float32)
    return quat_normalize(q)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation along the shorter arc."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    d = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(d.abs(), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def make_transform(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform_from_quat_pos(q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return make_transform(quat_to_matrix(q), pos)


def transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) applied to (..., 3) points."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def transform_vector(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rotation (and scale) of T applied to (..., 3) vectors."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], v)


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 transform: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_transform(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def rotation_x(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(
        [torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1), torch.stack([z, s, c], -1)],
        -2,
    )


def rotation_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(
        [torch.stack([c, z, s], -1), torch.stack([z, o, z], -1), torch.stack([-s, z, c], -1)],
        -2,
    )


def rotation_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)],
        -2,
    )


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' rotation about ``axis`` (normalized here) by ``angle``."""
    K = cross_matrix(normalize(axis))
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """The nearest rotation to a near-rotation, by SVD with det +1
    (reference python/stillleben/diff.py apply_pose_delta)."""
    U, _, Vt = torch.linalg.svd(R)
    D = torch.ones(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
    D[..., 2] = torch.linalg.det(U @ Vt)
    return (U * D[..., None, :]) @ Vt


def is_rigid(T: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """R orthonormal with det ~ +1 and the last row (0, 0, 0, 1)."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    err = (R @ R.transpose(-1, -2) - eye).abs().amax(dim=(-1, -2))
    det_err = (torch.linalg.det(R) - 1.0).abs()
    last = (T[..., 3, :] - torch.tensor([0.0, 0, 0, 1], dtype=T.dtype, device=T.device)).abs()
    return (err < tol) & (det_err < tol) & (last.amax(dim=-1) < tol)


def look_at(position: torch.Tensor, target: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Camera-to-world pose of a +Z-forward camera (reference
    src/scene.cpp:205-215): z = normalize(target - position),
    x = normalize(z x up), y = z x x."""
    z = normalize(target - position)
    x = normalize(cross(z, up))
    y = cross(z, x)
    return make_transform(torch.stack([x, y, z], dim=-1), position)


def perpendicular_vector(x: torch.Tensor) -> torch.Tensor:
    """A unit vector perpendicular to x (reference include/stillleben/pose.h:122-130)."""
    use_y = x[..., 0].abs() > 0.8
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    return normalize(torch.where(use_y[..., None], cross(x, ey.expand_as(x)), cross(x, ex.expand_as(x))))
