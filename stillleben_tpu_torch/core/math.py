"""Core 3D math on torch tensors: quaternions, rigid transforms.

Counterpart of ``stillleben_tpu/core/math.py`` (only the functions the
datagen path calls). Conventions are the same:

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


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``v / |v|``; vectors with ``|v|^2 < eps`` pass through unscaled."""
    n2 = (v * v).sum(dim=dim, keepdim=True)
    safe = torch.where(n2 < eps, torch.ones_like(n2), n2)
    return v * torch.rsqrt(safe)


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


def random_quaternion(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """4 iid standard normals, normalized (reference src/scene.cpp:302-312).
    Drawn on the CPU generator so a seed gives the same numbers on every
    device; the caller moves the result."""
    q = torch.randn(tuple(shape) + (4,), generator=generator, dtype=torch.float32)
    return quat_normalize(q)


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


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 transform: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return make_transform(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


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
