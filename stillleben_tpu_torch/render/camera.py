"""Camera model: computer-vision-convention perspective projection.

Counterpart of ``stillleben_tpu/render/camera.py`` (reference
src/scene.cpp:222-271, src/pose.cpp:24-59): the camera looks along +Z,
clip-space w equals camera-space z, near = 0.1 and far = 10. Matrices are
row-major; pixel (u, v) has v down, row 0 at the top.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import math as m

DEFAULT_NEAR = 0.1
DEFAULT_FAR = 10.0
DEFAULT_HFOV_DEG = 58.0  # reference src/scene.cpp:138


def projection_from_intrinsics(
    fx, fy, cx, cy, width, height, near: float = DEFAULT_NEAR, far: float = DEFAULT_FAR,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """The reference's 4x4 projection (src/scene.cpp:222-253), row-major."""
    n, f = near, far
    f32 = dict(dtype=torch.float32, device=device)
    fx, fy, cx, cy, W, H = (torch.as_tensor(x, **f32) for x in (fx, fy, cx, cy, width, height))
    L = -cx * n / fx
    R = (W - cx) * n / fx
    T = -cy * n / fy
    B = (H - cy) * n / fy
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([2 * n / (R - L), zero, (R + L) / (L - R), zero], -1),
            torch.stack([zero, 2 * n / (B - T), (T + B) / (T - B), zero], -1),
            torch.stack([zero, zero, (f + n) / (f - n) * one, 2 * f * n / (n - f) * one], -1),
            torch.stack([zero, zero, one, zero], -1),
        ],
        -2,
    )


def projection_from_fov(
    hfov_rad, width, height, near: float = DEFAULT_NEAR, far: float = DEFAULT_FAR,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Horizontal-FOV camera (reference src/scene.cpp:260-271): principal
    point at the image centre, fx = fy = W / (2 tan(fov / 2))."""
    f32 = dict(dtype=torch.float32, device=device)
    W = torch.as_tensor(width, **f32)
    H = torch.as_tensor(height, **f32)
    fx = W / (2.0 * torch.tan(torch.as_tensor(hfov_rad, **f32) / 2.0))
    return projection_from_intrinsics(fx, fx, W / 2, H / 2, W, H, near, far, device=device)


def intrinsics_from_projection(P: torch.Tensor, width, height):
    """(fx, fy, cx, cy) of a projection in the reference's convention."""
    W, H = float(width), float(height)
    fx = P[..., 0, 0] * W / 2.0
    fy = P[..., 1, 1] * H / 2.0
    cx = (P[..., 0, 2] + 1.0) * W / 2.0
    cy = (P[..., 1, 2] + 1.0) * H / 2.0
    return fx, fy, cx, cy


def project_points(P: torch.Tensor, points_cam: torch.Tensor, width, height):
    """Camera-space points -> (u, v) pixel coordinates and the camera depth w."""
    hom = torch.cat([points_cam, torch.ones_like(points_cam[..., :1])], dim=-1)
    clip = torch.einsum("ij,...j->...i", P, hom)
    w = clip[..., 3]
    safe_w = torch.where(w.abs() < 1e-9, 1e-9, w)
    ndc = clip[..., :3] / safe_w[..., None]
    u = (ndc[..., 0] + 1.0) * 0.5 * float(width)
    v = (ndc[..., 1] + 1.0) * 0.5 * float(height)
    return u, v, w


def minimum_distance_for_object_diameter(diameter, P: torch.Tensor) -> torch.Tensor:
    """Distance at which a sphere of ``diameter`` just fits the frustum
    (reference src/pose.cpp:24-34)."""
    return torch.maximum(P[..., 0, 0] * diameter / 2.0, P[..., 1, 1] * diameter / 2.0)


def rotation_correction_for_translation(pos: torch.Tensor) -> torch.Tensor:
    """R^T of the Rodrigues rotation taking normalize(pos) onto +Z: it
    cancels the apparent rotation of a translated object (reference
    src/pose.cpp:36-59)."""
    a = m.normalize(pos)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=pos.dtype, device=pos.device)
    v = m.cross(a, z)
    s = torch.sqrt((v * v).sum())
    c = (a * z).sum()
    vx = m.cross_matrix(v)
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    safe_s2 = torch.where(s < 1e-5, 1.0, s * s)
    R = eye + vx + (1.0 - c) / safe_s2 * (vx @ vx)
    return torch.where(s < 1e-5, eye, R).T


@dataclass(frozen=True)
class CameraParams:
    """Static camera configuration of a scene (host side)."""

    width: int
    height: int
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
