"""Random camera pose that keeps all objects inside the frustum, and the
random light direction.

Counterpart of ``stillleben_tpu/scene/camera_fit.py`` (reference
Scene::chooseRandomCameraPose, src/scene.cpp:472-610, and
chooseRandomLightDirection, :453-470). Functions take a batch axis: B
scenes at once. Random numbers come from a CPU ``torch.Generator`` so a
seed gives the same scenes on every device; they are drawn apart from the
work (``camera_uniforms``, ``light_normals``), so a batch can be drawn
whole and its rows sent to several devices.
"""

from __future__ import annotations

import math

import torch

from ..core import math as m

ELEVATION_LIMIT = math.radians(30.0)


def _base_cam_rot(device) -> torch.Tensor:
    """Rotation into the image frame: columns (-y, -z, x) (src/scene.cpp:488-493)."""
    return torch.tensor(
        [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], device=device
    )


def camera_uniforms(batch: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 2) uniforms of ``camera_rotation``, on the CPU."""
    return torch.rand((batch, 2), generator=generator, dtype=torch.float32)


def camera_rotation(u: torch.Tensor, device) -> torch.Tensor:
    """(B, 3, 3) from ``camera_uniforms``: azimuth in [-pi, pi), elevation
    in [30, 60] degrees."""
    u = u.to(device)
    azimuth = -math.pi + u[:, 0] * (2 * math.pi)
    elevation = ELEVATION_LIMIT + u[:, 1] * (math.pi / 2 - 2 * ELEVATION_LIMIT)
    return m.rotation_z(azimuth) @ m.rotation_y(elevation) @ _base_cam_rot(device)


def random_camera_rotation(batch: int, generator: torch.Generator, device) -> torch.Tensor:
    """(B, 3, 3): ``camera_rotation`` of fresh uniforms."""
    return camera_rotation(camera_uniforms(batch, generator), device)


def _intersect_2d(l0: torch.Tensor, l1: torch.Tensor):
    inter = m.cross(l0, l1)
    bad = inter[..., 2].abs() < 1e-3
    inter = torch.where(bad[..., None], torch.tensor([0.0, 0.0, 1.0], device=inter.device), inter)
    return inter[..., 0] / inter[..., 2], inter[..., 1] / inter[..., 2]


def fit_camera_position(
    cam_rot: torch.Tensor,  # (B, 3, 3) world rotation of the camera
    P: torch.Tensor,  # (4, 4) projection
    points: torch.Tensor,  # (B, N, 3) bbox corners in world space
    point_valid: torch.Tensor,  # (B, N) bool
) -> torch.Tensor:
    """Backmost camera position (B, 3) with every point inside the
    left/right/top/bottom frustum planes (camera_fit.py:46-89)."""
    pts = points @ cam_rot  # (B, N, 3) in the camera-rotation-aligned frame
    planes = torch.stack([P[3] + P[0], P[3] - P[0], P[3] + P[1], P[3] - P[1]])
    planes = planes / torch.linalg.vector_norm(planes[:, :3], dim=1, keepdim=True)
    d = torch.einsum("fi,bni->bfn", planes[:, :3], pts)
    d = torch.where(point_valid[:, None, :], d, torch.inf)
    w = -d.amin(dim=2)  # (B, 4)

    def line(a, b, k):
        pa = planes[k, a].expand_as(w[:, k])
        pb = planes[k, b].expand_as(w[:, k])
        return torch.stack([pa, pb, w[:, k]], dim=-1)

    lr_x, lr_z = _intersect_2d(line(0, 2, 0), line(0, 2, 1))
    tb_y, tb_z = _intersect_2d(line(1, 2, 2), line(1, 2, 3))
    cam_pos_work = torch.stack([lr_x, tb_y, torch.minimum(lr_z, tb_z)], dim=-1)
    return torch.einsum("bij,bj->bi", cam_rot, cam_pos_work)


def choose_random_camera_pose(
    u: torch.Tensor, P: torch.Tensor, points: torch.Tensor, point_valid: torch.Tensor
) -> torch.Tensor:
    """(B, 4, 4) camera-to-world poses; ``u`` (B, 2) from ``camera_uniforms``."""
    R = camera_rotation(u, points.device)
    fallback = torch.einsum("bij,j->bi", R, torch.tensor([0.0, 0.0, -1.0], device=R.device))
    pos = torch.where(
        point_valid.any(dim=1, keepdim=True), fit_camera_position(R, P, points, point_valid), fallback
    )
    return m.make_transform(R, pos)


def light_normals(batch: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 3) standard normals of ``choose_random_light_direction``, on the CPU."""
    return torch.randn((batch, 3), generator=generator, dtype=torch.float32)


def choose_random_light_direction(r: torch.Tensor, cam_pose: torch.Tensor) -> torch.Tensor:
    """(B, 3) world light directions: from above, on the camera side; ``r``
    (B, 3) from ``light_normals``."""
    r = r.to(cam_pose.device)
    random_direction = m.normalize(torch.stack([r[:, 0], -r[:, 1].abs(), -r[:, 2].abs()], dim=-1))
    return torch.einsum("bij,bj->bi", cam_pose[:, :3, :3], -random_direction)
