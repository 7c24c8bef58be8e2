"""Camera model: computer-vision-convention perspective projection.

Counterpart of ``stillleben_tpu/render/camera.py:29-73`` (reference
src/scene.cpp:222-271): the camera looks along +Z, clip-space w equals
camera-space z, near = 0.1 and far = 10. Matrices are row-major.
"""

from __future__ import annotations

import torch

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
