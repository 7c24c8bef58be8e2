"""Screen-space ambient occlusion and its depth-aware blur.

Counterpart of ``stillleben_tpu/render/ssao.py`` (reference
ssao_shader.frag:13-57: radius 0.1, bias 0.0025, 64 samples with 4x4 tiled
rotation noise; ssao_apply_shader.frag:35-81: bilateral blur, sharpness
300, multiplied into RGB). It changes the colour only; the ground-truth
buffers are not touched. Two modes: "reference", the 64-sample hemisphere
with one gather per sample, and "fast", 40 taps at fixed screen offsets
read by ``torch.roll`` against the centre's tangent plane.
"""

from __future__ import annotations

import numpy as np
import torch

RADIUS = 0.1
BIAS = 0.0025
N_SAMPLES = 64
SHARPNESS = 300.0
N_DIRS = 8
RING_RADII = (2, 4, 8, 16, 28)  # px; the 0.1 m radius spans ~40 px at bench depths


def _make_kernel() -> np.ndarray:
    """Seeded hemisphere samples, biased toward the centre (N_SAMPLES, 3)."""
    rng = np.random.default_rng(1234)
    samples = []
    for i in range(N_SAMPLES):
        v = rng.uniform([-1, -1, 0], [1, 1, 1])
        v = v / max(np.linalg.norm(v), 1e-9)
        v *= rng.uniform(0, 1)
        scale = i / N_SAMPLES
        v *= 0.1 + 0.9 * scale * scale
        samples.append(v)
    return np.asarray(samples, np.float32)


_KERNEL = _make_kernel()


def _noise_rotation(H: int, W: int, device) -> torch.Tensor:
    """4x4 tiled random rotation vectors in the xy plane, (H, W, 2)."""
    rng = np.random.default_rng(99)
    n = rng.uniform(-1, 1, size=(4, 4, 2)).astype(np.float32)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    tiled = np.tile(n, (H // 4 + 1, W // 4 + 1, 1))[:H, :W]
    return torch.from_numpy(np.ascontiguousarray(tiled)).to(device)


def _pixel_scale(projection: torch.Tensor, W: int, H: int):
    fx = projection[0, 0] * W / 2
    fy = projection[1, 1] * H / 2
    cx = (projection[0, 2] + 1) * W / 2
    cy = (projection[1, 2] + 1) * H / 2
    return fx, fy, cx, cy


def compute_ssao(
    cam_coords: torch.Tensor,  # (H, W, 4) view-space position (w unused)
    normals_cam: torch.Tensor,  # (H, W, 4) view-space normal in xyz
    valid: torch.Tensor,  # (H, W)
    projection: torch.Tensor,  # (4, 4)
) -> torch.Tensor:
    """(H, W) ambient occlusion in [0, 1] (1 = open), the reference's
    hemisphere sampler. Depth and validity share one gather: pixels without
    geometry read as +inf, which fails the occlusion compare."""
    H, W = valid.shape
    dev = valid.device
    P = cam_coords[..., :3].permute(2, 0, 1)  # (3, H, W)
    N = normals_cam[..., :3].permute(2, 0, 1)
    noise = _noise_rotation(H, W, dev).permute(2, 0, 1)  # (2, H, W)
    rdotn = noise[0] * N[0] + noise[1] * N[1]
    T = torch.stack([noise[0], noise[1], torch.zeros((H, W), device=dev)]) - N * rdotn
    tn = torch.sqrt(T[0] ** 2 + T[1] ** 2 + T[2] ** 2)
    T = T / torch.clamp(tn, min=1e-9)
    B = torch.linalg.cross(N, T, dim=0)

    depth = P[2]
    depth_v = torch.where(valid, depth, float("inf")).reshape(-1)
    fx, fy, cx, cy = _pixel_scale(projection, W, H)
    occlusion = torch.zeros((H, W), device=dev)
    for k in _KERNEL:
        k0, k1, k2 = float(k[0]), float(k[1]), float(k[2])
        sx = T[0] * k0 + B[0] * k1 + N[0] * k2
        sy = T[1] * k0 + B[1] * k1 + N[1] * k2
        sz = T[2] * k0 + B[2] * k1 + N[2] * k2
        px = P[0] + sx * RADIUS
        py = P[1] + sy * RADIUS
        pz = P[2] + sz * RADIUS
        z = torch.clamp(pz, min=1e-4)
        u = torch.clamp((fx * px / z + cx).to(torch.int32), 0, W - 1)
        v = torch.clamp((fy * py / z + cy).to(torch.int32), 0, H - 1)
        sample_depth = depth_v[(v * W + u).long()]
        range_check = torch.clamp(
            RADIUS / torch.clamp((depth - sample_depth).abs(), min=1e-6), 0, 1
        )
        occluded = sample_depth <= pz - BIAS
        occlusion = occlusion + occluded.to(torch.float32) * range_check
    ao = 1.0 - occlusion / N_SAMPLES
    return torch.where(valid, ao, torch.ones_like(ao))


def compute_ssao_fast(
    cam_coords: torch.Tensor,
    normals_cam: torch.Tensor,
    valid: torch.Tensor,
    projection: torch.Tensor,
) -> torch.Tensor:
    """Static-tap ambient occlusion: 40 ring taps read by ``torch.roll``. A
    tap occludes when its depth lies in front of the centre's tangent
    plane, range-checked like the reference (ssao_shader.frag:44-52). The
    hemisphere's radius follows the depth instead of being fixed in the
    world: a stated deviation, which ``ssao_mode="reference"`` avoids."""
    H, W = valid.shape
    dev = valid.device
    d = torch.where(valid, cam_coords[..., 2], float("inf"))  # what the taps read
    # the centre's depth: 0 where nothing is drawn, so that no intermediate
    # is NaN (inf * 0 in the JAX package's; its ao there is replaced by 1
    # below, and every value at a drawn pixel is the same)
    dc = torch.where(valid, cam_coords[..., 2], 0.0)
    N = normals_cam[..., :3].permute(2, 0, 1)
    fx, fy, _, _ = _pixel_scale(projection, W, H)
    # tangent-plane depth slopes per pixel step (clamped at grazing angles)
    nz = torch.where(N[2].abs() < 0.1, torch.sign(N[2]) * 0.1 + 1e-9, N[2])
    dz_du = torch.clamp(-N[0] / nz * dc / fx, -0.05, 0.05)
    dz_dv = torch.clamp(-N[1] / nz * dc / fy, -0.05, 0.05)
    Xi = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    Yi = torch.arange(H, dtype=torch.int32, device=dev)[:, None]

    occ = torch.zeros((H, W), device=dev)
    wsum = 0.0
    for k in range(N_DIRS):
        ang = 2.0 * np.pi * (k + 0.5) / N_DIRS
        ca, sa = np.cos(ang), np.sin(ang)
        for r in RING_RADII:
            dx = int(round(r * ca))
            dy = int(round(r * sa))
            if dx == 0 and dy == 0:
                continue
            ds = torch.roll(d, (-dy, -dx), dims=(0, 1))
            in_img = (Xi + dx >= 0) & (Xi + dx < W) & (Yi + dy >= 0) & (Yi + dy < H)
            d_exp = dc + dz_du * dx + dz_dv * dy
            occluded = in_img & (d_exp - ds > BIAS) & torch.isfinite(ds)
            rng = torch.clamp(RADIUS / torch.clamp((dc - ds).abs(), min=1e-6), 0.0, 1.0)
            w = 1.0 / (1.0 + 0.08 * r)  # biased toward the centre like the reference kernel
            occ = occ + occluded.to(torch.float32) * rng * w
            wsum += w
    ao = 1.0 - occ / wsum
    return torch.where(valid, ao, torch.ones_like(ao))


def bilateral_blur(ao: torch.Tensor, depth: torch.Tensor, ksize: int = 2) -> torch.Tensor:
    """Depth-aware box blur (reference ssao_apply_shader.frag:35-81)."""
    acc = torch.zeros_like(ao)
    wacc = torch.zeros_like(ao)
    for dy in range(-ksize, ksize + 1):
        for dx in range(-ksize, ksize + 1):
            shifted_ao = torch.roll(ao, (dy, dx), dims=(0, 1))
            shifted_d = torch.roll(depth, (dy, dx), dims=(0, 1))
            w = torch.exp(-SHARPNESS * (shifted_d - depth).abs())
            acc = acc + shifted_ao * w
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-9)


def ssao_apply(hdr, cam_coordinates, normals, valid, projection, mode: str = "fast"):
    """Ambient occlusion from the G-buffer (the camera-space normal of the
    normals buffer), blurred and multiplied into RGB. ``mode``: "fast" or
    "reference"."""
    fn = compute_ssao_fast if mode == "fast" else compute_ssao
    ao = fn(cam_coordinates, normals, valid, projection)
    depth = cam_coordinates[..., 2]
    ao = bilateral_blur(ao, torch.where(valid, depth, torch.zeros_like(depth)))
    return torch.cat([hdr[..., :3] * ao[..., None], hdr[..., 3:]], dim=-1)
