"""The image-based light's shading term and the skybox.

Counterpart of ``stillleben_tpu/render/ibl.py`` (reference
render_shader.frag:375-394 and background_cube_shader): the specular
radiance is a trilinear sample of the prefiltered chain (two bilinear taps
of adjacent levels and a lerp) or, with ``prefilter="nearest"``
(``SL_IBL_PREFILTER=nearest``), one bilinear tap of the nearest level; the
irradiance is the order-2 spherical-harmonic reconstruction or, with
``sh=False`` (``SL_IBL_SH=0``), a bilinear sample of the irradiance cubemap.
"""

from __future__ import annotations

import torch

from ..core import math as m
from .light_map import (
    PREFILTER_MIPS, LightMapData, eval_irradiance_sh, get_brdf_lut, sample_cubemap,
    sample_cubemap_packed,
)


def _sample_prefilter(lm: LightMapData, dirs: torch.Tensor, lod: torch.Tensor,
                      prefilter: str = "trilinear") -> torch.Tensor:
    """Trilinear between the 5 prefiltered levels (lod in [0, 4]), or the
    nearest level's bilinear tap (``prefilter="nearest"``; torch.round, as
    jnp.round, rounds half to even)."""
    mips = [lm.prefilter_mip(i) for i in range(PREFILTER_MIPS)]
    dev = dirs.device
    counts = [6 * p.shape[1] * p.shape[1] for p in mips]
    sizes = torch.tensor([p.shape[1] for p in mips], dtype=torch.int32, device=dev)
    offsets = torch.tensor([sum(counts[:i]) for i in range(PREFILTER_MIPS)],
                           dtype=torch.int32, device=dev)
    flat = torch.cat([p.reshape(-1, 3) for p in mips], dim=0)
    lod = torch.clamp(lod, 0.0, PREFILTER_MIPS - 1.0)
    if prefilter == "nearest":
        return sample_cubemap_packed(flat, offsets, sizes, dirs, torch.round(lod).to(torch.int32))
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=PREFILTER_MIPS - 1)
    frac = (lod - l0.to(torch.float32))[..., None]
    return (sample_cubemap_packed(flat, offsets, sizes, dirs, l0) * (1.0 - frac)
            + sample_cubemap_packed(flat, offsets, sizes, dirs, l1) * frac)


def _sample_lut(lut: torch.Tensor, NoV: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Nearest texel: the cast truncates toward zero, then the clamp."""
    S = lut.shape[0]
    u = torch.clamp((NoV * S - 0.5).to(torch.int32), 0, S - 1)
    v = torch.clamp((roughness * S - 0.5).to(torch.int32), 0, S - 1)
    return lut[v.long(), u.long()]


def ibl_term(lm: LightMapData, normal, V, NoV, roughness, F0, k_S, c_diff,
             prefilter: str = "trilinear", sh: bool = True):
    """The ambient light of the environment with multiple scattering
    (reference render_shader.frag:375-394). normal, V, F0, k_S, c_diff are
    (H, W, 3); NoV and roughness (H, W). Returns (H, W, 3). ``prefilter``
    and ``sh`` pick the radiance and irradiance lookups (module doc)."""
    f_ab = _sample_lut(get_brdf_lut(normal.device), NoV, roughness)
    lod = roughness * 4.0
    light_dir = 2.0 * (normal * V).sum(-1, keepdim=True) * normal - V  # reflect(-V, n)
    radiance = _sample_prefilter(lm, light_dir, lod, prefilter)
    if sh and lm.irradiance_sh is not None:
        # the SH reconstruction can ring slightly below zero: clamp
        irradiance = torch.clamp(eval_irradiance_sh(lm.irradiance_sh, normal), min=0.0)
    else:
        irradiance = sample_cubemap(lm.irradiance, normal)

    FssEss = k_S * f_ab[..., 0:1] + f_ab[..., 1:2]
    Ems = 1.0 - (f_ab[..., 0:1] + f_ab[..., 1:2])
    F_avg = F0 + (1.0 - F0) / 21.0
    FmsEms = Ems * FssEss * F_avg / (1.0 - F_avg * Ems)
    k_D = c_diff * (1.0 - FssEss - FmsEms)
    return FssEss * radiance + (FmsEms + k_D) * irradiance


def sample_skybox(lm: LightMapData, inputs, width: int, height: int) -> torch.Tensor:
    """Per-pixel camera ray -> cubemap level 0 (background_cube_shader);
    (H, W, 3)."""
    P = inputs.projection
    dev = P.device
    fx = P[0, 0] * width / 2.0
    fy = P[1, 1] * height / 2.0
    cx = (P[0, 2] + 1.0) * width / 2.0
    cy = (P[1, 2] + 1.0) * height / 2.0
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    dir_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    dir_world = torch.einsum("ij,hwj->hwi", inputs.cam_pose[:3, :3], dir_cam)
    return sample_cubemap(lm.cubemap, m.normalize(dir_world))
