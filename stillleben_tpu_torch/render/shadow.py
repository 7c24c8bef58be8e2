"""Shadow maps: per-light ortho depth raster, VSM moments or raw depth,
and their lookups.

Counterpart of ``stillleben_tpu/render/shadow.py``: ``render_shadow_maps``
(:207-301) in both modes (VSM moments, or the raw depth of PCF),
both branches of ``_ortho_rasterize_depth`` (:85-204) with
``_splat_tiny_depth`` (:24-82) and the shadow pass's front-face cull
(``SL_SHADOW_CULL``), ``build_vsm`` (:304-324),
``shadow_factor_vsm_planar`` with 4 bilinear taps or 1 point tap
(``SL_VSM_TAPS``, :331-380) and the 4x4 PCF compare
``shadow_factor_planar`` (:383-404). The depth pass runs the same raster as
the camera (cells or classic), on the decimated caster proxy.

Gradients follow the JAX package path by path: the raster's depth has none
(its line table leaves the graph before the kernel), the classic path's
tiny-triangle splats keep theirs (a differentiable scatter-min, as the JAX
``.at[].min``), and the moments and lookups are differentiable.
"""

from __future__ import annotations

import torch

from ..core import math as m
from .atlas import RenderInputs, SceneAtlas
from .rasterize_tiled import _edge_lines, _compact, rasterize_vertices, rasterize_vertices_cells

SHADOW_BIAS = 3e-5  # reference render_shader.frag:335
VSM_MIN_VARIANCE = 1e-6
VSM_BLEED = 0.3
SHADOW_MODES = ("vsm", "pcf", "off")


def _splat_tiny_depth(
    p: torch.Tensor,  # (F, 3, 3) homogeneous (x, y, 1) shadow-pixel verts
    zf: torch.Tensor,  # (F, 3) light-space depth per vertex
    tiny: torch.Tensor,  # (F,) bool: triangles whose bbox fits the window
    size: int,
    window: int = 2,
) -> torch.Tensor:
    """Exact depth-only z-buffer of sub-window triangles as one scatter-min
    over their window^2 candidate pixels -> (S, S), 1 = far
    (shadow.py:24-82)."""
    n_px = size * size
    x0 = torch.floor(p[..., 0].amin(-1)).to(torch.int32)
    y0 = torch.floor(p[..., 1].amin(-1)).to(torch.int32)
    Lf = _edge_lines(p)
    win = torch.arange(window * window, dtype=torch.int32, device=p.device)
    px = x0[None, :] + (win % window)[:, None]  # (n_win, F)
    py = y0[None, :] + (win // window)[:, None]
    cx = px.to(torch.float32) + 0.5
    cy = py.to(torch.float32) + 0.5
    E0 = Lf[None, :, 0, 0] * cx + Lf[None, :, 0, 1] * cy + Lf[None, :, 0, 2]
    E1 = Lf[None, :, 1, 0] * cx + Lf[None, :, 1, 1] * cy + Lf[None, :, 1, 2]
    E2 = Lf[None, :, 2, 0] * cx + Lf[None, :, 2, 1] * cy + Lf[None, :, 2, 2]
    inside = ((E0 >= 0) & (E1 >= 0) & (E2 >= 0)) | ((E0 <= 0) & (E1 <= 0) & (E2 <= 0))
    Esum = E0 + E1 + E2
    denom = torch.where(Esum.abs() < 1e-20, torch.ones_like(Esum), Esum)
    wp = (E0 * zf[None, :, 0] + E1 * zf[None, :, 1] + E2 * zf[None, :, 2]) / denom
    covers = (
        tiny[None, :] & inside & (Esum.abs() > 1e-20) & (wp > 0.0) & (wp <= 1.0)
        & (px >= 0) & (px < size) & (py >= 0) & (py < size)
    )
    pid = torch.where(covers, py * size + px, n_px).reshape(-1).long()  # n_px: dump slot
    img = torch.ones(n_px + 1, device=p.device).scatter_reduce_(
        0, pid, torch.where(covers, wp, 1.0).reshape(-1), "amin"
    )
    return img[:n_px].reshape(size, size)


def _ortho_rasterize_depth(
    xy: torch.Tensor,  # (V, 2) shadow-map pixel coords
    z: torch.Tensor,  # (V,) normalized depth in [0, 1]
    faces: torch.Tensor,  # (F, 3)
    tri_on: torch.Tensor,  # (F,) bool
    size: int,
    raster: str = "cells",
    tiles_per_cell: int = 1,
    tri_cullable: torch.Tensor | None = None,
    classic_fine: str = "kernel",
) -> torch.Tensor:
    """Depth-only ortho raster -> (size, size) min-depth map (1 = far).

    Cells: tiles of 32 px for maps >= 1024^2 (else 16) and cells of 128
    triangles, the JAX package's values off the TPU (shadow.py:137,140).
    Classic (shadow.py:162-204): sub-2-px triangles and the compacted
    2-4-px class are splatted exactly; the rest goes through the span-class
    raster with 64-px tiles for maps >= 1024^2 (else 16); the map is the
    minimum of the three. ``tri_cullable`` (F,) turns on the reference's
    shadow-pass front-face cull (render_pass.cpp:428-429): only the faces
    of closed meshes turned away from the light write depth. The cell path
    culls in its classification (``cull_sign`` +1); the classic path's
    splat classes bypass that, so it drops the culled faces from ``tri_on``
    up front (shadow.py:152-160). ``classic_fine`` picks the binned rest's
    fine stage (``rasterize_vertices``' ``fine``; JAX: ``use_pallas``)."""
    faces = faces.long()
    p = torch.cat([xy, torch.ones_like(xy[:, :1])], -1)[faces]  # (F, 3, 3), w == 1
    zf = z[faces]
    if raster == "cells":
        tile = 32 if size >= 1024 else 16
        depth_img, _ = rasterize_vertices_cells(
            p, zf, tri_on, size, size, near=-1e-3, far=1.0, big_capacity=16, tile=tile,
            cull_sign=1 if tri_cullable is not None else 0, cull_mask=tri_cullable,
        )
        return torch.clamp(depth_img, max=1.0)

    if tri_cullable is not None:  # ortho: det is twice the signed area
        det = (p[:, 0, :] * m.cross(p[:, 1, :], p[:, 2, :])).sum(dim=-1)
        tri_on = tri_on & (~tri_cullable | (det > 0))

    xmin, xmax = p[..., 0].amin(-1), p[..., 0].amax(-1)
    ymin, ymax = p[..., 1].amin(-1), p[..., 1].amax(-1)
    on_map = (xmax >= 0) & (xmin < size) & (ymax >= 0) & (ymin < size)
    spx = torch.ceil(xmax) - torch.floor(xmin)
    spy = torch.ceil(ymax) - torch.floor(ymin)
    tiny2 = tri_on & on_map & (spx <= 2) & (spy <= 2)
    tiny4 = tri_on & on_map & ~tiny2 & (spx <= 4) & (spy <= 4)
    F = p.shape[0]
    cap4 = int(min(F, max(8192, F // 2)))
    ids4, ok4 = _compact(tiny4, cap4)
    il = ids4.long()
    # the 2-4-px triangles that fit cap4 leave the binned path
    in_splat4 = torch.zeros(F, dtype=torch.bool, device=p.device).index_put_(
        (il[ok4],), torch.ones((), dtype=torch.bool, device=p.device)
    )
    tile = 64 if size >= 1024 else 16
    depth_img, _ = rasterize_vertices(
        p, zf, tri_on & ~tiny2 & ~in_splat4, size, size, near=-1e-3, far=1.0,
        tile_capacity=128, big_capacity=16, fine_chunk=128, pixel_stage=False, tile=tile,
        tiles_per_cell=tiles_per_cell, fine=classic_fine,
    )
    depth_img = torch.minimum(depth_img, _splat_tiny_depth(p, zf, tiny2, size))
    depth_img = torch.minimum(depth_img, _splat_tiny_depth(p[il], zf[il], ok4, size, window=4))
    return torch.clamp(depth_img, max=1.0)


def build_vsm(depth_map: torch.Tensor, taps: int = 4) -> torch.Tensor:
    """4x4 box-prefiltered (E[d], E[d^2]) moments -> (S, S, 2)."""

    def box1d(x, dim):
        acc = x
        for k in range(1, taps):
            acc = acc + torch.roll(x, -k, dims=dim)
        return acc / taps

    d = torch.roll(depth_map, taps // 2, dims=0)
    d = torch.roll(d, taps // 2, dims=1)
    mu = box1d(box1d(d, 0), 1)
    m2 = box1d(box1d(d * d, 0), 1)
    return torch.stack([mu, m2], dim=-1)


def render_shadow_maps(
    atlas: SceneAtlas, inputs: RenderInputs, size: int, max_lights: int,
    raster: str = "cells", tiles_per_cell: int = 1, mode: str = "vsm",
    shadow_cull: bool = False, classic_fine: str = "kernel",
):
    """Returns (maps, matrices (L, 4, 4) world -> (u, v, z)): the maps are
    (L, S, S, 2) VSM moments with ``mode="vsm"``, the (L, S, S) raw depth
    with ``"pcf"``. The light axis is a loop (one depth raster per light,
    an inactive light's map is all far); ``raster`` picks the depth pass's
    raster, as the camera's, and ``classic_fine`` its classic fine stage;
    ``shadow_cull`` the front-face cull (``SL_SHADOW_CULL``) on the closed
    meshes' faces."""
    if mode not in ("vsm", "pcf"):
        raise ValueError(f"render_shadow_maps: mode {mode!r} not in ('vsm', 'pcf')")
    n_lights = min(inputs.light_directions.shape[0], max_lights)
    dev = atlas.shadow_positions.device
    caster = inputs.obj_casts_shadows & inputs.obj_visible
    vert_on = caster[atlas.shadow_vert_obj.long()]
    tri_on = caster[atlas.shadow_face_obj.long()]

    o = atlas.shadow_vert_obj.long()
    M_mo = inputs.mesh_to_obj[o]
    M_ow = inputs.obj_to_world[o]
    obj_coords = torch.einsum("vij,vj->vi", M_mo[:, :3, :3], atlas.shadow_positions) + M_mo[:, :3, 3]
    world = torch.einsum("vij,vj->vi", M_ow[:, :3, :3], obj_coords) + M_ow[:, :3, 3]
    big = 1e9
    lo = torch.where(vert_on[:, None], world, big).amin(dim=0)
    hi = torch.where(vert_on[:, None], world, -big).amax(dim=0)
    center = 0.5 * (lo + hi)
    radius = torch.clamp(0.5 * torch.linalg.vector_norm(hi - lo), min=1e-3)

    maps, mats = [], []
    for i in range(n_lights):
        light_dir = inputs.light_directions[i]
        light_color = inputs.light_colors[i]
        light_on = (light_dir != 0).any() & (light_color != 0).any()
        zax = m.normalize(light_dir)
        up = torch.where(
            zax[2].abs() < 0.9,
            torch.tensor([0.0, 0.0, 1.0], device=dev),
            torch.tensor([1.0, 0.0, 0.0], device=dev),
        )
        xax = m.normalize(m.cross(up, zax))
        yax = m.cross(zax, xax)
        eye = center - zax * (2.0 * radius)
        R = torch.stack([xax, yax, zax], dim=1)  # light-to-world
        world_to_light = m.invert_rigid(m.make_transform(R, eye))

        wl = world @ world_to_light[:3, :3].T + world_to_light[:3, 3]
        ext = radius * 1.05
        zmax = 5.0 * 2.0 * radius
        u = (wl[:, 0] / ext * 0.5 + 0.5) * size
        v = (wl[:, 1] / ext * 0.5 + 0.5) * size
        z = torch.clamp(wl[:, 2] / zmax, 0.0, 1.0)
        d = _ortho_rasterize_depth(
            torch.stack([u, v], -1), z, atlas.shadow_faces, tri_on, size, raster, tiles_per_cell,
            atlas.shadow_face_cullable if shadow_cull else None, classic_fine,
        )
        m_on = build_vsm(d) if mode == "vsm" else d
        maps.append(torch.where(light_on, m_on, torch.ones_like(m_on)))

        A = torch.zeros((4, 4), device=dev)
        A[0, :3] = world_to_light[0, :3] / ext * 0.5 * size
        A[0, 3] = (world_to_light[0, 3] / ext * 0.5 + 0.5) * size
        A[1, :3] = world_to_light[1, :3] / ext * 0.5 * size
        A[1, 3] = (world_to_light[1, 3] / ext * 0.5 + 0.5) * size
        A[2, :3] = world_to_light[2, :3] / zmax
        A[2, 3] = world_to_light[2, 3] / zmax
        A[3, 3] = 1.0
        mats.append(A)
    return torch.stack(maps), torch.stack(mats)


def shadow_factor_vsm_planar(
    vsm_maps: torch.Tensor,  # (L, S, S, 2)
    shadow_matrices: torch.Tensor,  # (L, 4, 4)
    light: int,
    world: torch.Tensor,  # (3, H, W) channel planes
    taps: int = 4,
) -> torch.Tensor:
    """Chebyshev upper-bound soft shadow from one bilinear tap of the VSM
    moments (``taps=4``) or from the nearest texel (``taps=1``,
    ``SL_VSM_TAPS=1``: the moments are box-filtered already, so the point
    tap only loses the sub-texel lerp)."""
    S = vsm_maps.shape[1]
    A = shadow_matrices[light]
    u = A[0, 0] * world[0] + A[0, 1] * world[1] + A[0, 2] * world[2] + A[0, 3]
    v = A[1, 0] * world[0] + A[1, 1] * world[1] + A[1, 2] * world[2] + A[1, 3]
    z = A[2, 0] * world[0] + A[2, 1] * world[1] + A[2, 2] * world[2] + A[2, 3]
    flat = vsm_maps[light].reshape(S * S, 2)
    tu = u - 0.5
    tv = v - 0.5
    if taps == 1:
        # round half to even, as jnp.round
        ui = torch.clamp(torch.round(tu).to(torch.int64), 0, S - 1)
        vi = torch.clamp(torch.round(tv).to(torch.int64), 0, S - 1)
        mom = flat[vi * S + ui]
    else:
        u0 = torch.floor(tu)
        v0 = torch.floor(tv)
        fu = (tu - u0)[..., None]
        fv = (tv - v0)[..., None]
        u0i = torch.clamp(u0.to(torch.int64), 0, S - 1)
        u1i = torch.clamp(u0i + 1, 0, S - 1)
        v0i = torch.clamp(v0.to(torch.int64), 0, S - 1)
        v1i = torch.clamp(v0i + 1, 0, S - 1)

        def fetch(vi, ui):
            return flat[vi * S + ui]  # (H, W, 2)

        mom = (fetch(v0i, u0i) * (1 - fu) + fetch(v0i, u1i) * fu) * (1 - fv) + (
            fetch(v1i, u0i) * (1 - fu) + fetch(v1i, u1i) * fu
        ) * fv
    mu = mom[..., 0]
    sigma2 = torch.clamp(mom[..., 1] - mu * mu, min=VSM_MIN_VARIANCE)
    dz = torch.clamp(z - SHADOW_BIAS - mu, min=0.0)
    p_max = sigma2 / (sigma2 + dz * dz)
    p = torch.clamp((p_max - VSM_BLEED) / (1.0 - VSM_BLEED), 0.0, 1.0)
    return torch.where(dz <= 0.0, torch.ones_like(p), p)


def shadow_factor_planar(
    shadow_maps: torch.Tensor,  # (L, S, S) raw depth
    shadow_matrices: torch.Tensor,  # (L, 4, 4)
    light: int,
    world: torch.Tensor,  # (3, H, W) channel planes
) -> torch.Tensor:
    """4x4 PCF (reference render_shader.frag:321-338, shadow.py:383-404):
    the mean of 16 depth compares ``z - bias <= stored`` at texel offsets
    of +-0.5 and +-1.5, each coordinate truncated toward zero and clamped
    to the map, as the JAX package's cast does. (H, W), 1 = lit."""
    S = shadow_maps.shape[1]
    A = shadow_matrices[light]
    u = A[0, 0] * world[0] + A[0, 1] * world[1] + A[0, 2] * world[2] + A[0, 3]
    v = A[1, 0] * world[0] + A[1, 1] * world[1] + A[1, 2] * world[2] + A[1, 3]
    z = A[2, 0] * world[0] + A[2, 1] * world[1] + A[2, 2] * world[2] + A[2, 3]
    flat = shadow_maps[light].reshape(-1)
    zb = z - SHADOW_BIAS
    acc = torch.zeros_like(z)
    for dy in (-1.5, -0.5, 0.5, 1.5):
        vi = torch.clamp((v + dy).to(torch.int64), 0, S - 1)
        for dx in (-1.5, -0.5, 0.5, 1.5):
            ui = torch.clamp((u + dx).to(torch.int64), 0, S - 1)
            acc = acc + (zb <= flat[vi * S + ui]).to(torch.float32)
    return acc / 16.0


def shadow_factor(
    shadow_maps: torch.Tensor,  # (L, S, S) raw depth
    shadow_matrices: torch.Tensor,  # (L, 4, 4)
    light: int,
    world: torch.Tensor,  # (H, W, 3)
) -> torch.Tensor:
    """The 4x4 PCF of ``shadow_factor_planar`` on (H, W, 3) world positions
    (JAX shadow.py:407-428, the projection as one product). (H, W) in
    [0, 1], 1 = fully lit."""
    S = shadow_maps.shape[1]
    A = shadow_matrices[light]
    p = torch.einsum("ij,hwj->hwi", A[:3, :3], world) + A[:3, 3]
    u, v, zb = p[..., 0], p[..., 1], p[..., 2] - SHADOW_BIAS
    acc = torch.zeros_like(zb)
    for dy in (-1.5, -0.5, 0.5, 1.5):
        vi = torch.clamp((v + dy).to(torch.int64), 0, S - 1)
        for dx in (-1.5, -0.5, 0.5, 1.5):
            ui = torch.clamp((u + dx).to(torch.int64), 0, S - 1)
            acc = acc + (zb <= shadow_maps[light, vi, ui]).to(torch.float32)
    return acc / 16.0
