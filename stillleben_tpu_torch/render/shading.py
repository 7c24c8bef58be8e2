"""Deferred shading: G-buffer -> PBR colour + all ground-truth buffers.

Counterpart of ``stillleben_tpu/render/shading.py`` (reference
render_shader.frag): ``shading="pbr"`` (and ``"phong"``, the same shader
in the reference) in float32 with mip-mapped material textures (trilinear,
bilinear or anisotropic), stickers, normal mapping, directional lights with
VSM or PCF shadows (or none), the ambient term, the image-based light and
emissive; ``shading="flat"`` shows the base colour unlit. Per-pixel data lives in (C, H, W) channel planes; all
per-face data (the three corners' attributes plus the material and object
constants) is baked into one (F, ROW) table so shading gathers one row per
pixel. Of the JAX package's three texture-sampler evaluation orders only
the default (packed taps) is ported; the other two are TPU layouts.

Outputs keep the reference's clear values: coordinates 3000 where no
object was hit, class and instance 0 there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .atlas import MIP_OFFSETS, MIP_SIZES, MIP_TOTAL, N_MIPS, TEXTURE_SIZE, RenderInputs, SceneAtlas
from .ibl import ibl_term
from .light_map import LightMapData
from .rasterize import GBuffer, GeometryBuffers
from .shadow import shadow_factor_planar, shadow_factor_vsm_planar
from .stages import mark

DIELECTRIC_SPECULAR = 0.04
MIN_ROUGHNESS = 0.045
INVALID = 3000.0  # reference render_pass.cpp:316

# face-row layout (shading.py:51-68): per-vertex block of VS channels
# 0:3 obj_coords, 3:6 world, 6:9 cam, 9:11 uv, 11:14 normal, 14:17 tangent,
# 17:20 bitangent, 20:22 sticker_uv, 22:25 pix_hom, 25 vertex id;
# FACE + 0:4 base colour, 4:7 emissive, 7 metallic, 8 roughness, 9 cutoff,
# 10 combo tex, 11 sticker tex, 12 class, 13 instance, 14/15 tex flags
VS = 26
FACE = 3 * VS
ROW = FACE + 16


class FrameOutputs(NamedTuple):
    hdr: torch.Tensor  # (H, W, 4) linear HDR + alpha
    object_coordinates: torch.Tensor  # (H, W, 4)
    cam_coordinates: torch.Tensor  # (H, W, 4)
    class_index: torch.Tensor  # (H, W) u16
    instance_index: torch.Tensor  # (H, W) u16
    normals: torch.Tensor  # (H, W, 4)
    vertex_indices: torch.Tensor  # (H, W, 3) i32
    barycentric_coeffs: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W)
    valid: torch.Tensor  # (H, W) bool
    discarded: torch.Tensor  # (H, W) bool: geometry hit, alpha cutoff failed
    raster_depth: torch.Tensor  # (H, W) the winner's depth before the discard


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(a, eps=1e-12):
    n2 = _dot3(a, a)
    return a * torch.rsqrt(torch.where(n2 < eps, torch.ones_like(n2), n2))


_MIP_TABLES: dict = {}


def _mip_tables(device):
    """(sizes, offsets) of the packed mip chain as int32 tensors on ``device``."""
    key = str(device)
    if key not in _MIP_TABLES:
        _MIP_TABLES[key] = (
            torch.tensor(MIP_SIZES, dtype=torch.int32, device=device),
            torch.tensor(MIP_OFFSETS, dtype=torch.int32, device=device),
        )
    return _MIP_TABLES[key]


def sample_combo_mip_planar(
    stack: torch.Tensor,  # (NC, MIP_TOTAL, C) flat-packed mip chains
    tex_id: torch.Tensor,  # (H, W) i32
    u: torch.Tensor,
    v: torch.Tensor,
    lod: torch.Tensor,
    trilinear: bool = True,
) -> torch.Tensor:
    """Mip-mapped sample of the packed combo stack -> (C, H, W) planes,
    repeat wrapping (shading.py:176-242, the packed-tap order). Trilinear
    is two bilinear taps and a lerp. All 4 or 8 taps are gathered into one
    (N, taps * C) array, multiplied by their weights (level weight x
    bilinear weight) and summed pairwise over tap blocks: that fixes the
    summation order, which the JAX package's default shares."""
    NC, _, C = stack.shape
    flat = stack.reshape(NC * MIP_TOTAL, C)
    sizes, offs = _mip_tables(stack.device)
    lod = torch.clamp(lod, 0.0, N_MIPS - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    frac = lod - l0.to(torch.float32)
    base = torch.clamp(tex_id, min=0) * MIP_TOTAL
    H, W = u.shape
    N = H * W
    rows, wts = [], []

    def level(li, lw):
        S = sizes[li.long()]  # (H, W) i32 per-pixel level size
        Sf = S.to(torch.float32)
        off = offs[li.long()]
        tu = u * Sf - 0.5
        tv = v * Sf - 0.5
        u0 = torch.floor(tu)
        v0 = torch.floor(tv)
        fu = tu - u0
        fv = tv - v0
        # a floor modulo: u0 is negative for uv < 0
        u0i = torch.remainder(u0.to(torch.int32), S)
        u1i = torch.remainder(u0i + 1, S)
        v0i = torch.remainder(v0.to(torch.int32), S)
        v1i = torch.remainder(v0i + 1, S)
        b = base + off
        rows.extend([b + v0i * S + u0i, b + v0i * S + u1i, b + v1i * S + u0i, b + v1i * S + u1i])
        gu, gv = 1.0 - fu, 1.0 - fv
        wts.extend([lw * gu * gv, lw * fu * gv, lw * gu * fv, lw * fu * fv])

    if trilinear:
        level(l0, 1.0 - frac)
        level(torch.clamp(l0 + 1, max=N_MIPS - 1), frac)
    else:
        level(l0, torch.ones_like(frac))

    T = len(rows)  # 4 or 8
    g = torch.cat([flat[r.reshape(N).long()] for r in rows], dim=-1)  # (N, T*C), tap-major
    w = torch.stack([wt.reshape(N) for wt in wts], dim=-1)  # (N, T)
    acc = g * w[:, :, None].expand(N, T, C).reshape(N, T * C)
    while acc.shape[1] > C:  # pairwise sums of the tap blocks
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc.T.reshape(C, H, W)


def sample_sticker_planar(
    stack: torch.Tensor,  # (NS, SH, SW, 4) stickers padded to the largest
    sizes: torch.Tensor,  # (NS, 2) native (w, h) of each sticker
    tex_id: torch.Tensor,  # (H, W) i32
    u: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Native-resolution bilinear sticker sample -> (4, H, W), clamp to a
    transparent border (shading.py:309-347; reference src/object.cpp:494-513
    RectangleTexture, src/context.cpp:567-597 border colour 0)."""
    NS, SH, SW, C = stack.shape
    flat = stack.reshape(NS * SH * SW, C)
    ti = torch.clamp(tex_id, min=0)
    wh = sizes[ti.long()]  # (H, W, 2)
    w = wh[..., 0]
    h = wh[..., 1]
    wi = w.to(torch.int32)
    hi = h.to(torch.int32)
    tu = u * w - 0.5
    tv = v * h - 0.5
    u0 = torch.floor(tu)
    v0 = torch.floor(tv)
    fu = (tu - u0)[..., None]
    fv = (tv - v0)[..., None]
    u0i = u0.to(torch.int32)
    v0i = v0.to(torch.int32)
    base = ti * (SH * SW)

    def tap(vi, ui):
        inside = (ui >= 0) & (ui < wi) & (vi >= 0) & (vi < hi)
        uc = torch.clamp(ui, 0, SW - 1)
        vc = torch.clamp(vi, 0, SH - 1)
        return flat[(base + vc * SW + uc).long()] * inside[..., None]

    c00 = tap(v0i, u0i)
    c10 = tap(v0i, u0i + 1)
    c01 = tap(v0i + 1, u0i)
    c11 = tap(v0i + 1, u0i + 1)
    out = (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv
    return out.permute(2, 0, 1)


def _ggx_distribution(NdotH, roughness):
    a = roughness * roughness
    a2 = a * a
    denom = NdotH * NdotH * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=1e-12)


def _geometry_smith(NdotV, NdotL, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    g1 = NdotV / torch.clamp(NdotV * (1.0 - k) + k, min=1e-9)
    g2 = NdotL / torch.clamp(NdotL * (1.0 - k) + k, min=1e-9)
    return g1 * g2


def build_face_rows(atlas: SceneAtlas, inputs: RenderInputs, geom: GeometryBuffers) -> torch.Tensor:
    """Bake everything shading needs into one (F, ROW) table
    (shading.py:365-451, without the TPU's padded-row gather)."""
    vert_pack = torch.cat(
        [
            geom.obj_coords, geom.world, geom.cam, atlas.texcoords,
            geom.normal_world, geom.tangent_world, geom.bitangent_world,
            geom.sticker_uv, geom.pix_hom, atlas.vertex_index[:, None].float(),
        ],
        dim=-1,
    )  # (VI, VS)
    F = atlas.faces.shape[0]
    corners = vert_pack[atlas.faces.long().reshape(-1)].reshape(F, 3 * VS)

    mat_pack = torch.cat(
        [
            atlas.mat_base_color, atlas.mat_emissive, atlas.mat_metallic[:, None],
            atlas.mat_roughness[:, None], atlas.mat_alpha_cutoff[:, None],
            atlas.mat_combo[:, None].float(), (atlas.mat_mr_tex >= 0).float()[:, None],
        ],
        dim=1,
    )
    obj_pack = torch.stack(
        [
            inputs.obj_metallic.float(), inputs.obj_roughness.float(),
            atlas.obj_sticker_tex.float(), atlas.obj_class.float(),
            inputs.obj_instance.float(),
        ],
        dim=1,
    )
    pm = mat_pack[atlas.face_mat.long()]  # (F, 12)
    po = obj_pack[atlas.face_obj.long()]  # (F, 5)
    o_met, o_rough, has_mr_tex = po[:, 0], po[:, 1], pm[:, 11]
    met = torch.where(o_met >= 0, o_met, pm[:, 7])
    rough = torch.where(o_rough >= 0, o_rough, pm[:, 8])
    zero = torch.zeros_like(has_mr_tex)
    rough_flag = torch.where(o_rough >= 0, zero, has_mr_tex)
    met_flag = torch.where(o_met >= 0, zero, has_mr_tex)
    face_extra = torch.cat(
        [
            pm[:, 0:4], pm[:, 4:7], met[:, None], rough[:, None], pm[:, 9:10],
            pm[:, 10:11], po[:, 2:3], po[:, 3:4], po[:, 4:5],
            rough_flag[:, None], met_flag[:, None],
        ],
        dim=1,
    )
    return torch.cat([corners, face_extra], dim=1)  # (F, ROW)


def shade(
    atlas: SceneAtlas,
    inputs: RenderInputs,
    geom: GeometryBuffers,
    gbuf: GBuffer,
    shadow_maps: torch.Tensor | None,  # (L, S, S, 2) VSM moments | (L, S, S) depth | None
    shadow_matrices: torch.Tensor | None,  # (L, 4, 4)
    max_lights: int = 3,
    light_map: LightMapData | None = None,
    sample_textures: bool = True,
    sample_stickers: bool = True,
    texture_filter: str = "trilinear",  # | "bilinear" (one mip tap) | "aniso"
    aniso_taps: int = 4,
    shading: str = "pbr",  # | "phong" (the same shader) | "flat"
    shadow_mode: str = "vsm",  # the maps' kind: "vsm" | "pcf"
    vsm_taps: int = 4,
    ibl_prefilter: str = "trilinear",
    ibl_sh: bool = True,
) -> FrameOutputs:
    """Shading in float32 (shading.py:454-806). ``texture_filter="aniso"``
    takes the LOD from the minor axis of the pixel's uv footprint and
    averages ``aniso_taps`` trilinear taps along the major axis (reference
    context.cpp:635). Without shadow maps no light is shadowed;
    ``shading="flat"`` outputs the (textured, stickered) base colour with
    no light at all (shading.py:744-746). ``vsm_taps``, ``ibl_prefilter``
    and ``ibl_sh`` pick the lookups of ``shadow.shadow_factor_vsm_planar``
    and ``ibl.ibl_term``."""
    H, W = gbuf.tri_id.shape
    dev = gbuf.tri_id.device
    valid = gbuf.tri_id >= 0
    tri = torch.clamp(gbuf.tri_id, min=0).long().reshape(-1)

    rows = build_face_rows(atlas, inputs, geom)
    ch = rows[tri].T.reshape(ROW, H, W)  # the per-pixel gather, planarized
    mark("face rows + gather")

    def vblk(v, a, b):
        return ch[v * VS + a : v * VS + b]

    # barycentrics recomputed from the winner's homogeneous edge functions
    ph = [vblk(v, 22, 25) for v in range(3)]
    X = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(H, W)
    Y = (torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5).expand(H, W)

    def edge(a, b):  # E(p) = cross(a, b) . (x, y, 1); lx, ly are dE/dx, dE/dy
        lx = a[1] * b[2] - a[2] * b[1]
        ly = a[2] * b[0] - a[0] * b[2]
        lc = a[0] * b[1] - a[1] * b[0]
        return lx * X + ly * Y + lc, lx, ly

    E0, lx0, ly0 = edge(ph[1], ph[2])
    E1, lx1, ly1 = edge(ph[2], ph[0])
    E2, lx2, ly2 = edge(ph[0], ph[1])
    Esum = E0 + E1 + E2
    denom = torch.where(Esum.abs() < 1e-20, torch.ones_like(Esum), Esum)
    b0, b1, b2 = E0 / denom, E1 / denom, E2 / denom
    front = (Esum < 0) & valid

    def interp(a, b):
        return vblk(0, a, b) * b0 + vblk(1, a, b) * b1 + vblk(2, a, b) * b2

    obj_coords = interp(0, 3)
    world = interp(3, 6)
    cam_coords = interp(6, 9)
    uv = interp(9, 11)
    n_world = _normalize3(interp(11, 14))
    t_world = interp(14, 17)
    bt_world = interp(17, 20)
    sticker_uv = interp(20, 22)
    depth = cam_coords[2]
    mark("barycentrics + interpolation")

    base_color = ch[FACE + 0 : FACE + 4]
    emissive = ch[FACE + 4 : FACE + 7]
    metallic = ch[FACE + 7]
    roughness = ch[FACE + 8]
    cutoff = ch[FACE + 9]

    if sample_textures:
        combo = torch.round(ch[FACE + 10]).to(torch.int32)
        # analytic screen-space uv derivatives for the mip LOD: with
        # b_i = E_i / Esum, db_i/dx = (dE_i/dx - b_i * dEsum/dx) / Esum
        slx = lx0 + lx1 + lx2
        sly = ly0 + ly1 + ly2
        db_dx = ((lx0 - b0 * slx) / denom, (lx1 - b1 * slx) / denom, (lx2 - b2 * slx) / denom)
        db_dy = ((ly0 - b0 * sly) / denom, (ly1 - b1 * sly) / denom, (ly2 - b2 * sly) / denom)
        uvs = [vblk(i, 9, 11) for i in range(3)]

        def deriv(db):
            du = uvs[0][0] * db[0] + uvs[1][0] * db[1] + uvs[2][0] * db[2]
            dv = uvs[0][1] * db[0] + uvs[1][1] * db[1] + uvs[2][1] * db[2]
            return du, dv

        du_dx, dv_dx = deriv(db_dx)
        du_dy, dv_dy = deriv(db_dy)
        fx2 = du_dx * du_dx + dv_dx * dv_dx  # screen-x footprint^2 in uv
        fy2 = du_dy * du_dy + dv_dy * dv_dy
        texels2 = float(TEXTURE_SIZE * TEXTURE_SIZE)
        if texture_filter == "aniso":
            major2 = torch.maximum(fx2, fy2)
            minor2 = torch.maximum(torch.minimum(fx2, fy2), major2 / float(aniso_taps * aniso_taps))
            lod = 0.5 * torch.log2(torch.clamp(minor2 * texels2, min=1.0))
            usex = fx2 >= fy2
            dua = torch.where(usex, du_dx, du_dy)
            dva = torch.where(usex, dv_dx, dv_dy)
            tex = None
            for k in range(aniso_taps):
                t = (k + 0.5) / aniso_taps - 0.5
                tap = sample_combo_mip_planar(
                    atlas.tex_combo, combo, uv[0] + t * dua, uv[1] + t * dva, lod, trilinear=True
                )
                tex = tap if tex is None else tex + tap
            tex = tex / aniso_taps  # (16, H, W)
        else:
            foot2 = torch.maximum(fx2, fy2)  # the larger axis footprint^2
            lod = 0.5 * torch.log2(torch.clamp(foot2 * texels2, min=1.0))
            tex = sample_combo_mip_planar(
                atlas.tex_combo, combo, uv[0], uv[1], lod,
                trilinear=(texture_filter == "trilinear"),
            )
        base_color = torch.cat([base_color[:3] * tex[0:3], (base_color[3] * tex[3])[None]], dim=0)
        # neutral fills make these no-ops for layers without a texture; the
        # flags drop the multiplier where a per-object override replaced the factor
        roughness = roughness * (1.0 + ch[FACE + 14] * (tex[4] - 1.0))
        metallic = metallic * (1.0 + ch[FACE + 15] * (tex[5] - 1.0))
        emissive = emissive * tex[9:12]
        nm = tex[6:9] * 2.0 - 1.0  # tangent-space normal (frag:259-270)
        normal = _normalize3(nm[0] * t_world + nm[1] * bt_world + nm[2] * n_world)
    else:
        normal = n_world

    if sample_stickers:  # the sticker blend (frag:248-256)
        sticker_tex = torch.round(ch[FACE + 11]).to(torch.int32)
        in_sticker = (
            (sticker_tex >= 0) & (sticker_uv[0] >= 0) & (sticker_uv[1] >= 0)
            & (sticker_uv[0] < 1) & (sticker_uv[1] < 1)
        )
        st = sample_sticker_planar(
            atlas.sticker_stack, atlas.sticker_size, sticker_tex, sticker_uv[0], sticker_uv[1]
        )
        blend = torch.where(in_sticker, st[3], torch.zeros_like(st[3]))
        base_color = torch.cat(
            [base_color[:3] * (1 - blend) + st[:3] * blend, base_color[3:]], dim=0
        )
    mark("texture sampling")

    alpha_ok = base_color[3] >= cutoff
    roughness = torch.clamp(roughness, min=MIN_ROUGHNESS)
    normal = torch.where(front, normal, -normal)  # back-face flip (frag:272-273)

    cam_position = inputs.cam_pose[:3, 3]
    V = _normalize3(cam_position[:, None, None] - world)
    if shading == "flat":
        color = base_color[:3]
    else:
        NoV = torch.clamp(_dot3(normal, V), 1e-5, 1.0)
        base_l = base_color[:3]
        F0 = DIELECTRIC_SPECULAR * (1.0 - metallic) + base_l * metallic
        Fr = torch.maximum(1.0 - roughness, F0) - F0
        k_S = F0 + Fr * (1.0 - NoV) ** 5

        color = torch.zeros((3, H, W), device=dev)
        for i in range(min(inputs.light_directions.shape[0], max_lights)):
            light_color = inputs.light_colors[i]
            light_dir = inputs.light_directions[i]
            light_on = (light_color != 0).any() & (light_dir != 0).any()
            Ld = -light_dir / torch.clamp(torch.linalg.vector_norm(light_dir), min=1e-12)
            Hv = _normalize3(V + Ld[:, None, None])
            NdotL = torch.clamp(_dot3(normal, Ld[:, None, None]), min=0.0)
            NdotH = torch.clamp(_dot3(normal, Hv), min=0.0)
            NDF = _ggx_distribution(NdotH, roughness)
            G = _geometry_smith(NoV, NdotL, roughness)
            spec = (NDF * G) * k_S / torch.clamp(4.0 * NoV * NdotL, min=1e-3)
            kD = (1.0 - k_S) * (1.0 - metallic)
            if shadow_maps is None:
                inv_shadow = 1.0
            elif shadow_mode == "vsm":
                inv_shadow = shadow_factor_vsm_planar(
                    shadow_maps, shadow_matrices, i, world, vsm_taps
                )
            else:
                inv_shadow = shadow_factor_planar(shadow_maps, shadow_matrices, i, world)
            contrib = (
                inv_shadow * (kD * base_l * (1.0 / math.pi) + spec)
                * light_color[:, None, None] * NdotL
            )
            color = color + contrib * light_on.float()
        color = color + inputs.ambient_light[:, None, None] * base_l
        mark("direct light")

        if light_map is not None:
            # the IBL term is channels-last (cubemap gathers); convert at its edge
            def tohwc(p):
                return p.permute(1, 2, 0)

            c_diff = base_color[:3] * (1.0 - DIELECTRIC_SPECULAR) * (1.0 - metallic)
            ibl = ibl_term(light_map, tohwc(normal), tohwc(V), NoV, roughness, tohwc(F0),
                           tohwc(k_S), tohwc(c_diff), ibl_prefilter, ibl_sh)
            color = color + ibl.permute(2, 0, 1)
            mark("IBL term")
        color = color + emissive

    shown = valid & alpha_ok
    zero = torch.zeros((H, W), device=dev)
    one = torch.ones((H, W), device=dev)
    inval = torch.full((H, W), INVALID, device=dev)

    def sel(p, off=zero):
        return torch.where(shown, p, off)

    hdr = torch.stack([sel(color[0]), sel(color[1]), sel(color[2]), sel(base_color[3])], dim=-1)
    obj_out = torch.stack(
        [sel(obj_coords[0], inval), sel(obj_coords[1], inval), sel(obj_coords[2], inval),
         sel(depth, inval)], dim=-1,
    )
    cam_out = torch.stack(
        [sel(cam_coords[0], inval), sel(cam_coords[1], inval), sel(cam_coords[2], inval),
         sel(one, inval)], dim=-1,
    )
    R = inputs.cam_pose[:3, :3].T  # world -> cam rotation
    n_cam = _normalize3(
        torch.stack([R[r, 0] * normal[0] + R[r, 1] * normal[1] + R[r, 2] * normal[2]
                     for r in range(3)])
    )
    ndv = _dot3(normal, V)
    normals_out = torch.stack([sel(n_cam[0]), sel(n_cam[1]), sel(n_cam[2]), sel(ndv)], dim=-1)

    # u16 through int32: the values are small non-negative integers
    class_out = sel(torch.round(ch[FACE + 12])).to(torch.int32).to(torch.uint16)
    inst_out = sel(torch.round(ch[FACE + 13])).to(torch.int32).to(torch.uint16)
    vidx_out = torch.stack(
        [sel(torch.round(ch[v * VS + 25])) for v in range(3)], dim=-1
    ).to(torch.int32)
    bary_out = torch.stack([sel(b0), sel(b1), sel(b2)], dim=-1)

    return FrameOutputs(
        hdr=hdr, object_coordinates=obj_out, cam_coordinates=cam_out,
        class_index=class_out, instance_index=inst_out, normals=normals_out,
        vertex_indices=vidx_out, barycentric_coeffs=bary_out,
        depth=sel(depth), valid=shown, discarded=valid & ~alpha_ok, raster_depth=depth,
    )
