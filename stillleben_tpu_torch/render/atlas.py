"""Scene atlas: packed per-template arrays for rendering.

Counterpart of ``stillleben_tpu/render/atlas.py``. ``SceneAtlas`` holds the
static geometry of a scene template (all object instances' vertices and
faces concatenated, the material table, the shadow-caster proxy);
``RenderInputs`` holds what changes per frame (poses, camera, lights).
Field names match the JAX package so tests compare them one by one.

``build_scene_atlas`` is a numpy port of the JAX package's function:
materials with their four texture layers packed into one 16-channel mip
stack (``tex_combo``), stickers at native size, forced vertex colours and
the background plane's slot. Meshes come from the port's own asset layer
(``assets/mesh.py``). Not ported: the quad-packed stack ``tex_combo_quad``
and the bf16 stack (``SL_TEX_DTYPE``), which are TPU layouts.

Combined texture channels: 0:4 base RGBA (linear), 4 roughness multiplier
(glTF G), 5 metallic multiplier (glTF B), 6:9 normal map RGB raw, 9:12
emissive RGB (linear), 12:16 pad. Neutral fills (base 1, multipliers 1,
normal (.5, .5, 1), emissive 1) make a missing layer a no-op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..assets.decimate import decimate_faces
from ..core.tree import tensors_from_numpy

TEXTURE_SIZE = 256  # material textures are resampled to this at mip level 0
COMBO_CHANNELS = 16
# mip-chain packing (atlas.py:34-39): level l is TEXTURE_SIZE >> l texels
# square; the levels of one texture are concatenated flat, row-major per
# level, so texel (l, v, u) of combo c is tex_combo[c, MIP_OFFSETS[l] + v * S_l + u]
MIP_SIZES = tuple(TEXTURE_SIZE >> lvl for lvl in range(TEXTURE_SIZE.bit_length()))
MIP_OFFSETS = tuple(sum(s * s for s in MIP_SIZES[:i]) for i in range(len(MIP_SIZES)))
MIP_TOTAL = MIP_OFFSETS[-1] + 1
N_MIPS = len(MIP_SIZES)

# Default PBR material colour for meshes without a material: a copy of
# stillleben_tpu/context.py:26-28 (reference src/context.cpp:382-384,
# 0x3bd267ff, a green).
DEFAULT_MATERIAL_COLOR = np.array(
    [0x3B / 255.0, 0xD2 / 255.0, 0x67 / 255.0, 1.0], dtype=np.float32
)

# defaults of build_scene_atlas's two modes: the near-watertight threshold
# for cull eligibility (atlas.py:257, SL_CULL_CLOSEDNESS) and the
# shadow-caster proxy target in faces (atlas.py:287, SL_SHADOW_PROXY; 0 =
# the full geometry casts the shadow)
CULL_CLOSEDNESS = 0.98
SHADOW_PROXY_TARGET = 8192


class SceneAtlas(NamedTuple):
    positions: torch.Tensor  # (VI, 3) f32 raw mesh-frame positions
    normals: torch.Tensor  # (VI, 3)
    texcoords: torch.Tensor  # (VI, 2)
    colors: torch.Tensor  # (VI, 4)
    tangents: torch.Tensor  # (VI, 4)
    vertex_index: torch.Tensor  # (VI,) i32 1-based per-mesh global id
    vert_obj: torch.Tensor  # (VI,) i32 object slot of each vertex
    faces: torch.Tensor  # (FI, 3) i32 into the instanced vertex arrays
    face_obj: torch.Tensor  # (FI,) i32
    face_mat: torch.Tensor  # (FI,) i32 into the material table
    shadow_positions: torch.Tensor  # (VS, 3) decimated caster proxy
    shadow_vert_obj: torch.Tensor  # (VS,) i32
    shadow_faces: torch.Tensor  # (FS, 3) i32
    shadow_face_obj: torch.Tensor  # (FS,) i32
    mat_base_color: torch.Tensor  # (NM, 4) f32 linear
    mat_emissive: torch.Tensor  # (NM, 3)
    mat_metallic: torch.Tensor  # (NM,)
    mat_roughness: torch.Tensor  # (NM,)
    mat_alpha_cutoff: torch.Tensor  # (NM,)
    mat_base_tex: torch.Tensor  # (NM,) i32, -1 = none
    mat_mr_tex: torch.Tensor  # (NM,) i32
    mat_normal_tex: torch.Tensor  # (NM,) i32
    mat_emissive_tex: torch.Tensor  # (NM,) i32
    tex_combo: torch.Tensor  # (NC, MIP_TOTAL, 16) f32 packed mip stack
    mat_combo: torch.Tensor  # (NM,) i32
    sticker_stack: torch.Tensor  # (NS, SH, SW, 4) f32
    sticker_size: torch.Tensor  # (NS, 2) f32
    obj_class: torch.Tensor  # (NB,) i32
    obj_sticker_tex: torch.Tensor  # (NB,) i32, -1 = none
    num_objects: int
    face_cullable: torch.Tensor  # (FI,) bool
    shadow_face_cullable: torch.Tensor  # (FS,) bool


class RenderInputs(NamedTuple):
    obj_to_world: torch.Tensor  # (NB, 4, 4) object pose
    mesh_to_obj: torch.Tensor  # (NB, 4, 4) pretransform
    obj_instance: torch.Tensor  # (NB,) i32
    obj_metallic: torch.Tensor  # (NB,) f32 override, -1 = none
    obj_roughness: torch.Tensor  # (NB,)
    obj_visible: torch.Tensor  # (NB,) bool
    obj_casts_shadows: torch.Tensor  # (NB,) bool
    cam_pose: torch.Tensor  # (4, 4) camera-to-world
    projection: torch.Tensor  # (4, 4)
    light_directions: torch.Tensor  # (L, 3) world
    light_colors: torch.Tensor  # (L, 3)
    ambient_light: torch.Tensor  # (3,)
    background_color: torch.Tensor  # (4,)
    manual_exposure: torch.Tensor  # scalar, -1 = auto
    sticker_vp: torch.Tensor  # (NB, 4, 4)
    sticker_range: torch.Tensor  # (NB, 4)


def _resize_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) integer weights of Pillow's BILINEAR resize along
    one axis: a triangle filter whose support grows with the reduction
    factor, normalized per output texel and rounded to 22 fractional bits
    (Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    K = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        K[xx, xmin:xmax] = w / total if total != 0 else w
    return np.trunc(K * (1 << 22) + 0.5)


def _resize_pass(img: np.ndarray, K: np.ndarray, axis: int) -> np.ndarray:
    """One pass of the resize along ``axis``, back to uint8 as Pillow does
    (float64 holds the 30-bit products and their sums exactly)."""
    acc = np.tensordot(K, img.astype(np.float64), axes=([1], [axis]))  # (out, ...)
    acc = np.moveaxis(acc, 0, axis).astype(np.int64) + (1 << 21)
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b.astype(np.int32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W, 4) -> (h, w, 4) for ``size`` (w, h), or (size, size)
    for an int: the numpy equal of
    ``PIL.Image.fromarray(img, "RGBA").resize((w, h), BILINEAR)``. The
    identity at the same size; otherwise colour premultiplied by alpha, a
    horizontal then a vertical pass each rounded to uint8, colour divided
    by alpha again."""
    out_w, out_h = (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    alpha = img[..., 3:4]
    work = np.concatenate([_muldiv255(img[..., :3], alpha), alpha], axis=-1)
    if w != out_w:
        work = _resize_pass(work, _resize_coeffs(w, out_w), axis=1)
    if h != out_h:
        work = _resize_pass(work, _resize_coeffs(h, out_h), axis=0)
    a = work[..., 3:4].astype(np.int32)
    rgb = work[..., :3].astype(np.int32)
    unmul = np.clip(255 * rgb // np.maximum(a, 1), 0, 255)
    rgb = np.where((a == 255) | (a == 0), rgb, unmul)
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


def _resample_texture_raw(img: np.ndarray, size: int = TEXTURE_SIZE) -> np.ndarray:
    """uint8 (H, W, 4) -> (S, S, 4) f32 in [0, 1], no gamma (atlas.py:142-147)."""
    return resize_bilinear_u8(img, size).astype(np.float32) / 255.0


def _mip_chain_packed(stack: np.ndarray) -> np.ndarray:
    """(N, S, S, C) -> (N, MIP_TOTAL, C): 2x2 box-filtered mip chain, the
    levels packed flat (level l at MIP_OFFSETS[l]; atlas.py:150-161)."""
    n, s, _, c = stack.shape
    assert s == TEXTURE_SIZE
    levels = [stack]
    cur = stack
    while cur.shape[1] > 1:
        h = cur.shape[1] // 2
        cur = cur.reshape(n, h, 2, h, 2, c).mean(axis=(2, 4))
        levels.append(cur)
    return np.concatenate([lvl.reshape(n, -1, c) for lvl in levels], axis=1)


def _build_combo_stack(mats, raw_textures, size):
    """Per-material combined texture stack (atlas.py:182-220). Gamma is per
    layer: base and emissive go sRGB -> linear (gamma 2.2); the
    metallic-roughness and normal maps stay raw, they are data."""
    combos: dict[tuple, int] = {}
    combo_list: list[np.ndarray] = []
    mat_combo = []
    for mt in mats:
        key = (mt["base_tex"], mt["mr_tex"], mt["normal_tex"], mt["emissive_tex"])
        if key not in combos:
            c = np.zeros((size, size, COMBO_CHANNELS), np.float32)
            c[..., 0:4] = 1.0
            c[..., 4:6] = 1.0
            c[..., 6:8] = 0.5
            c[..., 8] = 1.0
            c[..., 9:12] = 1.0
            bt, mr, nm, em = key
            if bt >= 0:
                t = raw_textures[bt]
                c[..., 0:3] = t[..., :3] ** 2.2
                c[..., 3] = t[..., 3]
            if mr >= 0:
                t = raw_textures[mr]
                c[..., 4] = t[..., 1]  # glTF: G = roughness
                c[..., 5] = t[..., 2]  # glTF: B = metallic
            if nm >= 0:
                c[..., 6:9] = raw_textures[nm][..., :3]
            if em >= 0:
                c[..., 9:12] = raw_textures[em][..., :3] ** 2.2
            combos[key] = len(combo_list)
            combo_list.append(c)
        mat_combo.append(combos[key])
    return _mip_chain_packed(np.stack(combo_list)), np.array(mat_combo, np.int32)


def _mesh_closedness(positions: np.ndarray, faces: np.ndarray) -> float:
    """Fraction of directed edges whose reverse edge exists exactly once
    (a copy of atlas.py:223-250; vertices canonicalized by position)."""
    if len(faces) == 0:
        return 0.0
    _, remap = np.unique(
        np.round(np.asarray(positions, np.float64), 7), axis=0, return_inverse=True
    )
    f = remap.reshape(-1)[np.asarray(faces, np.int64)]
    d = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    d = d[d[:, 0] != d[:, 1]]
    if len(d) == 0:
        return 0.0
    key = (d[:, 0] << 32) | d[:, 1]
    rkey = (d[:, 1] << 32) | d[:, 0]
    uk, cnt = np.unique(key, return_counts=True)
    if (cnt > 1).mean() > 0.01:
        return 0.0
    pos = np.clip(np.searchsorted(uk, rkey), 0, len(uk) - 1)
    matched = (uk[pos] == rkey) & (cnt[pos] == 1)
    return float(matched.mean())


def has_cutout_materials(atlas: SceneAtlas) -> bool:
    """Host-side check: can any material discard fragments below its alpha
    cutoff (atlas.py:260-272)? Says whether ``FrameConfig.alpha_peel`` has
    anything to do."""
    base = atlas.mat_base_color.cpu().numpy()
    cutoff = atlas.mat_alpha_cutoff.cpu().numpy()
    combo = atlas.mat_combo.cpu().numpy()
    has_tex = atlas.mat_base_tex.cpu().numpy() >= 0
    tex_alpha_min = atlas.tex_combo[:, :, 3].amin(dim=1).cpu().numpy()  # (NC,)
    amin = base[:, 3] * np.where(has_tex, tex_alpha_min[combo], 1.0)
    return bool((amin < cutoff).any())


def _material(gm, images, add_texture) -> dict:
    """Reference defaulting rules (render_shader.cpp:355-378; atlas.py:301-354):
    metallic .04 / roughness .5 by default; a metallic-roughness texture
    promotes both factors to 1.0; explicit factors override. ``gm`` None
    means the default material."""
    if gm is None:
        return dict(base=DEFAULT_MATERIAL_COLOR.copy(), emissive=np.zeros(3, np.float32),
                    metallic=0.04, roughness=0.5, cutoff=0.5,
                    base_tex=-1, mr_tex=-1, normal_tex=-1, emissive_tex=-1)
    metallic, roughness = 0.04, 0.5
    if gm.metallic_roughness_texture >= 0:
        metallic = roughness = 1.0
    if gm.has_metallic_factor:
        metallic = gm.metallic
    if gm.has_roughness_factor:
        roughness = gm.roughness

    def tex(index):
        return add_texture(images[index]) if index >= 0 else -1

    # the four calls in this order: texture ids follow first use
    base_tex = tex(gm.base_color_texture)
    mr_tex = tex(gm.metallic_roughness_texture)
    normal_tex = tex(gm.normal_texture)
    emissive_tex = tex(gm.emissive_texture)
    return dict(
        base=np.asarray(gm.base_color, np.float32), emissive=np.asarray(gm.emissive, np.float32),
        metallic=metallic, roughness=roughness,
        cutoff=0.5,  # reference render_shader.cpp:381 materialParameters[2].x
        base_tex=base_tex, mr_tex=mr_tex, normal_tex=normal_tex, emissive_tex=emissive_tex,
    )


_PLANE_MATERIAL = dict(
    base=np.ones(4, np.float32), emissive=np.zeros(3, np.float32), metallic=0.04, roughness=0.5,
    cutoff=0.5, base_tex=-1, mr_tex=-1, normal_tex=-1, emissive_tex=-1,
)


def build_scene_atlas_numpy(objects, background_plane=None,
                            shadow_proxy_target: int = SHADOW_PROXY_TARGET,
                            cull_closedness: float = CULL_CLOSEDNESS) -> dict:
    """numpy port of ``build_scene_atlas`` (atlas.py:275-578). ``objects``
    are host objects with ``.mesh`` (an ``assets.mesh.Mesh``), optionally a
    ``sticker_texture`` and a forced ``color``. ``background_plane``:
    optional dict(size (2,), texture (H, W, 4) u8 or None); it becomes one
    more object slot with class, instance and vertex id 0, never cullable,
    also in the shadow proxy (reference render_pass.cpp:545-582).
    ``shadow_proxy_target``: faces of each mesh's decimated shadow caster
    (0: the full geometry casts); ``cull_closedness``: the share of
    matched edges from which a mesh's faces may be culled (the JAX
    package's ``SL_SHADOW_PROXY`` and ``SL_CULL_CLOSEDNESS``).
    Returns a dict of numpy arrays keyed by SceneAtlas field name."""
    pos_l, nrm_l, uv_l, col_l, tan_l, vid_l, vobj_l = [], [], [], [], [], [], []
    face_l, fobj_l, fmat_l, fcull_l = [], [], [], []
    spos_l, svobj_l, sface_l, sfobj_l, sfcull_l = [], [], [], [], []
    mats: list[dict] = []
    raw_textures: list[np.ndarray] = []
    tex_cache: dict[int, int] = {}
    sticker_imgs: list[np.ndarray] = []  # native-resolution linear f32
    sticker_cache: dict[int, int] = {}
    sticker_tex_ids = []
    obj_class = []
    closed_cache: dict[tuple, bool] = {}
    proxy_cache: dict[tuple, tuple] = {}
    v_off = sv_off = 0

    def add_texture(img: np.ndarray) -> int:
        if id(img) not in tex_cache:
            tex_cache[id(img)] = len(raw_textures)
            raw_textures.append(_resample_texture_raw(img))
        return tex_cache[id(img)]

    def add_sticker(st) -> int:
        if id(st.pixels) not in sticker_cache:
            sticker_cache[id(st.pixels)] = len(sticker_imgs)
            sticker_imgs.append(st.linear_f32())
        return sticker_cache[id(st.pixels)]

    for oi, obj in enumerate(objects):
        st = getattr(obj, "sticker_texture", None)
        sticker_tex_ids.append(add_sticker(st) if st is not None else -1)
        c = obj.mesh.consolidated
        nv = c.num_vertices
        colors = c.colors
        color = getattr(obj, "color", None)
        if color is not None and getattr(obj, "force_color", False):
            colors = np.tile(np.append(np.asarray(color, np.float32)[:3], 1.0).astype(np.float32),
                             (nv, 1))
        pos_l.append(c.positions)
        nrm_l.append(c.normals)
        uv_l.append(c.texcoords)
        col_l.append(colors)
        tan_l.append(c.tangents)
        vid_l.append(c.vertex_indices.astype(np.int32))
        vobj_l.append(np.full(nv, oi, np.int32))

        key = (id(c), cull_closedness)
        if key not in closed_cache:
            closed_cache[key] = _mesh_closedness(c.positions, c.faces) >= cull_closedness
        cullable = closed_cache[key]

        mat_ids: dict[int, int] = {}
        for sm in c.sub_meshes:
            if sm.material not in mat_ids:
                gm = c.materials[sm.material] if sm.material >= 0 else None
                mats.append(_material(gm, c.images, add_texture))
                mat_ids[sm.material] = len(mats) - 1
            n = sm.face_count
            face_l.append(
                c.faces[sm.face_offset : sm.face_offset + n].astype(np.int64) + v_off
            )
            fobj_l.append(np.full(n, oi, np.int32))
            fmat_l.append(np.full(n, mat_ids[sm.material], np.int32))
            fcull_l.append(np.full(n, cullable, bool))
        obj_class.append(obj.mesh.class_index)
        v_off += nv

        key = (id(c), shadow_proxy_target)
        if key not in proxy_cache:
            proxy_cache[key] = (
                decimate_faces(c.positions, c.faces, shadow_proxy_target)
                if shadow_proxy_target > 0 else (c.positions, np.asarray(c.faces, np.int64))
            )
        sp, sf = proxy_cache[key]
        spos_l.append(np.asarray(sp, np.float32))
        svobj_l.append(np.full(sp.shape[0], oi, np.int32))
        sface_l.append(np.asarray(sf, np.int64) + sv_off)
        sfobj_l.append(np.full(sf.shape[0], oi, np.int32))
        sfcull_l.append(np.full(sf.shape[0], cullable, bool))
        sv_off += sp.shape[0]

    nb = len(obj_class)
    if background_plane is not None and np.any(background_plane["size"]):
        # unit plane scaled by size/2 in XY, drawn at the background plane pose
        sx, sy = (float(s) / 2 for s in background_plane["size"])
        plane_pos = np.array([[-sx, -sy, 0], [sx, -sy, 0], [sx, sy, 0], [-sx, sy, 0]], np.float32)
        quad = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
        pos_l.append(plane_pos)
        nrm_l.append(np.tile([[0.0, 0, 1]], (4, 1)).astype(np.float32))
        uv_l.append(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        col_l.append(np.ones((4, 4), np.float32))
        t = np.zeros((4, 4), np.float32)
        t[:, 0] = 1
        t[:, 3] = 1
        tan_l.append(t)
        vid_l.append(np.zeros(4, np.int32))  # plane vertices get id 0 (background)
        vobj_l.append(np.full(4, nb, np.int32))
        face_l.append(quad + v_off)
        fobj_l.append(np.full(2, nb, np.int32))
        fcull_l.append(np.zeros(2, bool))  # open quad: always two-sided
        tex = background_plane.get("texture")
        mats.append(dict(_PLANE_MATERIAL, base_tex=add_texture(tex) if tex is not None else -1))
        fmat_l.append(np.full(2, len(mats) - 1, np.int32))
        obj_class.append(0)
        sticker_tex_ids.append(-1)
        spos_l.append(plane_pos)
        svobj_l.append(np.full(4, nb, np.int32))
        sface_l.append(quad + sv_off)
        sfobj_l.append(np.full(2, nb, np.int32))
        sfcull_l.append(np.zeros(2, bool))
        nb += 1

    if not pos_l:
        raise ValueError("build_scene_atlas: the scene has no objects")

    # native-resolution stickers padded to the scene's largest (atlas.py:510-521)
    if sticker_imgs:
        sh = max(s.shape[0] for s in sticker_imgs)
        sw = max(s.shape[1] for s in sticker_imgs)
        sticker_stack = np.zeros((len(sticker_imgs), sh, sw, 4), np.float32)
        sticker_size = np.zeros((len(sticker_imgs), 2), np.float32)
        for i, s in enumerate(sticker_imgs):
            sticker_stack[i, : s.shape[0], : s.shape[1]] = s
            sticker_size[i] = (s.shape[1], s.shape[0])
    else:
        sticker_stack = np.zeros((1, 4, 4, 4), np.float32)
        sticker_size = np.full((1, 2), 4.0, np.float32)

    tex_combo, mat_combo = _build_combo_stack(mats, raw_textures, TEXTURE_SIZE)
    return dict(
        positions=np.concatenate(pos_l),
        normals=np.concatenate(nrm_l),
        texcoords=np.concatenate(uv_l),
        colors=np.concatenate(col_l),
        tangents=np.concatenate(tan_l),
        vertex_index=np.concatenate(vid_l),
        vert_obj=np.concatenate(vobj_l),
        faces=np.concatenate(face_l).astype(np.int32),
        face_obj=np.concatenate(fobj_l),
        face_mat=np.concatenate(fmat_l),
        shadow_positions=np.concatenate(spos_l),
        shadow_vert_obj=np.concatenate(svobj_l),
        shadow_faces=np.concatenate(sface_l).astype(np.int32),
        shadow_face_obj=np.concatenate(sfobj_l),
        mat_base_color=np.stack([m["base"] for m in mats]),
        mat_emissive=np.stack([m["emissive"] for m in mats]),
        mat_metallic=np.array([m["metallic"] for m in mats], np.float32),
        mat_roughness=np.array([m["roughness"] for m in mats], np.float32),
        mat_alpha_cutoff=np.array([m["cutoff"] for m in mats], np.float32),
        mat_base_tex=np.array([m["base_tex"] for m in mats], np.int32),
        mat_mr_tex=np.array([m["mr_tex"] for m in mats], np.int32),
        mat_normal_tex=np.array([m["normal_tex"] for m in mats], np.int32),
        mat_emissive_tex=np.array([m["emissive_tex"] for m in mats], np.int32),
        tex_combo=tex_combo,
        mat_combo=mat_combo,
        sticker_stack=sticker_stack,
        sticker_size=sticker_size,
        obj_class=np.array(obj_class, np.int32),
        obj_sticker_tex=np.array(sticker_tex_ids, np.int32),
        num_objects=nb,
        face_cullable=np.concatenate(fcull_l),
        shadow_face_cullable=np.concatenate(sfcull_l),
    )


def build_scene_atlas(objects, device, background_plane=None,
                      shadow_proxy_target: int = SHADOW_PROXY_TARGET,
                      cull_closedness: float = CULL_CLOSEDNESS) -> SceneAtlas:
    return tensors_from_numpy(
        SceneAtlas,
        build_scene_atlas_numpy(objects, background_plane, shadow_proxy_target, cull_closedness),
        device,
    )


def render_inputs_from_scene(scene, atlas: SceneAtlas, device) -> RenderInputs:
    """Per-frame inputs from a host scene (atlas.py:580-625). The arrays
    have ``atlas.num_objects`` rows: with a background plane that is one
    more than the scene's objects, and the last row keeps the defaults
    (instance 0, no overrides, visible, casts shadows) at the plane's pose."""
    nb = atlas.num_objects
    objs = scene.objects
    f32 = np.float32
    obj_to_world = np.tile(np.eye(4, dtype=f32), (nb, 1, 1))
    mesh_to_obj = np.tile(np.eye(4, dtype=f32), (nb, 1, 1))
    instance = np.zeros(nb, np.int32)
    metallic = np.full(nb, -1.0, f32)
    roughness = np.full(nb, -1.0, f32)
    shadows = np.ones(nb, bool)
    sticker_vp = np.tile(np.eye(4, dtype=f32), (nb, 1, 1))
    sticker_range = np.zeros((nb, 4), f32)
    for i, o in enumerate(objs):
        obj_to_world[i] = o.pose()
        mesh_to_obj[i] = o.mesh.pretransform
        instance[i] = o.instance_index
        metallic[i] = o.metallic
        roughness[i] = o.roughness
        shadows[i] = o.casts_shadows
        if o.sticker_texture is not None and np.any(o.sticker_range):
            sticker_vp[i] = o.sticker_view_projection()
            sticker_range[i] = o.sticker_range
    if nb > len(objs):  # the background plane's slot
        obj_to_world[len(objs)] = scene.background_plane_pose
    arrays = dict(
        obj_to_world=obj_to_world,
        mesh_to_obj=mesh_to_obj,
        obj_instance=instance,
        obj_metallic=metallic,
        obj_roughness=roughness,
        obj_visible=np.ones(nb, bool),
        obj_casts_shadows=shadows,
        cam_pose=scene.camera_pose(),
        projection=scene.projection_matrix(),
        light_directions=scene.light_directions.copy(),
        light_colors=scene.light_colors.copy(),
        ambient_light=np.asarray(scene.ambient_light, f32),
        background_color=np.asarray(scene.background_color, f32),
        manual_exposure=np.asarray(scene.manual_exposure, f32),
        sticker_vp=sticker_vp,
        sticker_range=sticker_range,
    )
    return tensors_from_numpy(RenderInputs, arrays, device)
