"""Scene atlas: packed per-template arrays for rendering.

Counterpart of ``stillleben_tpu/render/atlas.py``. ``SceneAtlas`` holds the
static geometry of a scene template (all object instances' vertices and
faces concatenated, the material table, the shadow-caster proxy);
``RenderInputs`` holds what changes per frame (poses, camera, lights).
Field names match the JAX package so tests compare them one by one.

``build_scene_atlas`` is a numpy port of the JAX package's function for untextured,
sticker-free meshes (the datagen slice). A textured material or a sticker
raises. Meshes come from the port's own asset layer (``assets/mesh.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..assets.decimate import decimate_faces
from ..core.tree import tensors_from_numpy

TEXTURE_SIZE = 256
COMBO_CHANNELS = 16
# mip-chain length of one TEXTURE_SIZE^2 texture packed flat (atlas.py:34-38)
MIP_TOTAL = sum((TEXTURE_SIZE >> lvl) ** 2 for lvl in range(TEXTURE_SIZE.bit_length()))

# Default PBR material colour for meshes without a material: a copy of
# stillleben_tpu/context.py:26-28 (reference src/context.cpp:382-384,
# 0x3bd267ff, a green).
DEFAULT_MATERIAL_COLOR = np.array(
    [0x3B / 255.0, 0xD2 / 255.0, 0x67 / 255.0, 1.0], dtype=np.float32
)

# near-watertight threshold for cull eligibility (atlas.py:257)
CULL_CLOSEDNESS = 0.98
# shadow-caster proxy target in faces (atlas.py:287, SL_SHADOW_PROXY default)
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


def _material(gm) -> dict:
    """Reference defaulting rules (render_shader.cpp:355-378) for an
    untextured material; ``gm`` None means the default material."""
    if gm is None:
        return dict(base=DEFAULT_MATERIAL_COLOR.copy(), emissive=np.zeros(3, np.float32),
                    metallic=0.04, roughness=0.5)
    textures = (gm.base_color_texture, gm.metallic_roughness_texture,
                gm.normal_texture, gm.emissive_texture)
    if any(t >= 0 for t in textures):
        raise NotImplementedError("textured materials are not ported yet")
    return dict(
        base=np.asarray(gm.base_color, np.float32),
        emissive=np.asarray(gm.emissive, np.float32),
        metallic=gm.metallic if gm.has_metallic_factor else 0.04,
        roughness=gm.roughness if gm.has_roughness_factor else 0.5,
    )


def build_scene_atlas_numpy(objects) -> dict:
    """numpy port of ``build_scene_atlas`` (atlas.py:275-578) for untextured
    meshes without stickers or a background plane. ``objects`` are host
    objects with ``.mesh`` (an ``assets.mesh.Mesh``).
    Returns a dict of numpy arrays keyed by SceneAtlas field name."""
    pos_l, nrm_l, uv_l, col_l, tan_l, vid_l, vobj_l = [], [], [], [], [], [], []
    face_l, fobj_l, fmat_l, fcull_l = [], [], [], []
    spos_l, svobj_l, sface_l, sfobj_l, sfcull_l = [], [], [], [], []
    mats: list[dict] = []
    obj_class = []
    closed_cache: dict[int, bool] = {}
    proxy_cache: dict[int, tuple] = {}
    v_off = sv_off = 0

    for oi, obj in enumerate(objects):
        if getattr(obj, "sticker_texture", None) is not None:
            raise NotImplementedError("stickers are not ported yet")
        c = obj.mesh.consolidated
        nv = c.num_vertices
        pos_l.append(c.positions)
        nrm_l.append(c.normals)
        uv_l.append(c.texcoords)
        col_l.append(c.colors)
        tan_l.append(c.tangents)
        vid_l.append(c.vertex_indices.astype(np.int32))
        vobj_l.append(np.full(nv, oi, np.int32))

        if id(c) not in closed_cache:
            closed_cache[id(c)] = _mesh_closedness(c.positions, c.faces) >= CULL_CLOSEDNESS
        cullable = closed_cache[id(c)]

        mat_ids: dict[int, int] = {}
        for sm in c.sub_meshes:
            if sm.material not in mat_ids:
                gm = c.materials[sm.material] if sm.material >= 0 else None
                mats.append(_material(gm))
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

        if id(c) not in proxy_cache:
            proxy_cache[id(c)] = decimate_faces(c.positions, c.faces, SHADOW_PROXY_TARGET)
        sp, sf = proxy_cache[id(c)]
        spos_l.append(np.asarray(sp, np.float32))
        svobj_l.append(np.full(sp.shape[0], oi, np.int32))
        sface_l.append(np.asarray(sf, np.int64) + sv_off)
        sfobj_l.append(np.full(sf.shape[0], oi, np.int32))
        sfcull_l.append(np.full(sf.shape[0], cullable, bool))
        sv_off += sp.shape[0]

    if not pos_l:
        raise ValueError("build_scene_atlas: the scene has no objects")
    # the untextured combo texel: neutral fills (atlas.py:196-201), so
    # texture sampling, once ported, is a no-op for these materials
    neutral = np.zeros(COMBO_CHANNELS, np.float32)
    neutral[0:6] = 1.0  # base RGBA, roughness and metallic multipliers
    neutral[6:8] = 0.5  # tangent-space normal (0, 0, 1)
    neutral[8:12] = 1.0
    tex_combo = np.tile(neutral, (1, MIP_TOTAL, 1))
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
        mat_alpha_cutoff=np.full(len(mats), 0.5, np.float32),
        mat_base_tex=np.full(len(mats), -1, np.int32),
        mat_mr_tex=np.full(len(mats), -1, np.int32),
        mat_normal_tex=np.full(len(mats), -1, np.int32),
        mat_emissive_tex=np.full(len(mats), -1, np.int32),
        tex_combo=tex_combo,
        mat_combo=np.zeros(len(mats), np.int32),
        sticker_stack=np.zeros((1, 4, 4, 4), np.float32),
        sticker_size=np.full((1, 2), 4.0, np.float32),
        obj_class=np.array(obj_class, np.int32),
        obj_sticker_tex=np.full(len(obj_class), -1, np.int32),
        num_objects=len(obj_class),
        face_cullable=np.concatenate(fcull_l),
        shadow_face_cullable=np.concatenate(sfcull_l),
    )


def build_scene_atlas(objects, device) -> SceneAtlas:
    return tensors_from_numpy(SceneAtlas, build_scene_atlas_numpy(objects), device)


def render_inputs_from_scene(scene, atlas: SceneAtlas, device) -> RenderInputs:
    """Per-frame inputs from a host scene (atlas.py:580-625, no stickers)."""
    nb = atlas.num_objects
    objs = scene.objects
    f32 = np.float32
    obj_to_world = np.tile(np.eye(4, dtype=f32), (nb, 1, 1))
    mesh_to_obj = np.tile(np.eye(4, dtype=f32), (nb, 1, 1))
    for i, o in enumerate(objs):
        obj_to_world[i] = o.pose
        mesh_to_obj[i] = o.mesh.pretransform
    arrays = dict(
        obj_to_world=obj_to_world,
        mesh_to_obj=mesh_to_obj,
        obj_instance=np.array([o.instance_index for o in objs], np.int32),
        obj_metallic=np.array([o.metallic for o in objs], f32),
        obj_roughness=np.array([o.roughness for o in objs], f32),
        obj_visible=np.ones(nb, bool),
        obj_casts_shadows=np.array([o.casts_shadows for o in objs], bool),
        cam_pose=np.asarray(scene.camera_pose, f32),
        projection=np.asarray(scene.projection, f32),
        light_directions=np.asarray(scene.light_directions, f32),
        light_colors=np.asarray(scene.light_colors, f32),
        ambient_light=np.asarray(scene.ambient_light, f32),
        background_color=np.asarray(scene.background_color, f32),
        manual_exposure=np.asarray(scene.manual_exposure, f32),
        sticker_vp=np.tile(np.eye(4, dtype=f32), (nb, 1, 1)),
        sticker_range=np.zeros((nb, 4), f32),
    )
    return tensors_from_numpy(RenderInputs, arrays, device)
