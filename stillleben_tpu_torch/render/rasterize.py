"""Geometry stage and the brute-force rasterizer (the exact oracle).

Counterpart of ``stillleben_tpu/render/rasterize.py``: ``geometry_stage``
transforms every instanced vertex (reference render_shader.vert), and
``rasterize`` z-buffers every triangle against every pixel with 2D
homogeneous edge functions. The tiled cell raster
(``rasterize_tiled.py``) must agree with it.

The JAX package runs the transforms as einsums at ``precision="highest"``;
here they are float32 products (callers keep TF32 off on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from .atlas import RenderInputs, SceneAtlas
from .camera import DEFAULT_FAR, DEFAULT_NEAR


class GeometryBuffers(NamedTuple):
    """Per-instanced-vertex frame data (VI, ...)."""

    obj_coords: torch.Tensor  # (VI, 3) object-frame coords
    world: torch.Tensor  # (VI, 3)
    cam: torch.Tensor  # (VI, 3)
    pix_hom: torch.Tensor  # (VI, 3) (u*w, v*w, w) pixel-homogeneous
    normal_world: torch.Tensor  # (VI, 3)
    tangent_world: torch.Tensor  # (VI, 3)
    bitangent_world: torch.Tensor  # (VI, 3)
    sticker_uv: torch.Tensor  # (VI, 2)


class GBuffer(NamedTuple):
    tri_id: torch.Tensor  # (H, W) i32, -1 = background
    depth: torch.Tensor  # (H, W) f32 camera z, +inf = background
    bary: torch.Tensor  # (H, W, 3)
    front_facing: torch.Tensor  # (H, W) bool


def _rotate(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) x (V, 3) -> (V, 3), i.e. einsum("vij,vj->vi")."""
    return torch.einsum("vij,vj->vi", M, p)


def geometry_stage(
    atlas: SceneAtlas, inputs: RenderInputs, width: int, height: int
) -> GeometryBuffers:
    """Transform all instanced vertices (rasterize.py:58-121)."""
    o = atlas.vert_obj.long()
    M_mo = inputs.mesh_to_obj[o]
    M_ow = inputs.obj_to_world[o]
    world_to_cam = m.invert_rigid(inputs.cam_pose)

    obj_coords = _rotate(M_mo[:, :3, :3], atlas.positions) + M_mo[:, :3, 3]
    world = _rotate(M_ow[:, :3, :3], obj_coords) + M_ow[:, :3, 3]
    cam = world @ world_to_cam[:3, :3].T + world_to_cam[:3, 3]
    P = inputs.projection
    clip = torch.cat([cam, torch.ones_like(cam[:, :1])], -1) @ P[:3].T  # (VI, 3)
    w = cam[:, 2]
    px = (clip[:, 0] + w) * (width / 2.0)
    py = (clip[:, 1] + w) * (height / 2.0)
    pix_hom = torch.stack([px, py, w], dim=-1)

    N_ow = M_ow[:, :3, :3]
    N_mo = M_mo[:, :3, :3]
    normal_world = m.normalize(_rotate(N_ow, _rotate(N_mo, atlas.normals)))
    tangent_world = m.normalize(_rotate(N_ow, _rotate(N_mo, atlas.tangents[:, :3])))
    bitangent_world = (
        m.normalize(m.cross(normal_world, tangent_world)) * atlas.tangents[:, 3:4]
    )

    # sticker frame (reference render_shader.vert:90-94)
    sp = inputs.sticker_vp[o]
    st4 = torch.einsum(
        "vij,vj->vi", sp, torch.cat([obj_coords, torch.ones_like(obj_coords[:, :1])], -1)
    )
    w4 = st4[:, 3:4]
    st = st4[:, :2] / torch.where(w4.abs() < 1e-9, torch.full_like(w4, 1e-9), w4)
    rng = inputs.sticker_range[o]
    ext = rng[:, 2:]
    sticker_uv = (st - rng[:, :2]) / torch.where(ext.abs() < 1e-9, torch.full_like(ext, 1e9), ext)

    return GeometryBuffers(
        obj_coords=obj_coords, world=world, cam=cam, pix_hom=pix_hom,
        normal_world=normal_world, tangent_world=tangent_world,
        bitangent_world=bitangent_world, sticker_uv=sticker_uv,
    )


def rasterize(
    geom: GeometryBuffers,
    atlas: SceneAtlas,
    inputs: RenderInputs,
    width: int,
    height: int,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    chunk: int = 64,
    min_depth: torch.Tensor | None = None,
) -> GBuffer:
    """Chunked brute-force z-buffer over all (triangle, pixel) pairs
    (rasterize.py:132-236): the exact oracle for the cell raster. Ties in
    depth keep the lowest triangle id. ``min_depth`` (H, W) is the
    depth-peel floor: fragments at or below it by 1e-5 are discarded."""
    faces = atlas.faces.long()
    dev = geom.pix_hom.device
    # hard visibility has no gradient (rasterize.py:229-236): the oracle's
    # G-buffer leaves the graph as the JAX package's does
    v_all = geom.pix_hom.detach()[faces]  # (F, 3, 3)
    vis_all = inputs.obj_visible[atlas.face_obj.long()]
    F = v_all.shape[0]
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    inf = torch.tensor(float("inf"), device=dev)
    best_w = torch.full((height, width), float("inf"), device=dev)
    best_tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    best_bary = torch.zeros((height, width, 3), device=dev)
    best_front = torch.zeros((height, width), dtype=torch.bool, device=dev)
    if min_depth is None:
        min_depth = torch.zeros((height, width), device=dev)

    for base in range(0, F, chunk):
        vc = v_all[base : base + chunk]
        vis = vis_all[base : base + chunk]
        L = torch.stack(
            [m.cross(vc[:, 1], vc[:, 2]), m.cross(vc[:, 2], vc[:, 0]), m.cross(vc[:, 0], vc[:, 1])],
            dim=1,
        )  # (C, 3 edges, 3 coefs)
        E = (
            L[:, :, 0, None, None] * xs[None, None, None, :]
            + L[:, :, 1, None, None] * ys[None, None, :, None]
            + L[:, :, 2, None, None]
        )  # (C, 3, H, W)
        inside = (E >= 0).all(dim=1) | (E <= 0).all(dim=1)
        Esum = E.sum(dim=1)
        denom = torch.where(Esum.abs() < 1e-20, torch.ones_like(Esum), Esum)
        bary = E / denom[:, None]
        wp = (bary * vc[:, :, 2][:, :, None, None]).sum(dim=1)
        ok = (
            inside
            & (Esum.abs() > 1e-20)
            & (wp > near)
            & (wp <= far)
            & (wp > min_depth[None] + 1e-5)
            & vis[:, None, None]
        )
        score = torch.where(ok, wp, inf)
        cw, ci = score.min(dim=0)  # first (lowest) index among equal minima
        cb = torch.gather(bary, 0, ci[None, None].expand(1, 3, height, width))[0]
        cfront = torch.gather(Esum < 0, 0, ci[None])[0]
        better = cw < best_w
        best_bary = torch.where(better[..., None], cb.permute(1, 2, 0), best_bary)
        best_tri = torch.where(better, (base + ci).to(torch.int32), best_tri)
        best_front = torch.where(better, cfront, best_front)
        best_w = torch.where(better, cw, best_w)
    return GBuffer(tri_id=best_tri, depth=best_w, bary=best_bary, front_facing=best_front)
