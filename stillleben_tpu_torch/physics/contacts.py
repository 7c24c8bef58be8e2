"""Contact generation: convex hull vs floor plane and hull vs hull (SAT).

Counterpart of ``stillleben_tpu/physics/contacts.py``. Shapes are fixed:
every contact slot exists in every call and carries a validity mask, so
slot k is the same (hull pair, manifold point) from call to call. All
per-contact tensors carry the batch axis: (B, NC, ...).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from .types import BodyParams, BodyState, HullAtlas

CONTACTS_PER_FLOOR_HULL = 4
CONTACTS_PER_PAIR = 8  # 4 deepest of B in A + 4 of A in B
OVERLAP_MARGIN = 0.01  # speculative contact margin of the substep cadence


def _topk_last(x: torch.Tensor, k: int):
    """Descending top-k along the last axis by k masked-max rounds; ties go
    to the lowest index (contacts.py:28-49)."""
    n = x.shape[-1]
    iota = torch.arange(n, device=x.device)
    cur = x
    vals, idxs = [], []
    for _ in range(k):
        v = cur.amax(dim=-1)
        hit = cur == v[..., None]
        i = torch.where(hit, iota, n).amin(dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], -torch.inf, cur)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


class Floor(NamedTuple):
    """The tabletop floor plane z = height (reference src/scene.cpp:640-668)."""

    height: torch.Tensor  # scalar f32
    enabled: torch.Tensor  # scalar bool
    friction: torch.Tensor
    restitution: torch.Tensor
    friction_static: torch.Tensor


def make_floor(height=0.0, enabled=True, friction=0.5, restitution=0.0,
               friction_static=None, device="cuda") -> Floor:
    f32 = dict(dtype=torch.float32, device=device)
    return Floor(
        height=torch.tensor(height, **f32),
        enabled=torch.tensor(bool(enabled), device=device),
        friction=torch.tensor(friction, **f32),
        restitution=torch.tensor(restitution, **f32),
        friction_static=torch.tensor(
            friction if friction_static is None else friction_static, **f32
        ),
    )


class Contacts(NamedTuple):
    point: torch.Tensor  # (B, NC, 3) world position
    normal: torch.Tensor  # (B, NC, 3) unit, from A to B
    depth: torch.Tensor  # (B, NC) penetration (> 0 overlapping)
    body_a: torch.Tensor  # (B, NC) i64, -1 = static environment
    body_b: torch.Tensor  # (B, NC) i64
    valid: torch.Tensor  # (B, NC) bool
    friction: torch.Tensor  # (B, NC) dynamic coefficient
    restitution: torch.Tensor  # (B, NC)
    friction_static: torch.Tensor  # (B, NC)


def hull_pairs_host(hull_body: np.ndarray, hull_valid: np.ndarray) -> np.ndarray:
    """Static candidate pairs (i, j), i < j, of hulls of different bodies."""
    hb = np.asarray(hull_body)
    hv = np.asarray(hull_valid)
    pairs = [
        (i, j)
        for i in range(len(hb))
        for j in range(i + 1, len(hb))
        if hv[i] and hv[j] and hb[i] != hb[j]
    ]
    return np.asarray(pairs or [(0, 0)], np.int32)


def _bgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) and idx (B, M) -> (B, M, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _hull_rot_trans(atlas: HullAtlas, state: BodyState):
    hb = atlas.hull_body.long()
    return m.quat_to_matrix(state.quat[:, hb]), state.pos[:, hb]  # (B, NH, 3, 3), (B, NH, 3)


def world_hull_verts(atlas: HullAtlas, state: BodyState) -> torch.Tensor:
    """(B, NH, VH, 3) hull vertices in world frame."""
    R, t = _hull_rot_trans(atlas, state)
    return torch.einsum("bhij,hvj->bhvi", R, atlas.verts) + t[:, :, None, :]


def world_hull_planes(atlas: HullAtlas, state: BodyState) -> torch.Tensor:
    """(B, NH, PH, 4) face planes in world frame (n.x + d <= 0 inside)."""
    R, t = _hull_rot_trans(atlas, state)
    n_world = torch.einsum("bhij,hpj->bhpi", R, atlas.planes[..., :3])
    d_world = atlas.planes[..., 3] - torch.einsum("bhpi,bhi->bhp", n_world, t)
    return torch.cat([n_world, d_world[..., None]], dim=-1)


def floor_contacts(atlas: HullAtlas, state: BodyState, params: BodyParams, floor: Floor) -> Contacts:
    """Deepest-K vertices of each hull below the floor plane."""
    B = state.pos.shape[0]
    wv = world_hull_verts(atlas, state)
    sep = torch.where(atlas.vert_valid, wv[..., 2] - floor.height, torch.inf)
    k = CONTACTS_PER_FLOOR_HULL
    depth, idx = _topk_last(-sep, k)  # (B, NH, k), deepest first
    pts = torch.gather(wv, 2, idx[..., None].expand(-1, -1, -1, 3))  # (B, NH, k, 3)
    nc = atlas.hull_body.shape[0] * k
    body_b = atlas.hull_body.long().repeat_interleave(k)  # (NC,)
    valid = (
        atlas.hull_valid.repeat_interleave(k)
        & (depth.reshape(B, nc) > -1e9)
        & floor.enabled
        & params.valid[body_b]
        & (params.inv_mass[body_b] > 0)
    )
    mu_d = 0.5 * (params.friction[body_b] + floor.friction)
    mu_s = 0.5 * (params.friction_static[body_b] + floor.friction_static)
    rest = 0.5 * (params.restitution[body_b] + floor.restitution)
    normal = torch.tensor([0.0, 0.0, 1.0], device=wv.device).expand(B, nc, 3)
    return Contacts(
        point=pts.reshape(B, nc, 3), normal=normal, depth=depth.reshape(B, nc),
        body_a=torch.full((B, nc), -1, dtype=torch.long, device=wv.device),
        body_b=body_b.expand(B, nc), valid=valid,
        friction=mu_d.expand(B, nc), restitution=rest.expand(B, nc),
        friction_static=mu_s.expand(B, nc),
    )


def pair_contacts(
    atlas: HullAtlas,
    state: BodyState,
    params: BodyParams,
    pairs: torch.Tensor,  # (NP, 2) static candidate list
    max_narrow_pairs: int,
    overlap_margin: torch.Tensor | float = OVERLAP_MARGIN,
) -> Contacts:
    """SAT face-normal (plus centroid-axis) contacts for hull pairs
    (contacts.py:168-353). A candidate list longer than ``max_narrow_pairs``
    is first cut to the pairs of largest bounding-sphere overlap.
    ``overlap_margin`` is the speculative margin: a float, or a (B,) tensor
    of one margin per scene (the frame cadence scales it with each scene's
    fastest body)."""
    B = state.pos.shape[0]
    hb = atlas.hull_body.long()
    wv = world_hull_verts(atlas, state)  # (B, NH, VH, 3)
    wp = world_hull_planes(atlas, state)  # (B, NH, PH, 4)
    R, t = _hull_rot_trans(atlas, state)
    wc = torch.einsum("bhij,hj->bhi", R, atlas.center) + t  # (B, NH, 3)

    pa = pairs[:, 0].long().expand(B, -1)
    pb = pairs[:, 1].long().expand(B, -1)
    if pairs.shape[0] > max_narrow_pairs:
        d = torch.linalg.vector_norm(_bgather(wc, pa) - _bgather(wc, pb), dim=-1)
        score = atlas.radius[pa] + atlas.radius[pb] - d
        # lax.top_k order: descending, lower index first among ties
        keep = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :max_narrow_pairs]
        pa = torch.gather(pa, 1, keep)
        pb = torch.gather(pb, 1, keep)
    ia, ib = pa, pb  # (B, NP)

    wc_a, wc_b = _bgather(wc, ia), _bgather(wc, ib)
    dist = torch.linalg.vector_norm(wc_a - wc_b, dim=-1)
    margin = overlap_margin[:, None] if torch.is_tensor(overlap_margin) else overlap_margin
    near = dist < atlas.radius[ia] + atlas.radius[ib] + margin
    ba, bb = hb[ia], hb[ib]
    pair_active = (
        near & (ba != bb) & atlas.hull_valid[ia] & atlas.hull_valid[ib]
        & params.valid[ba] & params.valid[bb]
        & ((params.inv_mass[ba] > 0) | (params.inv_mass[bb] > 0))
    )

    wv_a, wv_b = _bgather(wv, ia), _bgather(wv, ib)  # (B, NP, VH, 3)
    wp_a, wp_b = _bgather(wp, ia), _bgather(wp, ib)  # (B, NP, PH, 4)
    vv_a, vv_b = atlas.vert_valid[ia], atlas.vert_valid[ib]  # (B, NP, VH)
    pv_a, pv_b = atlas.plane_valid[ia], atlas.plane_valid[ib]  # (B, NP, PH)

    def face_gaps(planes, plane_valid, verts, vert_valid):
        d = torch.einsum("bnqi,bnvi->bnqv", planes[..., :3], verts) + planes[..., 3][..., None]
        per_plane_gap = torch.where(vert_valid[:, :, None, :], d, torch.inf).amin(dim=3)
        return torch.where(plane_valid, per_plane_gap, -torch.inf)

    gaps_a = face_gaps(wp_a, pv_a, wv_b, vv_b)
    gaps_b = face_gaps(wp_b, pv_b, wv_a, vv_a)
    best_a_gap, best_a_idx = gaps_a.amax(dim=2), gaps_a.argmax(dim=2)
    best_b_gap, best_b_idx = gaps_b.amax(dim=2), gaps_b.argmax(dim=2)

    # centroid axis: the separating candidate for vertex-heavy contacts
    d_c = m.normalize(wc_b - wc_a)  # (B, NP, 3) from A to B
    supp_a = torch.where(vv_a, torch.einsum("bni,bnvi->bnv", d_c, wv_a), -torch.inf).amax(dim=2)
    supp_b = torch.where(vv_b, torch.einsum("bni,bnvi->bnv", d_c, wv_b), torch.inf).amin(dim=2)
    gap_c = supp_b - supp_a

    best_face = torch.maximum(best_a_gap, best_b_gap)
    separation = torch.maximum(best_face, gap_c)
    use_c = gap_c >= best_face
    use_a_face = (best_a_gap >= best_b_gap) & ~use_c
    active = pair_active & (separation < margin)

    def pick(planes, idx):  # (B, NP, PH, 4), (B, NP) -> (B, NP, 4)
        return torch.gather(planes, 2, idx[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]

    p_ref_a = pick(wp_a, best_a_idx)
    p_ref_b = pick(wp_b, best_b_idx)
    p_ref_c = torch.cat([d_c, -supp_a[..., None]], dim=-1)
    p_ref = torch.where(
        use_c[..., None], p_ref_c, torch.where(use_a_face[..., None], p_ref_a, p_ref_b)
    )
    normal = torch.where(
        use_c[..., None], d_c, torch.where(use_a_face[..., None], p_ref_a[..., :3], -p_ref_b[..., :3])
    )

    ref_is_a = use_a_face | use_c
    inc_verts = torch.where(ref_is_a[..., None, None], wv_b, wv_a)
    inc_valid = torch.where(ref_is_a[..., None], vv_b, vv_a)
    depth_ref = -(torch.einsum("bnvi,bni->bnv", inc_verts, p_ref[..., :3]) + p_ref[..., 3:4])
    ref_planes = torch.where(ref_is_a[..., None, None], wp_a, wp_b)
    ref_pvalid = torch.where(ref_is_a[..., None], pv_a, pv_b)
    is_side = ref_pvalid & (
        torch.einsum("bnpi,bni->bnp", ref_planes[..., :3], p_ref[..., :3]).abs() < 0.95
    )
    sd_side = (
        torch.einsum("bnpi,bnvi->bnpv", ref_planes[..., :3], inc_verts) + ref_planes[..., 3][..., None]
    )
    sd_lateral = torch.where(is_side[..., None], sd_side, -torch.inf).amax(dim=2)
    lateral_ok = sd_lateral <= 0.02
    score = torch.where(inc_valid & lateral_ok, depth_ref, -torch.inf)
    has_lateral = torch.isfinite(score).any(dim=2)
    score = torch.where(
        has_lateral[..., None], score, torch.where(inc_valid, depth_ref, -torch.inf)
    )

    k = CONTACTS_PER_PAIR
    depth, idx = _topk_last(score, k)  # (B, NP, k)
    pts = torch.gather(inc_verts, 2, idx[..., None].expand(-1, -1, -1, 3))
    np_pairs = ia.shape[1]
    nc = np_pairs * k
    depth = depth.reshape(B, nc)
    body_a = ba.repeat_interleave(k, dim=1)
    body_b = bb.repeat_interleave(k, dim=1)
    valid = active.repeat_interleave(k, dim=1) & (depth > -margin) & torch.isfinite(depth)
    return Contacts(
        point=pts.reshape(B, nc, 3),
        normal=normal.repeat_interleave(k, dim=1),
        depth=depth,
        body_a=body_a,
        body_b=body_b,
        valid=valid,
        friction=0.5 * (params.friction[body_a] + params.friction[body_b]),
        restitution=0.5 * (params.restitution[body_a] + params.restitution[body_b]),
        friction_static=0.5 * (params.friction_static[body_a] + params.friction_static[body_b]),
    )


def concat_contacts(*groups: Contacts) -> Contacts:
    return Contacts(*(torch.cat(fs, dim=1) for fs in zip(*groups)))
