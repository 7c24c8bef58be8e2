"""The tabletop arrange-and-settle program.

Counterpart of ``stillleben_tpu/physics/tabletop.py`` (reference
Scene::simulateTableTopScene, src/scene.cpp:612-759): objects are stacked
at increasing z with random orientations, then settled for 100 frames of
4 substeps with redrop of fallen or stuck objects, in one of three contact
cadences, optionally ending each scene at rest early (the sleep exit). The
frame loop is a Python loop over a batch of scenes; JAX ran it as a
``lax.scan`` or ``lax.while_loop`` under ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import math as m
from .contacts import Floor
from .engine import frame_fn, gather_contacts, step_fn
from .types import BodyParams, BodyState, HullAtlas, SolverConfig

FLOOR_TOP_Z = 0.04  # reference BOX_HALF_EXTENTS.z (src/scene.cpp:650)
STACK_BASE_STATIC = 0.4  # starting z when static objects exist (src/scene.cpp:634)
FRAME_TIME = 1.0 / 25.0
SUBSTEPS = 4
MAX_ITERATIONS = 100
REDROP_Z = -0.5
STUCK_SEPARATION = -0.01
STUCK_FRAMES = int(0.4 / FRAME_TIME)  # 10


class TabletopGeom(NamedTuple):
    diameter: torch.Tensor  # (NB,) bbox diagonal (pretransformed)
    bbox_center: torch.Tensor  # (NB, 3) bbox centre in the mesh frame
    dynamic: torch.Tensor  # (NB,) bool


def stack_objects(geom: TabletopGeom, base_z: torch.Tensor, quats: torch.Tensor) -> BodyState:
    """Initial stacked poses (tabletop.py:50-73). ``quats`` (B, NB, 4) are
    the random orientations: ``m.random_quaternion`` from a generator, or
    given by the caller."""
    B, nb = quats.shape[:2]
    dev = quats.device
    d = torch.where(geom.dynamic, geom.diameter, 0.0)
    z = base_z + (torch.cumsum(d, 0) - d) + d / 2.0  # z_i = base + sum_{j<i} d_j + d_i / 2
    center_pos = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], dim=-1)
    R = m.quat_to_matrix(quats)
    pos = center_pos - torch.einsum("bnij,nj->bni", R, geom.bbox_center)
    dyn = geom.dynamic[None, :, None]
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    zeros = torch.zeros((B, nb, 3), device=dev)
    return BodyState(
        pos=torch.where(dyn, pos, 0.0),
        quat=torch.where(dyn, quats, identity),
        lin_vel=zeros,
        ang_vel=zeros.clone(),
    )


def _redrop(state: BodyState, geom: TabletopGeom, which: torch.Tensor) -> BodyState:
    """Teleport flagged objects above the pile at x = y = 0
    (reference redropObject, src/scene.cpp:686-711)."""
    R = m.quat_to_matrix(state.quat)
    rc = torch.einsum("bnij,nj->bni", R, geom.bbox_center)
    r = geom.diameter / 2.0
    top = torch.where(geom.dynamic, (state.pos + rc)[..., 2] + r, -torch.inf)  # (B, NB)
    nb = top.shape[1]
    eye = torch.eye(nb, dtype=torch.bool, device=top.device)
    others_top = torch.where(eye, -torch.inf, top[:, None, :]).amax(dim=2)
    max_z = torch.clamp(others_top, min=0.0)
    new_z = max_z - (rc[..., 2] - r)
    new_pos = torch.stack([torch.zeros_like(new_z), torch.zeros_like(new_z), new_z], dim=-1)
    w = which[..., None]
    return BodyState(
        pos=torch.where(w, new_pos, state.pos),
        quat=state.quat,
        lin_vel=torch.where(w, 0.0, state.lin_vel),
        ang_vel=torch.where(w, 0.0, state.ang_vel),
    )


def settle(
    atlas: HullAtlas,
    params: BodyParams,
    state: BodyState,
    floor: Floor,
    pairs: torch.Tensor,
    geom: TabletopGeom,
    cfg: SolverConfig,
    iterations: int = MAX_ITERATIONS,
    substeps: int = SUBSTEPS,
) -> BodyState:
    """The settle loop with redrop (tabletop.py:102-237); see
    ``settle_with_stop``."""
    return settle_with_stop(atlas, params, state, floor, pairs, geom, cfg, iterations, substeps)[0]


def settle_with_stop(
    atlas: HullAtlas,
    params: BodyParams,
    state: BodyState,
    floor: Floor,
    pairs: torch.Tensor,
    geom: TabletopGeom,
    cfg: SolverConfig,
    iterations: int = MAX_ITERATIONS,
    substeps: int = SUBSTEPS,
) -> tuple[BodyState, torch.Tensor]:
    """The settle loop with redrop, in ``cfg.contact_gen``'s cadence
    (tabletop.py:127-196). Returns the state and each scene's stop frame
    (B,): the frames it ran.

    With ``cfg.sleep_frames`` > 0 a scene stops once every valid dynamic
    body has stayed below the sleep velocities for that many consecutive
    frames without a redrop (tabletop.py:199-237). The JAX package's
    ``while_loop`` under ``vmap`` masks finished lanes; here every carried
    field of a finished scene is held by a per-scene mask, so each scene
    keeps the carry of its own stop frame while the others go on. The loop
    reads one flag from the device per frame, to end when every scene
    has stopped."""
    cfg.check()
    if cfg.contact_gen == "every2" and substeps > 1 and substeps % 2 != 0:
        raise ValueError(
            "contact_gen='every2' needs an even substep count "
            f"(got {substeps}): odd counts would silently run substeps//2*2 coarser substeps"
        )
    dev = state.pos.device
    sub_dt = FRAME_TIME / substeps
    B, nb = state.pos.shape[:2]
    c0 = gather_contacts(atlas, params, state, floor, pairs, cfg.max_narrow_pairs)
    acc = (torch.zeros_like(c0.depth),) * 3
    stuck = torch.zeros((B, nb), dtype=torch.int32, device=dev)

    def frame(st, stuck, acc):
        min_sep = torch.full((B, nb), torch.inf, device=dev)
        if cfg.contact_gen == "substep":
            for _ in range(substeps):
                st, rep, acc = step_fn(atlas, params, st, floor, pairs, sub_dt, cfg, warm=acc)
                min_sep = torch.minimum(min_sep, rep.min_separation)
        else:  # "frame": one generation per frame; "every2": one per two substeps
            n_blocks = 1 if cfg.contact_gen == "frame" else max(substeps // 2, 1)
            for _ in range(n_blocks):
                st, rep, acc = frame_fn(atlas, params, st, floor, pairs, FRAME_TIME / n_blocks,
                                        substeps // n_blocks, cfg, warm=acc)
                min_sep = torch.minimum(min_sep, rep.min_separation)
        fallen = st.pos[..., 2] < REDROP_Z
        stuck = torch.where(min_sep < STUCK_SEPARATION, stuck + 1, torch.clamp(stuck - 1, min=0))
        redrop = (fallen | (stuck > STUCK_FRAMES)) & geom.dynamic & params.valid
        st = _redrop(st, geom, redrop)
        # a teleported body's cached impulses are stale: drop the scene's
        any_redrop = redrop.any(dim=1)
        acc = tuple(torch.where(any_redrop[:, None], 0.0, a) for a in acc)
        stuck = torch.where(redrop, 0, stuck)
        return st, stuck, acc, any_redrop

    if cfg.sleep_frames <= 0:  # the reference's fixed schedule
        for _ in range(iterations):
            state, stuck, acc, _ = frame(state, stuck, acc)
        return state, torch.full((B,), iterations, dtype=torch.int32, device=dev)

    watched = geom.dynamic & params.valid
    quiet = torch.zeros(B, dtype=torch.int32, device=dev)
    stop = torch.zeros(B, dtype=torch.int32, device=dev)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(iterations):
        st, stuck_n, acc_n, any_redrop = frame(state, stuck, acc)
        moving = ((torch.linalg.vector_norm(st.lin_vel, dim=-1) > cfg.sleep_lin_vel)
                  | (torch.linalg.vector_norm(st.ang_vel, dim=-1) > cfg.sleep_ang_vel))
        asleep = ~(moving & watched).any(dim=1) & ~any_redrop
        run3 = running[:, None, None]
        state = BodyState(*(torch.where(run3, a, b) for a, b in zip(st, state)))
        stuck = torch.where(running[:, None], stuck_n, stuck)
        acc = tuple(torch.where(running[:, None], a, b) for a, b in zip(acc_n, acc))
        quiet = torch.where(running, torch.where(asleep, quiet + 1, 0), quiet)
        stop = torch.where(running, i + 1, stop)
        running = running & (quiet < cfg.sleep_frames)
        if not bool(running.any()):
            break
    return state, stop


def simulate_tabletop(
    atlas: HullAtlas,
    params: BodyParams,
    floor: Floor,
    pairs: torch.Tensor,
    geom: TabletopGeom,
    cfg: SolverConfig,
    base_z: torch.Tensor,
    quats: torch.Tensor,
    iterations: int = MAX_ITERATIONS,
    substeps: int = SUBSTEPS,
) -> BodyState:
    """Stack and settle one scene (tabletop.py:240-257). The stack's
    orientations ``quats`` (1, NB, 4) are the caller's, where the JAX
    function draws them from its key (``Scene`` draws them from its
    ``torch.Generator``). ``base_z`` is FLOOR_TOP_Z with the floor,
    STACK_BASE_STATIC without."""
    state = stack_objects(geom, base_z, quats.to(base_z.device))
    return settle(atlas, params, state, floor, pairs, geom, cfg, iterations, substeps)
