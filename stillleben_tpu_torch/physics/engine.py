"""The physics substep: integrate -> collide -> solve -> integrate pose.

Counterpart of ``stillleben_tpu/physics/engine.py``: ``step_fn`` (:102-140),
one substep of the ``substep`` cadence, and ``frame_fn`` (:158-240), one
frame of the ``frame`` cadence (or one two-substep block of ``every2``),
with their helpers; ``step``, ``run_substeps`` and ``simulate_steps``
(:88, :293, :328), loops of ``step_fn`` for the host API, and
``check_overlaps`` (:348). Everything carries the batch axis (B, ...); the
per-scene reductions of the JAX package's vmapped lanes stay per scene.
"""

from __future__ import annotations

import torch

from ..core import math as m
from .contacts import Contacts, Floor, _bgather, concat_contacts, floor_contacts, pair_contacts

# the narrowphase budget of the host API's overlap query (the JAX default
# of pair_contacts, contacts.py:173)
OVERLAP_NARROW_PAIRS = 1024
from .solver import _pull, contact_matrices, position_correction, solve_contacts
from .types import BodyParams, BodyState, ContactReport, HullAtlas, SolverConfig


def _dyn(params: BodyParams) -> torch.Tensor:
    return ((params.inv_mass > 0) & params.valid & ~params.kinematic)[None, :, None]


def integrate_velocities(params: BodyParams, state: BodyState, dt: float, cfg: SolverConfig) -> BodyState:
    dyn = _dyn(params)
    g = torch.tensor(cfg.gravity, dtype=torch.float32, device=state.pos.device)
    lin = torch.where(dyn, state.lin_vel + g * dt, state.lin_vel)
    lin = lin * (1.0 - cfg.linear_damping * dt)
    ang = torch.where(dyn, state.ang_vel * (1.0 - cfg.angular_damping * dt), state.ang_vel)
    speed = torch.linalg.vector_norm(lin, dim=-1, keepdim=True)
    limit = torch.clamp(params.linear_velocity_limit[None, :, None], max=cfg.max_velocity)
    lin = torch.where(speed > limit, lin * (limit / torch.clamp(speed, min=1e-9)), lin)
    spin = torch.linalg.vector_norm(ang, dim=-1, keepdim=True)
    ang = torch.where(
        spin > cfg.max_angular_velocity,
        ang * (cfg.max_angular_velocity / torch.clamp(spin, min=1e-9)), ang,
    )
    return state._replace(lin_vel=lin, ang_vel=ang)


def integrate_poses(params: BodyParams, state: BodyState, dt: float) -> BodyState:
    """Semi-implicit Euler about the COM; the mesh-frame origin follows."""
    dyn = _dyn(params)
    R = m.quat_to_matrix(state.quat)
    com_world = state.pos + torch.einsum("bnij,nj->bni", R, params.com)
    new_com = com_world + torch.where(dyn, state.lin_vel * dt, 0.0)
    w = state.ang_vel
    dq = 0.5 * dt * m.quat_multiply(torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1), state.quat)
    new_quat = m.quat_normalize(state.quat + torch.where(dyn, dq, 0.0))
    new_pos = new_com - torch.einsum("bnij,nj->bni", m.quat_to_matrix(new_quat), params.com)
    return BodyState(
        pos=torch.where(dyn, new_pos, state.pos),
        quat=torch.where(dyn, new_quat, state.quat),
        lin_vel=state.lin_vel,
        ang_vel=state.ang_vel,
    )


def gather_contacts(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
                    pairs: torch.Tensor, max_narrow_pairs: int) -> Contacts:
    fc = floor_contacts(atlas, state, params, floor)
    pc = pair_contacts(atlas, state, params, pairs, max_narrow_pairs)
    return concat_contacts(fc, pc)


def _clamp_velocities(state: BodyState, cfg: SolverConfig) -> BodyState:
    speed = torch.linalg.vector_norm(state.lin_vel, dim=-1, keepdim=True)
    lin = torch.where(
        speed > cfg.max_velocity,
        state.lin_vel * (cfg.max_velocity / torch.clamp(speed, min=1e-9)), state.lin_vel,
    )
    spin = torch.linalg.vector_norm(state.ang_vel, dim=-1, keepdim=True)
    ang = torch.where(
        spin > cfg.max_angular_velocity,
        state.ang_vel * (cfg.max_angular_velocity / torch.clamp(spin, min=1e-9)), state.ang_vel,
    )
    return state._replace(lin_vel=lin, ang_vel=ang)


def _point_velocity(state: BodyState, params: BodyParams, contacts: Contacts, which: str):
    mat_a, mat_b = contact_matrices(contacts, params.inv_mass.shape[0])
    mat = mat_b if which == "b" else mat_a
    com = state.pos + torch.einsum("bnij,nj->bni", m.quat_to_matrix(state.quat), params.com)
    on = (mat.sum(dim=1) > 0)[..., None]
    r = torch.where(on, contacts.point - _pull(mat, com), 0.0)
    v = _pull(mat, state.lin_vel) + m.cross(_pull(mat, state.ang_vel), r)
    return torch.where(on, v, 0.0)


def _body_radius(atlas: HullAtlas, params: BodyParams) -> torch.Tensor:
    nb = params.inv_mass.shape[0]
    r = torch.where(
        atlas.hull_valid, torch.linalg.vector_norm(atlas.center, dim=-1) + atlas.radius, 0.0
    )
    return torch.zeros(nb, device=r.device).scatter_reduce_(
        0, atlas.hull_body.long(), r, "amax"
    )


def _stabilize_resting(state: BodyState, report: ContactReport, body_radius: torch.Tensor) -> BodyState:
    """Bleed off the residual jitter of nearly resting bodies in contact."""
    speed = torch.linalg.vector_norm(state.lin_vel, dim=-1)
    spin = torch.linalg.vector_norm(state.ang_vel, dim=-1)
    resting = (report.min_separation < 5e-3) & (speed + spin * body_radius < 0.15)
    decay = torch.where(resting, 0.6, 1.0)[..., None]
    return state._replace(lin_vel=state.lin_vel * decay, ang_vel=state.ang_vel * decay)


def step_fn(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
            pairs: torch.Tensor, dt: float, cfg: SolverConfig, warm=None):
    """One physics substep (engine.py:102-140). ``warm``: the previous
    step's impulse accumulators, matched by contact slot."""
    state = integrate_velocities(params, state, dt, cfg)
    contacts = gather_contacts(atlas, params, state, floor, pairs, cfg.max_narrow_pairs)
    state, report, acc = solve_contacts(contacts, params, state, dt, cfg, warm=warm)
    state = _clamp_velocities(state, cfg)
    state = integrate_poses(params, state, dt)
    v_b = _point_velocity(state, params, contacts, which="b")
    v_a = _point_velocity(state, params, contacts, which="a")
    vn = ((v_b - v_a) * contacts.normal).sum(dim=-1)
    state = position_correction(contacts._replace(depth=contacts.depth - vn * dt), params, state, cfg)
    state = _stabilize_resting(state, report, _body_radius(atlas, params))
    return state, report, acc


def frame_fn(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
             pairs: torch.Tensor, frame_dt: float, substeps: int, cfg: SolverConfig, warm=None):
    """One frame, TGS-style (engine.py:158-240): the contacts are generated
    once, with a speculative margin covering the frame's travel of each
    scene's fastest body, then reused across ``substeps`` warm-started
    velocity solves, their depths updated from each body's translation plus
    the swing of the contact offsets under its rotation since generation."""
    B, nb = state.pos.shape[:2]
    sub_dt = frame_dt / substeps
    g = torch.tensor(cfg.gravity, dtype=torch.float32, device=state.pos.device)
    speed = torch.where(params.valid, torch.linalg.vector_norm(state.lin_vel, dim=-1), 0.0)
    vmax = speed.amax(dim=1)  # (B,): one margin per scene, as one vmap lane each
    margin = 0.01 + (vmax + g[2] * -frame_dt) * frame_dt
    fc = floor_contacts(atlas, state, params, floor)
    pc = pair_contacts(atlas, state, params, pairs, cfg.max_narrow_pairs, overlap_margin=margin)
    contacts = concat_contacts(fc, pc)

    pos0, quat0 = state.pos, state.quat
    n = contacts.normal
    sa = torch.clamp(contacts.body_a, min=0)
    sb = torch.clamp(contacts.body_b, min=0)
    ma = (contacts.body_a >= 0)[..., None]
    mb = (contacts.body_b >= 0)[..., None]
    radius = _body_radius(atlas, params)
    # contact offsets at generation, anchored at the body origins
    r_a0 = torch.where(ma, contacts.point - _bgather(pos0, sa), 0.0)
    r_b0 = torch.where(mb, contacts.point - _bgather(pos0, sb), 0.0)

    st = state
    min_sep = torch.full((B, nb), torch.inf, device=state.pos.device)
    acc = (torch.zeros_like(contacts.depth),) * 3 if warm is None else warm
    for _ in range(substeps):
        dR = m.quat_to_matrix(m.quat_normalize(m.quat_multiply(st.quat, m.quat_conjugate(quat0))))
        swing_a = torch.einsum("bcij,bcj->bci", _bgather(dR, sa), r_a0) - r_a0
        swing_b = torch.einsum("bcij,bcj->bci", _bgather(dR, sb), r_b0) - r_b0
        disp = st.pos - pos0
        move_a = torch.where(ma, _bgather(disp, sa) + swing_a, 0.0)
        move_b = torch.where(mb, _bgather(disp, sb) + swing_b, 0.0)
        ck = contacts._replace(depth=contacts.depth - ((move_b - move_a) * n).sum(dim=-1))
        st = integrate_velocities(params, st, sub_dt, cfg)
        st, rep, acc = solve_contacts(ck, params, st, sub_dt, cfg, warm=acc)
        st = _clamp_velocities(st, cfg)
        st = integrate_poses(params, st, sub_dt)
        v_b = _point_velocity(st, params, ck, which="b")
        v_a = _point_velocity(st, params, ck, which="a")
        vn = ((v_b - v_a) * n).sum(dim=-1)
        st = position_correction(ck._replace(depth=ck.depth - vn * sub_dt), params, st, cfg)
        st = _stabilize_resting(st, rep, radius)
        min_sep = torch.minimum(min_sep, rep.min_separation)
    return st, ContactReport(min_separation=min_sep), acc


def step(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
         pairs: torch.Tensor, dt: float, cfg: SolverConfig) -> tuple[BodyState, ContactReport]:
    """One cold substep (engine.py:88-99)."""
    st, rep, _ = step_fn(atlas, params, state, floor, pairs, dt, cfg)
    return st, rep


def run_substeps(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
                 pairs: torch.Tensor, dt: float, n_substeps: int,
                 cfg: SolverConfig) -> tuple[BodyState, ContactReport]:
    """``n_substeps`` substeps of ``dt / n_substeps``, the first cold and
    the rest warm-started; the report holds the least separation of them
    all (engine.py:293-325)."""
    sub_dt = dt / n_substeps
    state, rep, acc = step_fn(atlas, params, state, floor, pairs, sub_dt, cfg)
    min_sep = rep.min_separation
    for _ in range(n_substeps - 1):
        state, rep, acc = step_fn(atlas, params, state, floor, pairs, sub_dt, cfg, warm=acc)
        min_sep = torch.minimum(min_sep, rep.min_separation)
    return state, ContactReport(min_separation=min_sep)


def simulate_steps(atlas: HullAtlas, params: BodyParams, state: BodyState, floor: Floor,
                   pairs: torch.Tensor, dt: float, n_steps: int,
                   cfg: SolverConfig) -> tuple[BodyState, ContactReport]:
    """``n_steps`` cold substeps of ``dt`` (engine.py:328-345)."""
    min_sep = None
    for _ in range(n_steps):
        state, rep, _ = step_fn(atlas, params, state, floor, pairs, dt, cfg)
        sep = rep.min_separation
        min_sep = sep if min_sep is None else torch.minimum(min_sep, sep)
    return state, ContactReport(min_separation=min_sep)


def check_overlaps(atlas: HullAtlas, params: BodyParams, state: BodyState, pairs: torch.Tensor,
                   floor: Floor | None = None, margin: float = 0.0) -> torch.Tensor:
    """(B, NB) bool: does the body overlap anything by more than
    ``margin``? (engine.py:348-369; reference Scene::isObjectColliding and
    checkCollisions, src/scene.cpp:355-385, :914-925)."""
    B, nb = state.pos.shape[:2]
    out = torch.zeros((B, nb), device=state.pos.device)

    def mark(body, hit):
        out.scatter_reduce_(1, torch.clamp(body, min=0).long(),
                            (hit & (body >= 0)).to(out.dtype), "amax")

    c = pair_contacts(atlas, state, params, pairs, OVERLAP_NARROW_PAIRS)
    hit = c.valid & (c.depth > margin)
    mark(c.body_a.expand_as(hit), hit)
    mark(c.body_b.expand_as(hit), hit)
    if floor is not None:
        fc = floor_contacts(atlas, state, params, floor)
        mark(fc.body_b.expand_as(fc.valid), fc.valid & (fc.depth > margin))
    return (out > 0) & params.valid
