"""Physics data model: padded, fixed-shape tensors.

Counterpart of ``stillleben_tpu/physics/types.py``. ``HullAtlas`` and
``BodyParams`` are shared by every scene of a batch; ``BodyState`` carries
a leading batch axis (B, NB, ...) in the port, where the JAX package used
``vmap`` over unbatched states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m

MAX_HULL_VERTS = 64
MAX_HULL_PLANES = 64


class HullAtlas(NamedTuple):
    verts: torch.Tensor  # (NH, VH, 3) f32, mesh frame (pretransform baked)
    vert_valid: torch.Tensor  # (NH, VH) bool
    planes: torch.Tensor  # (NH, PH, 4) f32: n.x + d <= 0 inside
    plane_valid: torch.Tensor  # (NH, PH) bool
    hull_body: torch.Tensor  # (NH,) i32 owning body
    hull_valid: torch.Tensor  # (NH,) bool
    center: torch.Tensor  # (NH, 3) hull centroid
    radius: torch.Tensor  # (NH,) bounding radius about the centroid

    @property
    def num_hulls(self) -> int:
        return self.verts.shape[0]


class BodyParams(NamedTuple):
    inv_mass: torch.Tensor  # (NB,) 0 = static/kinematic
    inv_inertia_body: torch.Tensor  # (NB, 3, 3) mesh frame, about the COM
    com: torch.Tensor  # (NB, 3) centre of mass in the mesh frame
    friction: torch.Tensor  # (NB,) dynamic coefficient
    restitution: torch.Tensor  # (NB,)
    linear_velocity_limit: torch.Tensor  # (NB,)
    valid: torch.Tensor  # (NB,) bool
    kinematic: torch.Tensor  # (NB,) bool
    friction_static: torch.Tensor  # (NB,) stick coefficient


class BodyState(NamedTuple):
    pos: torch.Tensor  # (B, NB, 3) mesh-frame origin in world
    quat: torch.Tensor  # (B, NB, 4) wxyz
    lin_vel: torch.Tensor  # (B, NB, 3) COM velocity in world
    ang_vel: torch.Tensor  # (B, NB, 3) world angular velocity

    def pose_matrix(self) -> torch.Tensor:
        return m.transform_from_quat_pos(self.quat, self.pos)


class ContactReport(NamedTuple):
    min_separation: torch.Tensor  # (B, NB), +inf without contact


CONTACT_GENS = ("substep", "frame", "every2")


class SolverConfig(NamedTuple):
    """The JAX package's solver configuration and defaults (types.py:85-152).

    ``contact_gen`` is the contact-generation cadence: "substep" generates
    contacts every substep (the reference's cadence), "frame" once per 25 FPS
    frame with a speculative margin and depth updates across its substeps,
    "every2" once per block of two substeps. ``sleep_frames`` > 0 ends a
    scene's settle once every valid dynamic body has stayed below
    ``sleep_lin_vel`` (m/s) and ``sleep_ang_vel`` (rad/s) for that many
    consecutive frames; 0 runs the fixed schedule."""

    gravity: tuple = (0.0, 0.0, -9.81)
    velocity_iterations: int = 12
    position_iterations: int = 4
    baumgarte: float = 0.1
    slop: float = 1e-3
    rest_offset: float = 0.0015
    restitution_threshold: float = 0.2
    max_depenetration_velocity: float = 0.5
    linear_damping: float = 0.0
    angular_damping: float = 0.05
    relaxation: float = 0.9
    max_velocity: float = 5.0
    max_angular_velocity: float = 20.0
    warm_start: float = 1.0
    stick_velocity: float = 0.05
    max_narrow_pairs: int = 256
    contact_gen: str = "substep"
    sleep_frames: int = 0
    sleep_lin_vel: float = 1e-3
    sleep_ang_vel: float = 1e-2

    def check(self) -> None:
        if self.contact_gen not in CONTACT_GENS:
            raise ValueError(f"SolverConfig: contact_gen {self.contact_gen!r} not in {CONTACT_GENS}")
        if self.sleep_frames < 0:
            raise ValueError("SolverConfig: sleep_frames must be >= 0")


def default_config(gravity=(0.0, 0.0, -9.81)) -> SolverConfig:
    return SolverConfig(gravity=tuple(float(g) for g in gravity))


def build_hull_atlas_numpy(hull_lists: list[list[dict]]) -> dict:
    """Pack per-body hull lists into padded arrays (types.py:164-237).
    ``hull_lists[b]`` holds dicts with ``verts`` (V, 3) and ``planes``
    (P, 4) in the body's mesh frame. Vertex and plane slots are the atlas
    maxima rounded up to 8 (at most 64). Returns numpy arrays by field
    name; ``core.tree.tensors_from_numpy`` moves them to a device."""
    entries = []
    for b, hulls in enumerate(hull_lists):
        for h in hulls:
            entries.append(
                (b, np.asarray(h["verts"], np.float32), np.asarray(h["planes"], np.float32))
            )
    mv = max((e[1].shape[0] for e in entries), default=8)
    max_verts = min(-(-mv // 8) * 8, MAX_HULL_VERTS)
    mp = max((e[2].shape[0] for e in entries), default=8)
    max_planes = min(-(-mp // 8) * 8, MAX_HULL_PLANES)
    nh = max(len(entries), 1)

    verts = np.zeros((nh, max_verts, 3), np.float32)
    vvalid = np.zeros((nh, max_verts), bool)
    planes = np.zeros((nh, max_planes, 4), np.float32)
    planes[:, :, 3] = 1e9  # padded planes never report "inside"
    pvalid = np.zeros((nh, max_planes), bool)
    hull_body = np.zeros((nh,), np.int32)
    hvalid = np.zeros((nh,), bool)
    center = np.zeros((nh, 3), np.float32)
    radius = np.zeros((nh,), np.float32)
    for i, (b, v, p) in enumerate(entries):
        if v.shape[0] > max_verts or p.shape[0] > max_planes:
            raise ValueError(
                f"hull exceeds atlas budget: {v.shape[0]} verts / {p.shape[0]} planes "
                f"(max {max_verts}/{max_planes})"
            )
        nv, npl = v.shape[0], p.shape[0]
        verts[i, :nv] = v
        verts[i, nv:] = v[0] if nv > 0 else 0.0
        vvalid[i, :nv] = True
        planes[i, :npl] = p
        pvalid[i, :npl] = True
        hull_body[i] = b
        hvalid[i] = True
        c = v.mean(axis=0) if nv else np.zeros(3)
        center[i] = c
        radius[i] = float(np.linalg.norm(v - c, axis=1).max()) if nv else 0.0
    return dict(
        verts=verts, vert_valid=vvalid, planes=planes, plane_valid=pvalid,
        hull_body=hull_body, hull_valid=hvalid, center=center, radius=radius,
    )


def make_empty_state(num_bodies: int, batch: int = 1, device="cuda") -> BodyState:
    """(B, NB) bodies at the origin, identity orientation, at rest
    (types.py:155-161, with the port's batch axis)."""
    f32 = dict(dtype=torch.float32, device=device)
    quat = torch.zeros((batch, num_bodies, 4), **f32)
    quat[..., 0] = 1.0
    return BodyState(
        pos=torch.zeros((batch, num_bodies, 3), **f32), quat=quat,
        lin_vel=torch.zeros((batch, num_bodies, 3), **f32),
        ang_vel=torch.zeros((batch, num_bodies, 3), **f32),
    )
