"""Host-side body construction: mass properties from hull sets.

Copied from ``stillleben_tpu/physics/bodies.py``.

The role of PxRigidBodyExt::updateMassAndInertia (reference
src/object.cpp:205): mass from density (default 1000 kg/m^3) over the convex
decomposition, COM and inertia aggregated from the hulls' analytic mass
properties with the parallel-axis theorem.
"""

from __future__ import annotations

import numpy as np

from ..assets.convex import ConvexHullData

DEFAULT_DENSITY = 1000.0  # kg/m^3 (reference src/object.cpp:201-205)


def aggregate_mass_properties(
    hulls: list[ConvexHullData], density: float = DEFAULT_DENSITY
):
    """Returns (mass, com (3,), inertia (3,3) about COM in body frame)."""
    total_vol = sum(h.volume for h in hulls)
    if total_vol <= 0:
        return 0.0, np.zeros(3, np.float32), np.eye(3, dtype=np.float32)
    mass = density * total_vol
    com = (
        sum(h.volume * h.center_of_mass.astype(np.float64) for h in hulls) / total_vol
    )
    inertia = np.zeros((3, 3), np.float64)
    for h in hulls:
        # h.inertia is unit-density about the hull's own COM
        I_h = h.inertia.astype(np.float64) * density
        d = h.center_of_mass.astype(np.float64) - com
        shift = h.volume * density * ((d @ d) * np.eye(3) - np.outer(d, d))
        inertia += I_h + shift
    return float(mass), com.astype(np.float32), inertia.astype(np.float32)


def transform_hull(hull: ConvexHullData, pretransform: np.ndarray) -> dict:
    """Apply a mesh pretransform (uniform scale x rigid, 4x4) to a cooked
    hull, producing vert/plane arrays in the body's mesh frame — the
    equivalent of attaching the PxShape with mesh scale + rigid pretransform
    local pose (reference src/object.cpp:142-213)."""
    P = np.asarray(pretransform, np.float64)
    A = P[:3, :3]
    t = P[:3, 3]
    verts = hull.vertices.astype(np.float64) @ A.T + t
    # plane transform for n·x + d <= 0 under x' = A x + t (A = s R):
    # n' = R n (unit), d' = s d - n'·t
    s = float(np.cbrt(np.abs(np.linalg.det(A))))
    R = A / s
    n_new = hull.planes[:, :3].astype(np.float64) @ R.T
    d_new = hull.planes[:, 3].astype(np.float64) * s - n_new @ t
    planes = np.concatenate([n_new, d_new[:, None]], axis=1)
    return {"verts": verts.astype(np.float32), "planes": planes.astype(np.float32)}


def transform_mass_properties(mass, com, inertia, pretransform: np.ndarray, density_scale=1.0):
    """Mass properties after a uniform-scale+rigid pretransform.
    mass scales with s^3, inertia with s^5 and rotates with R."""
    P = np.asarray(pretransform, np.float64)
    A = P[:3, :3]
    t = P[:3, 3]
    s = float(np.cbrt(np.abs(np.linalg.det(A))))
    R = A / s
    new_mass = mass * s**3 * density_scale
    new_com = (A @ np.asarray(com, np.float64) + t).astype(np.float32)
    new_inertia = (s**5 * density_scale) * (R @ np.asarray(inertia, np.float64) @ R.T)
    return float(new_mass), new_com, new_inertia.astype(np.float32)
