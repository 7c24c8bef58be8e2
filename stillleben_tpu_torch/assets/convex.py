"""Convex hulls, approximate convex decomposition, mass properties, cache.

Functionally replaces the reference's physics-cooking stack:
- V-HACD convex decomposition (reference src/mesh.cpp:340-430): here a
  voxel-based approximate decomposition (surface voxelize -> fill -> recursive
  principal-axis splits until parts are convex enough), with the reference's
  selection rule: compute the single hull AND the decomposition, use the
  single hull when decompositionVolume / singleHullVolume >= 0.75
  ("much faster", src/mesh.cpp:424-429).
- PhysX convex cooking (src/mesh.cpp:71-92): here hull vertices + face planes
  as padded numpy arrays ready for device upload.
- The ``.sl_mesh`` disk cache with version/flags/content-hash staleness check
  (src/mesh.cpp:94-172, 490-511): here an ``.sl_mesh.npz`` sidecar (falling
  back to ``~/.cache/stillleben_tpu`` for read-only asset dirs), atomic
  rename writes (src/utils/os.cpp:49-135).

All host-side numpy; runs once per asset and is cached.

Copied from ``stillleben_tpu/assets/convex.py``. ``decompose`` takes the
native cooker (``native_decompose.py``, the port's build of the same C++
source) unless ``STILLLEBEN_TPU_NATIVE_DECOMP=0`` selects the Python
decomposition below, the JAX package's switch and default; a native build
that fails raises. Cache entries carry the tag ``CACHE_TAG`` and the cooker
in their file name and content hash, so a hull that the other package or
the other cooker made is never read.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

CACHE_VERSION = 1
MAX_HULL_VERTICES = 64  # padding budget per hull (PhysX allows 255)
DEFAULT_CONCAVITY = 0.002  # reference src/mesh.cpp:398 (normalized units)
CONVEXITY_SINGLE_HULL_THRESHOLD = 0.75  # reference src/mesh.cpp:424-429
CACHE_TAG = "torch"  # keeps this package's cache entries apart


def cooker() -> str:
    """``"native"`` (the default) or ``"python"``
    (``STILLLEBEN_TPU_NATIVE_DECOMP=0``), read as the JAX package reads it."""
    return "python" if os.environ.get("STILLLEBEN_TPU_NATIVE_DECOMP", "1") == "0" else "native"


@dataclass
class ConvexHullData:
    """One cooked convex hull: vertices, face planes, mass properties."""

    vertices: np.ndarray  # (Nv, 3) f32
    planes: np.ndarray  # (Np, 4) f32: n.x,n.y,n.z,d with n·x + d <= 0 inside
    volume: float
    center_of_mass: np.ndarray  # (3,) f32
    inertia: np.ndarray  # (3,3) f32 about COM, unit density


@dataclass
class PhysicsMeshData:
    hulls: list[ConvexHullData] = field(default_factory=list)

    @property
    def total_volume(self) -> float:
        return float(sum(h.volume for h in self.hulls))


# ---------------------------------------------------------------------------
# Convex hull + mass properties
# ---------------------------------------------------------------------------


def convex_hull(points: np.ndarray, max_vertices: int = MAX_HULL_VERTICES) -> ConvexHullData:
    """Convex hull of a point cloud with vertex-count reduction and analytic
    mass properties (tetrahedron decomposition / divergence theorem, the role
    of PxRigidBodyExt::updateMassAndInertia in reference src/object.cpp:205)."""
    from scipy.spatial import ConvexHull as SciHull

    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    points = _dedupe(points)
    if points.shape[0] < 4 or _rank_deficient(points):
        points = _inflate_degenerate(points)

    hull = SciHull(points, qhull_options="QJ")
    verts = points[hull.vertices]

    # Both vertex AND face-plane counts must fit the padded device budget
    # (a silently truncated plane set makes the hull "open" and destabilizes
    # the contact solver). Reduce vertices until both fit.
    target = min(max_vertices, verts.shape[0])
    while True:
        if verts.shape[0] > target:
            verts = _reduce_vertices(verts, target)
            hull = SciHull(verts, qhull_options="QJ")
            verts = verts[hull.vertices]
            hull = SciHull(verts, qhull_options="QJ")
        planes = _face_planes(hull)
        if len(planes) <= MAX_HULL_VERTICES and verts.shape[0] <= max_vertices:
            break
        target = max(target * 3 // 4, 8)

    volume, com, inertia = _mass_properties(verts, hull.simplices, hull.points)
    return ConvexHullData(
        vertices=verts.astype(np.float32),
        planes=planes.astype(np.float32),
        volume=float(volume),
        center_of_mass=com.astype(np.float32),
        inertia=inertia.astype(np.float32),
    )


def mesh_volume(vertices: np.ndarray, faces: np.ndarray) -> float:
    """Volume of a (possibly open) triangle mesh by the divergence theorem:
    the magnitude of the signed sum."""
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    return float(np.abs(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6.0))


def _dedupe(points: np.ndarray) -> np.ndarray:
    return np.unique(np.round(points, decimals=9), axis=0)


def _rank_deficient(points: np.ndarray) -> bool:
    c = points - points.mean(axis=0)
    s = np.linalg.svd(c, compute_uv=False)
    extent = max(float(s[0]), 1e-12)
    return bool(s[-1] / extent < 1e-7)


def _inflate_degenerate(points: np.ndarray) -> np.ndarray:
    """Give flat/degenerate point sets tiny thickness so qhull succeeds."""
    scale = max(float(np.abs(points).max()), 1e-6) if points.size else 1e-6
    eps = 1e-5 * scale
    offsets = np.array(
        [[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0], [0, 0, eps], [0, 0, -eps]]
    )
    base = points if points.size else np.zeros((1, 3))
    return np.concatenate([base + o for o in offsets], axis=0)


def _reduce_vertices(verts: np.ndarray, target: int) -> np.ndarray:
    """Reduce hull vertex count by greedy farthest-point sampling (keeps
    extreme points, preserves shape well for collision geometry)."""
    n = verts.shape[0]
    chosen = [int(np.argmax(np.linalg.norm(verts - verts.mean(0), axis=1)))]
    d = np.linalg.norm(verts - verts[chosen[0]], axis=1)
    for _ in range(target - 1):
        i = int(np.argmax(d))
        chosen.append(i)
        d = np.minimum(d, np.linalg.norm(verts - verts[i], axis=1))
    return verts[sorted(set(chosen))]


def _face_planes(hull) -> np.ndarray:
    """Outward face planes (n, d) with n·x + d <= 0 inside, deduplicated."""
    eqs = hull.equations  # qhull: n·x + d <= 0 inside, n outward unit
    # dedupe nearly-identical planes (coplanar triangles)
    rounded = np.round(eqs, decimals=6)
    _, idx = np.unique(rounded, axis=0, return_index=True)
    return eqs[np.sort(idx)]


def _mass_properties(verts: np.ndarray, simplices: np.ndarray, all_points: np.ndarray):
    """Volume, COM, unit-density inertia about COM via signed tetrahedra.

    Faces from qhull aren't consistently wound; orient each outward using the
    hull centroid before integrating.
    """
    centroid = verts.mean(axis=0)
    a = all_points[simplices[:, 0]] - centroid
    b = all_points[simplices[:, 1]] - centroid
    c = all_points[simplices[:, 2]] - centroid
    # outward orientation
    n = np.cross(b - a, c - a)
    flip = np.einsum("ij,ij->i", n, a) < 0
    b2 = np.where(flip[:, None], c, b)
    c2 = np.where(flip[:, None], b, c)
    b, c = b2, c2

    det = np.einsum("ij,ij->i", a, np.cross(b, c))
    vol = det.sum() / 6.0

    com = (det[:, None] * (a + b + c)).sum(axis=0) / (24.0 * max(vol, 1e-12)) + centroid

    # inertia via canonical tetra integrals (unit density), about centroid,
    # then shift to COM. I[i,j] = integral of x_i x_j over the solid.
    I = np.zeros((3, 3))
    for (p, q, r) in [(a, b, c)]:
        for i in range(3):
            for j in range(3):
                term = (
                    p[:, i] * p[:, j]
                    + q[:, i] * q[:, j]
                    + r[:, i] * r[:, j]
                    + 0.5 * (p[:, i] * q[:, j] + q[:, i] * p[:, j])
                    + 0.5 * (q[:, i] * r[:, j] + r[:, i] * q[:, j])
                    + 0.5 * (p[:, i] * r[:, j] + r[:, i] * p[:, j])
                )
                I[i, j] = (det * term / 60.0).sum()
    # I is the second moment matrix about `centroid`; convert to inertia tensor
    trace = np.trace(I)
    inertia_centroid = np.eye(3) * trace - I
    # parallel axis: shift from centroid to COM
    d = com - centroid
    m = max(vol, 1e-12)
    inertia_com = inertia_centroid - m * ((d @ d) * np.eye(3) - np.outer(d, d))
    return vol, com, inertia_com


# ---------------------------------------------------------------------------
# Voxelization (for decomposition concavity measurement)
# ---------------------------------------------------------------------------


def voxelize(vertices: np.ndarray, faces: np.ndarray, resolution: int = 48):
    """Solid voxelization: surface sampling + hole filling.

    Returns (occupancy (R,R,R) bool, origin (3,), voxel_size scalar).
    """
    from scipy import ndimage

    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    extent = hi - lo
    max_extent = float(extent.max())
    if max_extent <= 0:
        max_extent = 1e-6
    voxel = max_extent / (resolution - 3)
    # guarantee >= 1 voxel of empty margin on BOTH sides so the border of the
    # array is connected "outside" for hole filling
    dims = np.maximum(np.ceil(extent / voxel).astype(int) + 3, 4)
    origin = lo - voxel

    # area-weighted surface sampling: enough samples that every surface voxel
    # is hit w.h.p.
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total_area = areas.sum()
    if total_area <= 0:
        occ = np.zeros(tuple(dims), bool)
        idx = np.clip(((vertices - origin) / voxel).astype(int), 0, np.array(dims) - 1)
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        return occ, origin, voxel

    samples_per_area = 24.0 / (voxel * voxel)
    n_samples = int(min(max(total_area * samples_per_area, 4 * len(faces)), 4_000_000))
    rng = np.random.default_rng(0)
    tri_idx = rng.choice(len(faces), size=n_samples, p=areas / total_area)
    r1 = np.sqrt(rng.random(n_samples))
    r2 = rng.random(n_samples)
    pts = (
        (1 - r1)[:, None] * a[tri_idx]
        + (r1 * (1 - r2))[:, None] * b[tri_idx]
        + (r1 * r2)[:, None] * c[tri_idx]
    )
    # also include the raw vertices
    pts = np.concatenate([pts, vertices], axis=0)
    idx = np.clip(((pts - origin) / voxel).astype(int), 0, np.array(dims) - 1)
    occ = np.zeros(tuple(dims), bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    filled = ndimage.binary_fill_holes(occ)
    if filled.sum() < 1.3 * occ.sum():
        # Random surface sampling can leave small gaps in the shell which
        # leak the interior fill; plug them with a morphological closing.
        closed = ndimage.binary_closing(occ, structure=np.ones((3, 3, 3), bool))
        filled = ndimage.binary_fill_holes(closed) | occ
    return filled, origin, voxel


# ---------------------------------------------------------------------------
# Approximate convex decomposition (V-HACD equivalent)
# ---------------------------------------------------------------------------


def _part_concavity(points: np.ndarray, n_voxels: int, voxel: float) -> tuple[float, float]:
    """(relative concavity, hull_volume) of a voxel-point part."""
    if points.shape[0] < 4:
        return 0.0, 0.0
    try:
        hull = convex_hull(points, max_vertices=MAX_HULL_VERTICES)
    except Exception:
        return 0.0, 0.0
    vox_volume = n_voxels * voxel**3
    hv = max(hull.volume, 1e-12)
    return max(0.0, (hv - vox_volume) / hv), hull.volume


def decompose(
    vertices: np.ndarray,
    faces: np.ndarray,
    concavity: float = DEFAULT_CONCAVITY,
    max_hulls: int = 32,
    resolution: int = 48,
    force_single_hull: bool = False,
) -> PhysicsMeshData:
    """Approximate convex decomposition with the reference's single-hull
    shortcut (src/mesh.cpp:340-430).

    The reference's concavity is in V-HACD's normalized units; empirically its
    0.002 default keeps near-convex YCB objects at 1 hull and splits bowls /
    mugs. We map it to a relative volume-deficit threshold (hull volume vs
    solid volume) of ``max(0.04, 20*concavity)``.
    """
    vertices = np.asarray(vertices, np.float64).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)

    if cooker() == "native":
        from .native_decompose import decompose_native

        native = decompose_native(
            vertices.astype(np.float32),
            faces.astype(np.int32),
            concavity,
            max_hulls=max_hulls,
            resolution=resolution,
            force_single_hull=force_single_hull,
        )
        if native is not None:
            return PhysicsMeshData(hulls=[ConvexHullData(**h) for h in native])
        # the native cooker makes no hull of a flat mesh or one of fewer
        # than 4 vertices; the JAX package's decompose cooks those with the
        # Python path below, and so does this one

    single = convex_hull(vertices)
    if force_single_hull:
        return PhysicsMeshData(hulls=[single])

    rel_threshold = max(0.04, 20.0 * concavity)

    occ, origin, voxel = voxelize(vertices, faces, resolution)
    coords = np.argwhere(occ).astype(np.float64)
    vox_points = coords * voxel + origin + voxel / 2

    single_deficit = max(0.0, (single.volume - len(vox_points) * voxel**3) / max(single.volume, 1e-12))
    if single_deficit <= rel_threshold:
        return PhysicsMeshData(hulls=[single])

    # recursive principal-axis splitting of the voxel point set
    parts: list[np.ndarray] = []
    stack: list[tuple[np.ndarray, int]] = [(vox_points, 0)]
    max_depth = int(np.ceil(np.log2(max(max_hulls, 2))))
    while stack:
        pts, depth = stack.pop()
        conc, _ = _part_concavity(pts, len(pts), voxel)
        if conc <= rel_threshold or depth >= max_depth or len(pts) < 8:
            parts.append(pts)
            continue
        # split along the axis with the largest extent (stable, cheap)
        extents = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(extents))
        median = np.median(pts[:, axis])
        left = pts[pts[:, axis] <= median]
        right = pts[pts[:, axis] > median]
        if len(left) < 4 or len(right) < 4:
            parts.append(pts)
            continue
        stack.append((left, depth + 1))
        stack.append((right, depth + 1))

    hulls = []
    decomposition_volume = 0.0
    for pts in parts:
        if pts.shape[0] < 4:
            continue
        # expand part points by half a voxel so adjacent hulls touch
        try:
            h = convex_hull(pts)
        except Exception:
            continue
        hulls.append(h)
        decomposition_volume += h.volume

    if not hulls:
        return PhysicsMeshData(hulls=[single])

    # reference rule: if decomposition volume >= 0.75 of single-hull volume,
    # the object is convex enough -> single hull is much faster
    convexity = decomposition_volume / max(single.volume, 1e-12)
    if convexity >= CONVEXITY_SINGLE_HULL_THRESHOLD:
        return PhysicsMeshData(hulls=[single])
    return PhysicsMeshData(hulls=hulls)


# ---------------------------------------------------------------------------
# Disk cache (.sl_mesh equivalent)
# ---------------------------------------------------------------------------


def _content_hash(vertices: np.ndarray, faces: np.ndarray, flags: int) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(vertices, np.float32).tobytes())
    h.update(np.ascontiguousarray(faces, np.uint32).tobytes())
    h.update(str(flags).encode())
    h.update(str(CACHE_VERSION).encode())
    h.update(f"{CACHE_TAG}-{cooker()}".encode())
    return h.hexdigest()


def _cache_paths(filename: str) -> list[str]:
    """Cache candidates in priority order. Unlike the reference (which always
    writes the ``.sl_mesh`` sidecar next to the asset, src/mesh.cpp:490-511),
    we default to a user cache dir and only use sidecars when explicitly
    enabled — asset dirs are often shared/read-only datasets."""
    cache_dir = os.environ.get(
        "STILLLEBEN_TPU_MESH_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "stillleben_tpu", "mesh_cache"),
    )
    key = hashlib.blake2b(os.path.abspath(filename).encode(), digest_size=12).hexdigest()
    tag = f"{CACHE_TAG}-{cooker()}"
    cached = os.path.join(cache_dir, f"{key}.{tag}.sl_mesh.npz")
    sidecar = f"{filename}.{tag}.sl_mesh.npz"
    if os.environ.get("STILLLEBEN_TPU_SIDECAR_CACHE"):
        return [sidecar, cached]
    # still READ a pre-existing sidecar (e.g. shipped with a dataset)
    return [cached, sidecar] if os.path.exists(sidecar) else [cached]


def load_cached_physics(filename: str, vertices, faces, flags: int) -> PhysicsMeshData | None:
    """Try to load cooked hulls; validates content hash (reference's
    MurmurHash+mtime staleness check, src/mesh.cpp:105-172)."""
    want = _content_hash(vertices, faces, flags)
    for path in _cache_paths(filename):
        if not os.path.exists(path):
            continue
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["hash"]) != want or int(z["version"]) != CACHE_VERSION:
                    continue
                n = int(z["num_hulls"])
                hulls = []
                for i in range(n):
                    hulls.append(
                        ConvexHullData(
                            vertices=z[f"verts_{i}"],
                            planes=z[f"planes_{i}"],
                            volume=float(z[f"volume_{i}"]),
                            center_of_mass=z[f"com_{i}"],
                            inertia=z[f"inertia_{i}"],
                        )
                    )
                return PhysicsMeshData(hulls=hulls)
        except Exception:
            continue
    return None


def store_cached_physics(filename: str, vertices, faces, flags: int, data: PhysicsMeshData) -> None:
    """Atomic write-then-rename (reference src/utils/os.cpp:49-135)."""
    payload = {
        "hash": _content_hash(vertices, faces, flags),
        "version": CACHE_VERSION,
        "num_hulls": len(data.hulls),
    }
    for i, h in enumerate(data.hulls):
        payload[f"verts_{i}"] = h.vertices
        payload[f"planes_{i}"] = h.planes
        payload[f"volume_{i}"] = h.volume
        payload[f"com_{i}"] = h.center_of_mass
        payload[f"inertia_{i}"] = h.inertia

    for path in _cache_paths(filename):
        d = os.path.dirname(path)
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **payload)
                os.replace(tmp, path)
                return
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            continue
