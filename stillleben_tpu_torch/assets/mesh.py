"""The Mesh asset: import, consolidation, pretransform, physics cooking.

Copied from ``stillleben_tpu/assets/mesh.py:44-400``, trimmed to what the
port uses (reference src/mesh.cpp, python/src/py_mesh.cpp):

- ``Mesh(filename, visual=True, physics=True, flags=0)`` for ``.obj`` and
  ``.ply`` files; any other extension raises and names what is ported;
- the ``.pretransform`` text sidecar (src/mesh.cpp:888-921);
- pretransform: uniform scale x rigid, SVD-decomposed, non-uniform scale
  rejected (src/mesh.cpp:1050-1073); ``center_bbox`` and
  ``scale_to_bbox_diagonal`` (src/mesh.cpp:1020-1043);
- physics cooking: convex decomposition with the single-hull shortcut and
  a disk cache (src/mesh.cpp:340-511), see ``convex.py``.
"""

from __future__ import annotations

import enum
import os

import numpy as np

from ..core.range3d import Range3D
from .consolidate import ConsolidatedMesh, consolidate
from .convex import PhysicsMeshData, decompose, load_cached_physics, store_cached_physics
from .objfile import load_obj, load_ply

LOADERS = {".obj": load_obj, ".ply": load_ply}


class MeshFlag(enum.IntFlag):
    NONE = 0
    PHYSICS_FORCE_CONVEX_HULL = 1  # reference Mesh::Flag::PhysicsForceConvexHull


class Mesh:
    Flag = MeshFlag

    def __init__(
        self,
        filename,
        visual: bool = True,
        physics: bool = True,
        flags: MeshFlag = MeshFlag.NONE,
    ):
        self._filename = str(filename)  # pathlib.Path accepted
        self._flags = MeshFlag(flags)
        self._consolidated: ConsolidatedMesh | None = None
        self._raw_bbox = Range3D()
        self._scale = 1.0
        self._pretransform_rigid = np.eye(4, dtype=np.float32)
        self._pretransform = np.eye(4, dtype=np.float32)
        self._class_index = 0
        self._physics: PhysicsMeshData | None = None

        self.open_file()
        if physics:
            self.load_physics()

    # -- import ------------------------------------------------------------

    def open_file(self) -> None:
        """Parse + consolidate the asset (reference Mesh::openFile,
        src/mesh.cpp:186-301)."""
        if self._consolidated is not None:
            return
        fn = self._filename
        ext = os.path.splitext(fn)[1].lower()
        if ext not in LOADERS:
            raise ValueError(
                f"Unsupported mesh format '{ext}' (ported: {' '.join(sorted(LOADERS))})"
            )
        self._consolidated = consolidate(LOADERS[ext](fn), name=fn)
        self._raw_bbox = Range3D.from_points(self._consolidated.positions)
        self._load_pretransform_sidecar()

    def _load_pretransform_sidecar(self) -> None:
        """Optional <file>.pretransform 4x4 text sidecar
        (reference src/mesh.cpp:888-921)."""
        path = self._filename + ".pretransform"
        if not os.path.exists(path):
            return
        vals = []
        with open(path) as f:
            for line in f:
                vals.extend(float(x) for x in line.replace(",", " ").split())
        if len(vals) != 16:
            raise ValueError(f"{path}: expected 16 values, got {len(vals)}")
        self.pretransform = np.array(vals, dtype=np.float32).reshape(4, 4)

    # -- physics -----------------------------------------------------------

    def load_physics(self) -> None:
        """Cook convex hulls (with disk cache; reference src/mesh.cpp:303-511)."""
        if self._physics is not None:
            return
        c = self.consolidated
        cached = load_cached_physics(self._filename, c.positions, c.faces, int(self._flags))
        if cached is not None:
            self._physics = cached
            return
        self._physics = decompose(
            c.positions,
            c.faces,
            force_single_hull=bool(self._flags & MeshFlag.PHYSICS_FORCE_CONVEX_HULL),
        )
        store_cached_physics(self._filename, c.positions, c.faces, int(self._flags), self._physics)

    # -- geometry ------------------------------------------------------------

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def consolidated(self) -> ConsolidatedMesh:
        self.open_file()
        return self._consolidated

    # -- pretransform --------------------------------------------------------

    @property
    def bbox(self) -> Range3D:
        """Bounding box with pretransform applied (reference
        src/mesh.cpp:1075-1081 transforms the two corners)."""
        P = self._pretransform
        lo = P[:3, :3] @ self._raw_bbox.min + P[:3, 3]
        hi = P[:3, :3] @ self._raw_bbox.max + P[:3, 3]
        return Range3D(np.minimum(lo, hi), np.maximum(lo, hi))

    def center_bbox(self) -> None:
        """translation := -R_rigid @ raw_bbox.center (src/mesh.cpp:1020-1024)."""
        self._pretransform_rigid[:3, 3] = -(
            self._pretransform_rigid[:3, :3] @ self._raw_bbox.center
        )
        self._update_pretransform()

    def scale_to_bbox_diagonal(self, target_diagonal: float, mode: str = "exact") -> None:
        """Set uniform scale from the RAW bbox diagonal
        (src/mesh.cpp:1026-1043)."""
        diagonal = self._raw_bbox.diagonal
        scale = target_diagonal / diagonal
        if mode == "exact":
            self._scale = float(scale)
        elif mode in ("order_of_magnitude", "OrderOfMagnitude"):
            self._scale = float(10.0 ** np.round(np.log10(scale)))
        else:
            raise ValueError(f"unknown scale mode {mode!r}")
        self._update_pretransform()

    def _update_pretransform(self) -> None:
        S = np.eye(4, dtype=np.float32) * self._scale
        S[3, 3] = 1.0
        self._pretransform = (S @ self._pretransform_rigid).astype(np.float32)

    @property
    def pretransform(self) -> np.ndarray:
        return self._pretransform.copy()

    @pretransform.setter
    def pretransform(self, m) -> None:
        """SVD split into uniform scale + rigid; rejects non-uniform scale
        (reference src/mesh.cpp:1050-1073)."""
        m = np.asarray(m, np.float32).reshape(4, 4)
        U, w, Vt = np.linalg.svd(m[:3, :3].astype(np.float64))
        if w.max() - w.min() > 1e-5 * max(w.max(), 1.0):
            raise ValueError(f"Scaling is not uniform: {w}")
        self._scale = float((w.max() + w.min()) / 2.0)
        R = U @ Vt
        if np.linalg.det(R) < 0:
            # keep proper rotation (reference Magnum svd yields proper U,V)
            U[:, -1] *= -1
            R = U @ Vt
        rigid = np.eye(4, dtype=np.float32)
        rigid[:3, :3] = R.astype(np.float32)
        rigid[:3, 3] = (m[:3, 3] / self._scale).astype(np.float32)
        self._pretransform_rigid = rigid
        self._update_pretransform()

    # -- misc ---------------------------------------------------------------

    @property
    def class_index(self) -> int:
        return self._class_index

    @class_index.setter
    def class_index(self, index: int) -> None:
        if not (0 <= index <= np.iinfo(np.uint16).max):
            raise ValueError("Mesh.class_index: out of uint16 range")
        self._class_index = int(index)

    def __repr__(self):
        n = self._consolidated.num_vertices if self._consolidated else 0
        return f"Mesh({self._filename!r}, vertices={n})"
