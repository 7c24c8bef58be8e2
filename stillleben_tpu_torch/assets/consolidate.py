"""Mesh consolidation: one fixed-layout vertex/index buffer per mesh file.

Copied from ``stillleben_tpu/assets/consolidate.py``.

Mirrors the semantics of the reference's consolidateMesh
(src/mesh_tools/consolidate.cpp:53-61, 204-335): all sub-meshes of a file are
concatenated into a single set of arrays with a fixed vertex layout

    position (V,3) f32, texcoord (V,2) f32, color (V,4) f32,
    tangent (V,4) f32 (xyz tangent + w bitangent sign),
    vertex_index (V,) u32 -- GLOBAL and 1-BASED (consolidate.cpp:333-335),
    normal (V,3) f32

plus faces (F,3) u32 into the consolidated vertex arrays, with node-tree
transforms baked into positions/normals/tangents, smooth normals generated
where missing (consolidate.cpp:79-88) and UV-space tangents generated where
missing (compute_tangents.cpp:53-134). Per sub-mesh we record offsets and the
material index so per-part materials survive (a "sub-mesh" here = one node
instance of one glTF primitive, the reference's Drawable granularity).

The 1-based global vertex index is what flows into the vertex-index
ground-truth render buffer consumed by the differentiable-rendering module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .gltf import GltfDocument, GltfMaterial


@dataclass
class SubMesh:
    """One drawable part: a contiguous face range with one material."""

    name: str
    face_offset: int  # into faces array
    face_count: int
    vertex_offset: int
    vertex_count: int
    material: int  # index into ConsolidatedMesh.materials (-1 = default)
    node_transform: np.ndarray  # baked already; kept for serialization


@dataclass
class ConsolidatedMesh:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    texcoords: np.ndarray  # (V, 2) f32
    colors: np.ndarray  # (V, 4) f32
    tangents: np.ndarray  # (V, 4) f32
    vertex_indices: np.ndarray  # (V,) u32, 1-based global
    faces: np.ndarray  # (F, 3) u32
    sub_meshes: list[SubMesh] = field(default_factory=list)
    materials: list[GltfMaterial] = field(default_factory=list)
    images: list[np.ndarray] = field(default_factory=list)

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


def compute_smooth_normals(positions: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (matches the reference's
    generateSmoothNormals use, consolidate.cpp:79-88, and the area-weighted
    recomputeNormals of src/mesh.cpp:763-816: cross products accumulate with
    triangle-area weight, then normalize)."""
    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # magnitude = 2 * area
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens[lens < 1e-20] = 1.0
    return (normals / lens).astype(np.float32)


def compute_tangents(
    positions: np.ndarray, normals: np.ndarray, texcoords: np.ndarray, faces: np.ndarray
) -> np.ndarray:
    """Per-triangle UV-space tangents accumulated per vertex, packed as
    Vector4 (tangent xyz + bitangent handedness sign)
    (reference src/mesh_tools/compute_tangents.cpp:53-134)."""
    v0, v1, v2 = (positions[faces[:, k]] for k in range(3))
    uv0, uv1, uv2 = (texcoords[faces[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    duv1, duv2 = uv1 - uv0, uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    det_safe = np.where(np.abs(det) < 1e-12, 1.0, det)
    r = 1.0 / det_safe
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
    bitangent = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * r[:, None]

    tacc = np.zeros_like(positions)
    bacc = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tacc, faces[:, k], tangent)
        np.add.at(bacc, faces[:, k], bitangent)

    # Gram-Schmidt orthogonalize against the normal
    t = tacc - normals * np.sum(normals * tacc, axis=1, keepdims=True)
    tl = np.linalg.norm(t, axis=1, keepdims=True)
    degenerate = tl[:, 0] < 1e-12
    # fallback tangent perpendicular to normal
    alt = np.cross(normals, np.array([0.0, 0.0, 1.0], np.float32))
    alt2 = np.cross(normals, np.array([0.0, 1.0, 0.0], np.float32))
    alt = np.where(np.linalg.norm(alt, axis=1, keepdims=True) < 1e-6, alt2, alt)
    t = np.where(degenerate[:, None], alt, t / np.where(tl < 1e-12, 1.0, tl))
    sign = np.where(np.sum(np.cross(normals, t) * bacc, axis=1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, sign[:, None]], axis=1).astype(np.float32)


def consolidate(doc: GltfDocument, name: str = "") -> ConsolidatedMesh:
    """Walk the node tree and build the consolidated arrays."""
    pos_list, nrm_list, uv_list, col_list, tan_list = [], [], [], [], []
    face_list: list[np.ndarray] = []
    sub_meshes: list[SubMesh] = []
    v_off = 0
    f_off = 0

    def visit(node_idx: int, parent_T: np.ndarray):
        nonlocal v_off, f_off
        node = doc.nodes[node_idx]
        T = parent_T @ node.transform
        if node.mesh >= 0:
            R = T[:3, :3]
            # normal matrix: inverse-transpose of rotation/scale part
            try:
                N = np.linalg.inv(R).T
            except np.linalg.LinAlgError:
                N = R
            for prim in doc.meshes[node.mesh]:
                nv = prim.positions.shape[0]
                nf = prim.indices.shape[0]
                p = prim.positions @ R.T + T[:3, 3]
                pos_list.append(p.astype(np.float32))

                if prim.normals is not None:
                    n = prim.normals @ N.T
                    lens = np.linalg.norm(n, axis=1, keepdims=True)
                    lens[lens < 1e-20] = 1.0
                    n = (n / lens).astype(np.float32)
                else:
                    n = compute_smooth_normals(p.astype(np.float32), prim.indices)
                nrm_list.append(n)

                uv = (
                    prim.texcoords.astype(np.float32)
                    if prim.texcoords is not None
                    else np.zeros((nv, 2), np.float32)
                )
                uv_list.append(uv)

                col = (
                    prim.colors.astype(np.float32)
                    if prim.colors is not None
                    else np.ones((nv, 4), np.float32)
                )
                col_list.append(col)

                if prim.tangents is not None:
                    txyz = prim.tangents[:, :3] @ R.T
                    lens = np.linalg.norm(txyz, axis=1, keepdims=True)
                    lens[lens < 1e-20] = 1.0
                    tan = np.concatenate(
                        [txyz / lens, prim.tangents[:, 3:4]], axis=1
                    ).astype(np.float32)
                elif prim.texcoords is not None:
                    tan = compute_tangents(p.astype(np.float32), n, uv, prim.indices)
                else:
                    tan = np.zeros((nv, 4), np.float32)
                    tan[:, 0] = 1.0
                    tan[:, 3] = 1.0
                tan_list.append(tan)

                face_list.append(prim.indices.astype(np.uint32) + np.uint32(v_off))
                sub_meshes.append(
                    SubMesh(
                        name=node.name,
                        face_offset=f_off,
                        face_count=nf,
                        vertex_offset=v_off,
                        vertex_count=nv,
                        material=prim.material,
                        node_transform=T.copy(),
                    )
                )
                v_off += nv
                f_off += nf
        for c in node.children:
            visit(c, T)

    eye = np.eye(4, dtype=np.float32)
    for r in doc.roots:
        visit(r, eye)

    if not pos_list:
        raise ValueError(f"Mesh '{name}' contains no triangle geometry")

    positions = np.concatenate(pos_list, axis=0)
    V = positions.shape[0]
    return ConsolidatedMesh(
        positions=positions,
        normals=np.concatenate(nrm_list, axis=0),
        texcoords=np.concatenate(uv_list, axis=0),
        colors=np.concatenate(col_list, axis=0),
        tangents=np.concatenate(tan_list, axis=0),
        # GLOBAL 1-based vertex index (consolidate.cpp:333-335)
        vertex_indices=np.arange(1, V + 1, dtype=np.uint32),
        faces=np.concatenate(face_list, axis=0),
        sub_meshes=sub_meshes,
        materials=list(doc.materials),
        images=list(doc.images),
    )
