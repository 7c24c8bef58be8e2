"""Built-in primitive meshes, addressed as ``primitive://<name>``.

Copied from ``stillleben_tpu/assets/primitive.py`` (reference
src/utils/primitive_importer.cpp:50-94, which serves ``primitive://cube``
as a Magnum cube with corners at +-1 and the default material), with the
sphere and plane primitives of the JAX package. The geometry is here once:
``procedural.py`` writes the cube and sphere fixtures from these arrays.
"""

from __future__ import annotations

import numpy as np

from ..context import DEFAULT_MATERIAL_COLOR
from .gltf import GltfDocument, GltfMaterial, GltfNode, GltfPrimitive

PRIMITIVE_SCHEME = "primitive://"


def cube_arrays():
    """Axis-aligned cube with corners at +-1, 24 vertices (per-face normals
    and uvs), as Magnum's Primitives::cubeSolid (primitive_importer.cpp:62):
    (positions, normals, uvs, faces) with int64 faces."""
    positions, normals, uvs, faces = [], [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u_axis, v_axis = (axis + 1) % 3, (axis + 2) % 3
            base = len(positions)
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = n.copy()
                p[u_axis] = du * sign
                p[v_axis] = dv
                positions.append(p)
                normals.append(n)
                uvs.append([(du + 1) / 2, (dv + 1) / 2])
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.array(positions, np.float32), np.array(normals, np.float32),
            np.array(uvs, np.float32), np.array(faces, np.int64))


def uv_sphere_arrays(rings: int = 16, segments: int = 32):
    """The unit UV sphere, (positions, normals, uvs, faces)."""
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    seg_t = np.linspace(0.0, 2 * np.pi, segments + 1)
    tt, pp = np.meshgrid(ring_t, seg_t, indexing="ij")
    positions = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    faces = []
    for r in range(rings):
        for s in range(segments):
            a = r * (segments + 1) + s
            b = a + segments + 1
            faces += [[a, b, a + 1], [a + 1, b, b + 1]]
    return positions, positions.copy(), uv, np.array(faces, np.int64)


def plane_arrays():
    """Unit plane in XY (corners +-1), +Z normal."""
    positions = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return positions, normals, uvs, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


_GENERATORS = {"cube": cube_arrays, "sphere": uv_sphere_arrays, "plane": plane_arrays}


def is_primitive_path(path: str) -> bool:
    return path.startswith(PRIMITIVE_SCHEME)


def load_primitive(path: str) -> GltfDocument:
    name = path[len(PRIMITIVE_SCHEME):]
    if name not in _GENERATORS:
        raise ValueError(f"Unknown primitive '{name}' (have: {sorted(_GENERATORS)})")
    positions, normals, uvs, faces = _GENERATORS[name]()
    prim = GltfPrimitive(positions=positions, normals=normals, texcoords=uvs,
                         indices=faces.astype(np.uint32), material=0)
    mat = GltfMaterial(
        name="default",
        base_color=DEFAULT_MATERIAL_COLOR.copy(),
        metallic=0.04,
        roughness=0.5,
        has_metallic_factor=True,
        has_roughness_factor=True,
    )
    return GltfDocument(nodes=[GltfNode(name=name, mesh=0)], roots=[0], meshes=[[prim]],
                        materials=[mat])
