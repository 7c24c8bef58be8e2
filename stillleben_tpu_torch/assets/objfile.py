"""Wavefront OBJ (+MTL) and PLY loaders -> GltfDocument.

Copied from ``stillleben_tpu/assets/objfile.py:18-269`` (``_load_mtl``,
``load_obj``, ``load_ply``). The STL, OFF and DAE loaders of that file are
not ported yet. A ``map_Kd`` image is decoded by the port's own codec
(``assets/image.py``: PNG and binary PPM; any other format raises).

Covers the practical subset the reference reaches through Assimp
(src/mesh.cpp:219-239): triangulated (we fan-triangulate polygons), per-face
materials, Kd/map_Kd diffuse, vertex colors (PLY), ascii + binary PLY.
"""

from __future__ import annotations

import os

import numpy as np

from .image import read_image
from .gltf import GltfDocument, GltfMaterial, GltfNode, GltfPrimitive


def _load_mtl(path: str) -> dict[str, GltfMaterial]:
    mats: dict[str, GltfMaterial] = {}
    if not os.path.exists(path):
        return mats
    cur: GltfMaterial | None = None
    base = os.path.dirname(path)
    tex_paths: dict[str, str] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = GltfMaterial(name=parts[1] if len(parts) > 1 else "")
                cur.metallic = 0.0
                cur.roughness = 0.5
                cur.has_metallic_factor = True
                cur.has_roughness_factor = True
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.base_color = np.array(
                    [float(parts[1]), float(parts[2]), float(parts[3]), 1.0], np.float32
                )
            elif key == "d" and len(parts) >= 2:
                cur.base_color[3] = float(parts[1])
            elif key == "Ns" and len(parts) >= 2:
                # shininess -> roughness approximation
                ns = float(parts[1])
                cur.roughness = float(np.clip(np.sqrt(2.0 / (ns + 2.0)), 0.0, 1.0))
            elif key == "Ke" and len(parts) >= 4:
                cur.emissive = np.array([float(p) for p in parts[1:4]], np.float32)
            elif key == "map_Kd" and len(parts) >= 2:
                tex_paths[cur.name] = os.path.join(base, " ".join(parts[1:]))
    # defer image decode to caller via attribute
    for name, mat in mats.items():
        mat._tex_path = tex_paths.get(name)  # type: ignore[attr-defined]
    return mats


def load_obj(path: str) -> GltfDocument:
    positions: list[list[float]] = []
    texcoords: list[list[float]] = []
    normals: list[list[float]] = []
    # corner key -> new index, per material group
    mtl_lib: dict[str, GltfMaterial] = {}
    groups: dict[str, list[tuple]] = {}  # material name -> list of triangles of corner tuples
    cur_mat = ""

    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif key == "vt":
                texcoords.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif key == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif key == "f":
                corners = []
                for c in parts[1:]:
                    sub = c.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    corners.append((vi, ti, ni))
                tris = groups.setdefault(cur_mat, [])
                for k in range(1, len(corners) - 1):
                    tris.append((corners[0], corners[k], corners[k + 1]))
            elif key == "usemtl":
                cur_mat = parts[1] if len(parts) > 1 else ""
            elif key == "mtllib" and len(parts) > 1:
                mtl_lib.update(_load_mtl(os.path.join(base, " ".join(parts[1:]))))

    pos_arr = np.array(positions, np.float32) if positions else np.zeros((0, 3), np.float32)
    uv_arr = np.array(texcoords, np.float32) if texcoords else np.zeros((0, 2), np.float32)
    nrm_arr = np.array(normals, np.float32) if normals else np.zeros((0, 3), np.float32)

    doc = GltfDocument()
    prims: list[GltfPrimitive] = []
    img_cache: dict[str, int] = {}

    def _fix(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i

    for mat_name, tris in groups.items():
        remap: dict[tuple, int] = {}
        v_out, t_out, n_out = [], [], []
        faces = []
        for tri in tris:
            idxs = []
            for corner in tri:
                if corner not in remap:
                    remap[corner] = len(v_out)
                    vi, ti, ni = corner
                    v_out.append(pos_arr[_fix(vi, len(pos_arr))])
                    if ti:
                        uv = uv_arr[_fix(ti, len(uv_arr))]
                        # OBJ uv origin bottom-left; glTF top-left
                        t_out.append([uv[0], 1.0 - uv[1]])
                    else:
                        t_out.append([0.0, 0.0])
                    n_out.append(nrm_arr[_fix(ni, len(nrm_arr))] if ni else None)
                idxs.append(remap[corner])
            faces.append(idxs)

        mat_idx = -1
        if mat_name in mtl_lib:
            mat = mtl_lib[mat_name]
            tex_path = getattr(mat, "_tex_path", None)
            if tex_path and os.path.exists(tex_path):
                if tex_path not in img_cache:
                    img_cache[tex_path] = len(doc.images)
                    doc.images.append(read_image(tex_path))
                mat.base_color_texture = img_cache[tex_path]
            mat_idx = len(doc.materials)
            doc.materials.append(mat)

        has_normals = all(n is not None for n in n_out) and len(n_out) > 0
        prims.append(
            GltfPrimitive(
                positions=np.array(v_out, np.float32),
                indices=np.array(faces, np.uint32),
                normals=np.array(n_out, np.float32) if has_normals else None,
                texcoords=np.array(t_out, np.float32),
                material=mat_idx,
            )
        )

    doc.meshes.append(prims)
    doc.nodes.append(GltfNode(name=os.path.basename(path), mesh=0))
    doc.roots = [0]
    return doc


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> GltfDocument:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, list_count_dtype)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], _PLY_DTYPES[parts[3]], True, _PLY_DTYPES[parts[2]]))
                else:
                    elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]], False, None))
        data = {}
        if fmt == "ascii":
            for name, count, props in elements:
                rows = {p[0]: [] for p in props}
                for _ in range(count):
                    vals = f.readline().split()
                    i = 0
                    for pname, dt, is_list, _cnt in props:
                        if is_list:
                            n = int(vals[i]); i += 1
                            rows[pname].append([float(v) for v in vals[i : i + n]])
                            i += n
                        else:
                            rows[pname].append(float(vals[i])); i += 1
                data[name] = rows
        else:
            endian = "<" if "little" in fmt else ">"
            for name, count, props in elements:
                rows = {p[0]: [] for p in props}
                if not any(p[2] for p in props):
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    for pname, *_ in props:
                        rows[pname] = arr[pname]
                else:
                    for _ in range(count):
                        for pname, dt, is_list, cnt_dt in props:
                            if is_list:
                                n = int(np.frombuffer(f.read(np.dtype(cnt_dt).itemsize), dtype=endian + cnt_dt)[0])
                                vals = np.frombuffer(f.read(np.dtype(dt).itemsize * n), dtype=endian + dt)
                                rows[pname].append(vals)
                            else:
                                rows[pname].append(
                                    np.frombuffer(f.read(np.dtype(dt).itemsize), dtype=endian + dt)[0]
                                )
                data[name] = rows

    vert = data.get("vertex", {})
    positions = np.stack(
        [np.asarray(vert["x"], np.float32), np.asarray(vert["y"], np.float32), np.asarray(vert["z"], np.float32)],
        axis=1,
    )
    tris: list[list[int]] = []
    if "face" in data:
        face_rows = data["face"].get("vertex_indices", data["face"].get("vertex_index"))
        if face_rows is not None:
            for fc in face_rows:
                fc = [int(x) for x in fc]
                for k in range(1, len(fc) - 1):  # fan-triangulate
                    tris.append([fc[0], fc[k], fc[k + 1]])
    prim = GltfPrimitive(
        positions=positions,
        indices=np.array(tris, np.uint32) if tris else np.zeros((0, 3), np.uint32),
    )
    if "nx" in vert:
        prim.normals = np.stack(
            [np.asarray(vert["nx"], np.float32), np.asarray(vert["ny"], np.float32), np.asarray(vert["nz"], np.float32)],
            axis=1,
        )
    if "red" in vert:
        to_f = lambda a: np.asarray(a, np.float32) / (255.0 if np.asarray(a).dtype.kind == "u" else 1.0)
        alpha = to_f(vert["alpha"]) if "alpha" in vert else np.ones(len(positions), np.float32)
        prim.colors = np.stack([to_f(vert["red"]), to_f(vert["green"]), to_f(vert["blue"]), alpha], axis=1)
    if "texture_u" in vert or "s" in vert:
        u = np.asarray(vert.get("texture_u", vert.get("s")), np.float32)
        v = np.asarray(vert.get("texture_v", vert.get("t")), np.float32)
        prim.texcoords = np.stack([u, 1.0 - v], axis=1)

    doc = GltfDocument()
    doc.meshes.append([prim])
    doc.nodes.append(GltfNode(name=os.path.basename(path), mesh=0))
    doc.roots = [0]
    return doc

