"""Wavefront OBJ (+MTL), PLY, STL, OFF and COLLADA loaders -> GltfDocument.

Copied from ``stillleben_tpu/assets/objfile.py`` (``_load_mtl``,
``load_obj``, ``load_ply``, ``load_stl``, ``load_off``, ``load_dae``). A
``map_Kd`` or COLLADA image is decoded by the port's own codec
(``assets/image.py``: PNG and binary PPM; any other format raises by name)
instead of Pillow.

Covers the practical subset the reference reaches through Assimp
(src/mesh.cpp:219-239): triangulated (we fan-triangulate polygons), per-face
materials, Kd/map_Kd diffuse, vertex colors (PLY), ascii + binary PLY.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET

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


def load_stl(path: str) -> GltfDocument:
    """STL (binary or ascii) -> GltfDocument. Part of the Assimp-fallback
    format breadth the reference reaches via src/mesh.cpp:203-240. STL stores
    independent triangles; coincident vertices are welded so physics hulls
    and smooth normals behave."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        data = f.read()
    if head == b"solid" and b"facet" in data[:1000]:
        # ascii
        verts = []
        for line in data.decode("ascii", "replace").splitlines():
            parts = line.split()
            if parts and parts[0] == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        tri_pts = np.array(verts, np.float32).reshape(-1, 3, 3)
    else:
        n = struct.unpack_from("<I", data, 80)[0]
        rec = np.frombuffer(data, np.uint8, count=n * 50, offset=84).reshape(n, 50)
        tri = rec[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
        tri_pts = np.ascontiguousarray(tri)

    flat = tri_pts.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=6), axis=0, return_inverse=True)
    prim = GltfPrimitive(
        positions=uniq.astype(np.float32),
        indices=inv.reshape(-1, 3).astype(np.uint32),
    )
    doc = GltfDocument()
    doc.meshes.append([prim])
    doc.nodes.append(GltfNode(name=os.path.basename(path), mesh=0))
    doc.roots = [0]
    return doc


def load_off(path: str) -> GltfDocument:
    """OFF (Object File Format) -> GltfDocument (fan-triangulated)."""
    with open(path, "r", errors="replace") as f:
        tokens: list[str] = []
        for line in f:
            hash_at = line.find("#")
            if hash_at >= 0:
                line = line[:hash_at]
            tokens.extend(line.split())
    if not tokens or tokens[0] not in ("OFF", "COFF", "NOFF"):
        raise ValueError(f"{path}: not an OFF file")
    has_color = tokens[0] == "COFF"
    has_normal = tokens[0] == "NOFF"
    i = 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    stride = 3 + (4 if has_color else 0) + (3 if has_normal else 0)
    vdata = np.array(tokens[i : i + nv * stride], np.float32).reshape(nv, stride)
    i += nv * stride
    positions = vdata[:, :3].copy()
    prim = GltfPrimitive(positions=positions, indices=np.zeros((0, 3), np.uint32))
    col = 3
    if has_normal:
        prim.normals = vdata[:, col : col + 3].copy()
        col += 3
    if has_color:
        c = vdata[:, col : col + 4]
        prim.colors = (c / 255.0 if c.max() > 1.0 else c).astype(np.float32)
    tris = []
    while i < len(tokens) and len(tris) >= 0 and nf > 0:
        k = int(tokens[i])
        face = [int(t) for t in tokens[i + 1 : i + 1 + k]]
        i += 1 + k
        # COFF may append per-face colors; skip any trailing floats
        while i < len(tokens) and "." in tokens[i]:
            i += 1
        for j in range(1, k - 1):
            tris.append([face[0], face[j], face[j + 1]])
        nf -= 1
    prim.indices = np.array(tris, np.uint32) if tris else np.zeros((0, 3), np.uint32)
    doc = GltfDocument()
    doc.meshes.append([prim])
    doc.nodes.append(GltfNode(name=os.path.basename(path), mesh=0))
    doc.roots = [0]
    return doc


def load_dae(path: str) -> GltfDocument:
    """COLLADA .dae (practical subset: <triangles>/<polylist> geometry,
    node transforms, effect diffuse color/texture) -> GltfDocument."""
    tree = ET.parse(path)
    root = tree.getroot()
    ns = {"c": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {"c": ""}

    def q(tag):
        return f"{{{ns['c']}}}{tag}" if ns["c"] else tag

    def findall(el, *tags):
        cur = [el]
        for t in tags:
            nxt = []
            for e in cur:
                nxt.extend(e.findall(q(t)))
            cur = nxt
        return cur

    base = os.path.dirname(os.path.abspath(path))
    doc = GltfDocument()

    # images
    image_ids: dict[str, int] = {}
    for img in findall(root, "library_images", "image"):
        init = img.find(q("init_from"))
        if init is None or not init.text:
            continue
        p = os.path.join(base, init.text.strip())
        if os.path.exists(p):
            image_ids[img.get("id", "")] = len(doc.images)
            doc.images.append(read_image(p))

    # effects -> materials
    effect_mat: dict[str, int] = {}
    for eff in findall(root, "library_effects", "effect"):
        gm = GltfMaterial(name=eff.get("id", ""))
        gm.metallic = 0.0
        gm.roughness = 0.5
        gm.has_metallic_factor = True
        gm.has_roughness_factor = True
        # surface init_from -> image (COLLADA indirects sampler->surface->image)
        surf_img: dict[str, str] = {}
        for np_ in eff.iter(q("newparam")):
            s = np_.find(q("surface"))
            if s is not None:
                init = s.find(q("init_from"))
                if init is not None and init.text:
                    surf_img[np_.get("sid", "")] = init.text.strip()
        sampler_src = {
            np_.get("sid", ""): (np_.find(q("sampler2D")).find(q("source")).text or "").strip()
            for np_ in eff.iter(q("newparam"))
            if np_.find(q("sampler2D")) is not None
            and np_.find(q("sampler2D")).find(q("source")) is not None
        }
        diffuse = next(iter(eff.iter(q("diffuse"))), None)
        if diffuse is not None:
            color = diffuse.find(q("color"))
            texture = diffuse.find(q("texture"))
            if color is not None and color.text:
                gm.base_color = np.array(color.text.split(), np.float32)[:4]
            if texture is not None:
                tex_ref = texture.get("texture", "")
                img_id = surf_img.get(sampler_src.get(tex_ref, ""), tex_ref)
                if img_id in image_ids:
                    gm.base_color_texture = image_ids[img_id]
        effect_mat[eff.get("id", "")] = len(doc.materials)
        doc.materials.append(gm)
    # material id -> effect
    mat_by_id: dict[str, int] = {}
    for mat in findall(root, "library_materials", "material"):
        inst = mat.find(q("instance_effect"))
        if inst is not None:
            url = (inst.get("url") or "").lstrip("#")
            if url in effect_mat:
                mat_by_id[mat.get("id", "")] = effect_mat[url]

    def read_source(mesh_el, source_id):
        for src in mesh_el.findall(q("source")):
            if src.get("id") == source_id.lstrip("#"):
                arr = src.find(q("float_array"))
                if arr is not None and arr.text:
                    vals = np.array(arr.text.split(), np.float32)
                    acc = src.find(q("technique_common"))
                    stride = 3
                    if acc is not None:
                        a = acc.find(q("accessor"))
                        if a is not None:
                            stride = int(a.get("stride", 3))
                    return vals.reshape(-1, stride)
        return None

    geom_mesh: dict[str, int] = {}
    for geom in findall(root, "library_geometries", "geometry"):
        mesh_el = geom.find(q("mesh"))
        if mesh_el is None:
            continue
        # vertices id -> position source
        vert_src = {}
        for v in mesh_el.findall(q("vertices")):
            for inp in v.findall(q("input")):
                if inp.get("semantic") == "POSITION":
                    vert_src[v.get("id", "")] = inp.get("source", "")
        prims = []
        for tri_el in list(mesh_el.findall(q("triangles"))) + list(
            mesh_el.findall(q("polylist"))
        ):
            inputs = []
            for inp in tri_el.findall(q("input")):
                inputs.append(
                    (
                        inp.get("semantic"),
                        inp.get("source", ""),
                        int(inp.get("offset", 0)),
                    )
                )
            stride = max(o for _, _, o in inputs) + 1 if inputs else 1
            p_el = tri_el.find(q("p"))
            if p_el is None or not p_el.text:
                continue
            idx = np.array(p_el.text.split(), np.int64).reshape(-1, stride)
            vcount_el = tri_el.find(q("vcount"))
            if vcount_el is not None and vcount_el.text:
                # polylist: fan-triangulate
                counts = np.array(vcount_el.text.split(), np.int64)
                tri_rows = []
                at = 0
                for c in counts:
                    for j in range(1, int(c) - 1):
                        tri_rows.extend([idx[at], idx[at + j], idx[at + j + 1]])
                    at += int(c)
                idx = np.stack(tri_rows)
            corners = idx.reshape(-1, stride)
            # unique corner tuples -> glTF-style single-index vertices
            uniq, inv = np.unique(corners, axis=0, return_inverse=True)
            pos = nrm = uv = None
            for sem, src, off in inputs:
                if sem == "VERTEX":
                    data = read_source(mesh_el, vert_src.get(src.lstrip("#"), src))
                    if data is not None:
                        pos = data[uniq[:, off]][:, :3]
                elif sem == "NORMAL":
                    data = read_source(mesh_el, src)
                    if data is not None:
                        nrm = data[uniq[:, off]][:, :3]
                elif sem == "TEXCOORD":
                    data = read_source(mesh_el, src)
                    if data is not None and uv is None:
                        t = data[uniq[:, off]][:, :2]
                        uv = np.stack([t[:, 0], 1.0 - t[:, 1]], axis=1)
            if pos is None:
                continue
            mat_sym = tri_el.get("material", "")
            mat_idx = mat_by_id.get(mat_sym, -1)
            prims.append(
                GltfPrimitive(
                    positions=np.ascontiguousarray(pos, np.float32),
                    indices=inv.reshape(-1, 3).astype(np.uint32),
                    normals=None if nrm is None else np.ascontiguousarray(nrm, np.float32),
                    texcoords=None if uv is None else np.ascontiguousarray(uv, np.float32),
                    material=mat_idx,
                )
            )
        geom_mesh[geom.get("id", "")] = len(doc.meshes)
        doc.meshes.append(prims)

    # scene nodes (visual_scene); instance_geometry materials may rebind via
    # instance_material but the practical subset maps by geometry material
    def walk(node_el, parent_idx):
        T = np.eye(4, dtype=np.float32)
        mx = node_el.find(q("matrix"))
        if mx is not None and mx.text:
            T = np.array(mx.text.split(), np.float32).reshape(4, 4)
        n = GltfNode(name=node_el.get("name", ""), transform=T)
        idx = len(doc.nodes)
        doc.nodes.append(n)
        if parent_idx is None:
            doc.roots.append(idx)
        else:
            doc.nodes[parent_idx].children.append(idx)
        for ig in node_el.findall(q("instance_geometry")):
            url = (ig.get("url") or "").lstrip("#")
            if url in geom_mesh and n.mesh < 0:
                n.mesh = geom_mesh[url]
        for child in node_el.findall(q("node")):
            walk(child, idx)

    scenes = findall(root, "library_visual_scenes", "visual_scene")
    for vs in scenes:
        for node_el in vs.findall(q("node")):
            walk(node_el, None)
    if not doc.roots and doc.meshes:
        for mi in range(len(doc.meshes)):
            doc.nodes.append(GltfNode(name=f"geom{mi}", mesh=mi))
            doc.roots.append(len(doc.nodes) - 1)
    return doc
