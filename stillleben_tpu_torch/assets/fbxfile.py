"""FBX binary (Kaydara 7.x) importer -> GltfDocument.

Part of the Assimp-fallback format breadth the reference reaches through
``Assimp::Importer`` (reference src/mesh.cpp:203-240) — FBX is the most
common format in that long tail. This is an original reader for the
practical subset stillleben consumes: triangle/polygon meshes with
normals/UVs/vertex colors, per-polygon material assignment, the node
(Model) hierarchy with local TRS transforms, and Phong material colors.

Format notes (public spec, Blender's FBX doc): the file is a tree of node
records, each ``[end_offset, n_props, prop_bytes, name_len, name, props,
children..., null-record]`` with u32 fields before version 7500 and u64
after. Properties are typed scalars ('Y','C','I','F','D','L'), strings
('S'), raw ('R'), or arrays ('b','i','l','f','d') that may be
zlib-deflated (encoding 1).

Copied from ``stillleben_tpu/assets/fbxfile.py`` unchanged: binary (32- and
64-bit record offsets, zlib-compressed arrays) and ASCII FBX, the layer
mappings and the model transforms.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from .gltf import GltfDocument, GltfMaterial, GltfNode, GltfPrimitive

_MAGIC = b"Kaydara FBX Binary  \x00"

_SCALAR = {
    "Y": ("<h", 2),
    "C": ("<b", 1),
    "I": ("<i", 4),
    "F": ("<f", 4),
    "D": ("<d", 8),
    "L": ("<q", 8),
}
_ARRAY = {
    "b": np.int8,
    "i": np.int32,
    "l": np.int64,
    "f": np.float32,
    "d": np.float64,
}


@dataclass
class _FbxNode:
    name: str = ""
    props: list = field(default_factory=list)
    children: list["_FbxNode"] = field(default_factory=list)

    def child(self, name: str) -> "_FbxNode | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str) -> list["_FbxNode"]:
        return [c for c in self.children if c.name == name]


def _read_props(data: bytes, pos: int, count: int) -> tuple[list, int]:
    props = []
    for _ in range(count):
        t = chr(data[pos])
        pos += 1
        if t in _SCALAR:
            fmt, size = _SCALAR[t]
            props.append(struct.unpack_from(fmt, data, pos)[0])
            pos += size
        elif t in _ARRAY:
            n, enc, comp = struct.unpack_from("<III", data, pos)
            pos += 12
            dt = _ARRAY[t]
            if enc == 0:
                raw = data[pos : pos + n * np.dtype(dt).itemsize]
                pos += n * np.dtype(dt).itemsize
            else:
                raw = zlib.decompress(data[pos : pos + comp])
                pos += comp
            props.append(np.frombuffer(raw, dt, count=n))
        elif t == "S":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos : pos + n].decode("utf-8", "replace"))
            pos += n
        elif t == "R":
            n = struct.unpack_from("<I", data, pos)[0]
            pos += 4
            props.append(data[pos : pos + n])
            pos += n
        else:
            raise ValueError(f"FBX: unknown property type {t!r} at {pos - 1}")
    return props, pos


def _read_node(data: bytes, pos: int, wide: bool) -> tuple[_FbxNode | None, int]:
    """One node record; returns (None, new_pos) for the null terminator."""
    if wide:
        end, n_props, _plen = struct.unpack_from("<QQQ", data, pos)
        name_len = data[pos + 24]
        hdr = 25
    else:
        end, n_props, _plen = struct.unpack_from("<III", data, pos)
        name_len = data[pos + 12]
        hdr = 13
    if end == 0:  # null record
        return None, pos + hdr
    name = data[pos + hdr : pos + hdr + name_len].decode("utf-8", "replace")
    pos = pos + hdr + name_len
    node = _FbxNode(name=name)
    node.props, pos = _read_props(data, pos, n_props)
    while pos < end:
        child, pos = _read_node(data, pos, wide)
        if child is None:
            break
        node.children.append(child)
    return node, end


class _AsciiScanner:
    """Character scanner for ASCII FBX: whitespace/comma/;-comment skipping,
    quoted strings, numbers, `*N { a: ... }` arrays, bare identifiers."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self):
        s, n = self.s, len(self.s)
        while self.i < n:
            c = s[self.i]
            if c in " \t\r\n,":
                self.i += 1
            elif c == ";":
                j = s.find("\n", self.i)
                self.i = n if j < 0 else j + 1
            else:
                break

    def peek(self) -> str:
        self.ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def word(self) -> str:
        self.ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_|-"):
            j += 1
        w = self.s[self.i : j]
        self.i = j
        return w

    def string(self) -> str:
        assert self.s[self.i] == '"'
        j = self.s.index('"', self.i + 1)
        v = self.s[self.i + 1 : j]
        self.i = j + 1
        return v

    def number(self):
        j = self.i
        s = self.s
        while j < len(s) and (s[j].isdigit() or s[j] in "+-.eE"):
            j += 1
        tok = s[self.i : j]
        self.i = j
        return float(tok) if any(c in tok for c in ".eE") else int(tok)

    def array(self):
        self.i += 1  # '*'
        self.number()  # declared length (trusted from the payload instead)
        self.ws()
        assert self.s[self.i] == "{"
        j = self.s.index("}", self.i)
        body = self.s[self.i + 1 : j]
        self.i = j + 1
        body = body.split(":", 1)[1] if ":" in body else body
        toks = [t for t in body.replace("\n", ",").split(",") if t.strip()]
        if any(c in t for t in toks for c in ".eE"):
            return np.array([float(t) for t in toks], np.float64)
        return np.array([int(t) for t in toks], np.int64)


def _parse_ascii_node(sc: _AsciiScanner) -> _FbxNode | None:
    if sc.peek() in ("", "}"):
        return None
    name = sc.word()
    sc.ws()
    if sc.peek() == ":":
        sc.i += 1
    node = _FbxNode(name=name)
    while True:
        c = sc.peek()
        if c == '"':
            node.props.append(sc.string())
        elif c == "*":
            node.props.append(sc.array())
        elif c and (c.isdigit() or c in "+-."):
            node.props.append(sc.number())
        elif c and c.isalpha():
            # bare word: a sibling node name if followed by ':', else a flag
            save = sc.i
            w = sc.word()
            if sc.peek() == ":":
                sc.i = save  # sibling node — rewind, stop this node's props
                return node
            node.props.append(w)
        else:
            break
    if sc.peek() == "{":
        sc.i += 1
        while True:
            child = _parse_ascii_node(sc)
            if child is None:
                break
            node.children.append(child)
        sc.ws()
        if sc.peek() == "}":
            sc.i += 1
    return node


def parse_fbx_ascii(text: str) -> list[_FbxNode]:
    """ASCII FBX text -> top-level node list (same tree as the binary
    parser, so all downstream geometry/material/connection code is shared)."""
    sc = _AsciiScanner(text)
    top: list[_FbxNode] = []
    while True:
        node = _parse_ascii_node(sc)
        if node is None:
            break
        top.append(node)
    return top


def parse_fbx(data: bytes) -> tuple[list[_FbxNode], int]:
    """Binary or ASCII FBX bytes -> (top-level node list, version)."""
    if not data.startswith(_MAGIC):
        head = data[:4096].lstrip()
        if head.startswith(b";") or head.startswith(b"FBX"):
            return parse_fbx_ascii(data.decode("utf-8", "replace")), 0
        raise ValueError("not an FBX file (neither binary magic nor ASCII header)")
    version = struct.unpack_from("<I", data, 23)[0]
    wide = version >= 7500
    pos = 27
    top: list[_FbxNode] = []
    while pos < len(data):
        node, pos = _read_node(data, pos, wide)
        if node is None:
            break
        top.append(node)
    return top, version


def _prop70(node: _FbxNode, name: str):
    """Properties70 lookup: returns the value list after the 4 header
    entries, or None."""
    p70 = node.child("Properties70")
    if p70 is None:
        return None
    for p in p70.all("P"):
        if p.props and p.props[0] == name:
            return p.props[4:]
    return None


def _euler_deg_to_mat(rx: float, ry: float, rz: float) -> np.ndarray:
    """FBX eOrderXYZ local rotation (degrees): R = Rz @ Ry @ Rx."""
    a, b, c = np.radians([rx, ry, rz])

    def rot(axis, t):
        ca, sa = np.cos(t), np.sin(t)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = ca
        m[j, j] = ca
        m[i, j] = -sa if axis != 1 else sa
        m[j, i] = sa if axis != 1 else -sa
        return m

    return rot(2, c) @ rot(1, b) @ rot(0, a)


def _model_transform(model: _FbxNode) -> np.ndarray:
    """Practical subset of the FBX transform chain: T * Rpre * R * S."""
    t = _prop70(model, "Lcl Translation") or [0.0, 0.0, 0.0]
    r = _prop70(model, "Lcl Rotation") or [0.0, 0.0, 0.0]
    rp = _prop70(model, "PreRotation") or [0.0, 0.0, 0.0]
    s = _prop70(model, "Lcl Scaling") or [1.0, 1.0, 1.0]
    m = np.eye(4, dtype=np.float32)
    rot = _euler_deg_to_mat(*[float(v) for v in rp]) @ _euler_deg_to_mat(
        *[float(v) for v in r]
    )
    m[:3, :3] = (rot * np.asarray(s, np.float64)[None, :]).astype(np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def _layer_lookup(geom: _FbxNode, layer_name: str, data_name: str, idx_name: str):
    """(mapping, values, index) for a LayerElement, or (None, None, None)."""
    layer = geom.child(layer_name)
    if layer is None:
        return None, None, None
    mapping = ""
    ref = "Direct"
    values = index = None
    for c in layer.children:
        if c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            ref = c.props[0]
        elif c.name == data_name:
            values = np.asarray(c.props[0], np.float64)
        elif c.name == idx_name:
            index = np.asarray(c.props[0], np.int64)
    if values is None:
        return None, None, None
    if ref == "Direct":
        index = None
    return mapping, values, index


def _expand(mapping, values, index, width, corners, corner_pos, corner_poly):
    """Per-corner attribute array (n_corners, width) for any FBX mapping."""
    vals = values.reshape(-1, width)
    if mapping == "ByPolygonVertex":
        sel = index if index is not None else np.arange(len(corners))
    elif mapping in ("ByVertex", "ByVertice", "ByControlPoint"):
        sel = index[corner_pos] if index is not None else corner_pos
    elif mapping == "ByPolygon":
        sel = index[corner_poly] if index is not None else corner_poly
    elif mapping == "AllSame":
        sel = np.zeros(len(corners), np.int64)
    else:
        raise ValueError(f"FBX: unsupported mapping {mapping!r}")
    return vals[sel]


def load_fbx(path: str) -> GltfDocument:
    """Binary FBX -> GltfDocument (unwelded per-corner vertices, polygons
    fan-triangulated; one GltfPrimitive per material slot)."""
    with open(path, "rb") as f:
        data = f.read()
    top, _version = parse_fbx(data)
    root = _FbxNode(name="", children=top)
    objects = root.child("Objects") or _FbxNode()
    connections = root.child("Connections") or _FbxNode()

    doc = GltfDocument()

    # connections: child id -> [parent ids] (OO only; OP carries textures,
    # out of this subset's scope)
    oo_parents: dict[int, list[int]] = {}
    for c in connections.all("C"):
        if len(c.props) >= 3 and c.props[0] == "OO":
            oo_parents.setdefault(int(c.props[1]), []).append(int(c.props[2]))

    # materials
    mat_index: dict[int, int] = {}  # fbx id -> doc.materials index
    for m in objects.all("Material"):
        fid = int(m.props[0])
        gm = GltfMaterial(name=str(m.props[1]).split("\x00")[0])
        gm.metallic = 0.0
        gm.roughness = 0.5
        gm.has_metallic_factor = True
        gm.has_roughness_factor = True
        diff = _prop70(m, "DiffuseColor")
        if diff is not None and len(diff) >= 3:
            gm.base_color = np.array(
                [float(diff[0]), float(diff[1]), float(diff[2]), 1.0], np.float32
            )
        mat_index[fid] = len(doc.materials)
        doc.materials.append(gm)

    # models: fbx id -> node index; collect material slots in connection order
    model_node: dict[int, int] = {}
    model_mats: dict[int, list[int]] = {}
    models = [m for m in objects.all("Model") if len(m.props) >= 3]
    for m in models:
        fid = int(m.props[0])
        name = str(m.props[1]).split("\x00")[0]
        node = GltfNode(name=name, transform=_model_transform(m))
        model_node[fid] = len(doc.nodes)
        doc.nodes.append(node)
        model_mats[fid] = []
    for c in connections.all("C"):
        if len(c.props) >= 3 and c.props[0] == "OO":
            child, parent = int(c.props[1]), int(c.props[2])
            if child in mat_index and parent in model_mats:
                model_mats[parent].append(mat_index[child])

    # geometries
    for g in objects.all("Geometry"):
        if len(g.props) >= 3 and g.props[2] != "Mesh":
            continue
        fid = int(g.props[0])
        verts_node = g.child("Vertices")
        poly_node = g.child("PolygonVertexIndex")
        if verts_node is None or poly_node is None:
            continue
        positions = np.asarray(verts_node.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(poly_node.props[0], np.int64)

        # corners + polygon ids (negative index = last corner, value ~v)
        corner_pos = np.where(pvi < 0, ~pvi, pvi)
        poly_end = np.flatnonzero(pvi < 0)
        corner_poly = np.cumsum(
            np.concatenate([[0], (pvi < 0)[:-1].astype(np.int64)])
        )
        corners = np.arange(len(pvi))

        # fan triangulation over corner ids
        tris = []
        start = 0
        for end in poly_end:
            n = end - start + 1
            for j in range(1, n - 1):
                tris.append((start, start + j, start + j + 1))
            start = end + 1
        tri_corners = np.asarray(tris, np.int64).reshape(-1, 3)
        tri_poly = corner_poly[tri_corners[:, 0]]

        nm = _layer_lookup(g, "LayerElementNormal", "Normals", "NormalsIndex")
        uv = _layer_lookup(g, "LayerElementUV", "UV", "UVIndex")
        col = _layer_lookup(g, "LayerElementColor", "Colors", "ColorIndex")
        normals = (
            _expand(*nm, 3, corners, corner_pos, corner_poly) if nm[1] is not None else None
        )
        uvs = _expand(*uv, 2, corners, corner_pos, corner_poly) if uv[1] is not None else None
        colors = (
            _expand(*col, 4, corners, corner_pos, corner_poly) if col[1] is not None else None
        )

        # per-triangle material slot
        lm = g.child("LayerElementMaterial")
        slots = next(
            (model_mats[p] for p in oo_parents.get(fid, []) if p in model_mats),
            [],
        )
        tri_slot = np.zeros(len(tri_corners), np.int64)
        if lm is not None:
            mats_node = lm.child("Materials")
            mapping_node = lm.child("MappingInformationType")
            if mats_node is not None and len(mats_node.props):
                marr = np.asarray(mats_node.props[0], np.int64)
                mapping = mapping_node.props[0] if mapping_node else "AllSame"
                if mapping == "ByPolygon" and len(marr) > 0:
                    tri_slot = marr[np.minimum(tri_poly, len(marr) - 1)]
                elif len(marr) > 0:
                    tri_slot[:] = marr[0]

        prims = []
        for slot in np.unique(tri_slot):
            sel = tri_corners[tri_slot == slot]
            used, inv = np.unique(sel.reshape(-1), return_inverse=True)
            prim = GltfPrimitive(
                positions=positions[corner_pos[used]].astype(np.float32),
                indices=inv.reshape(-1, 3).astype(np.uint32),
                material=(
                    slots[int(slot)] if int(slot) < len(slots) else -1
                ),
            )
            if normals is not None:
                prim.normals = normals[used].astype(np.float32)
            if uvs is not None:
                prim.texcoords = uvs[used].astype(np.float32)
            if colors is not None:
                prim.colors = colors[used].astype(np.float32)
            prims.append(prim)

        mesh_id = len(doc.meshes)
        doc.meshes.append(prims)
        for parent in oo_parents.get(fid, []):
            if parent in model_node and doc.nodes[model_node[parent]].mesh < 0:
                doc.nodes[model_node[parent]].mesh = mesh_id

    # hierarchy: Model -> Model parent; parent id 0 = scene root
    child_of: set[int] = set()
    for c in connections.all("C"):
        if len(c.props) >= 3 and c.props[0] == "OO":
            child, parent = int(c.props[1]), int(c.props[2])
            if child in model_node and parent in model_node:
                doc.nodes[model_node[parent]].children.append(model_node[child])
                child_of.add(model_node[child])
    doc.roots = [i for fid, i in model_node.items() if i not in child_of]
    if not doc.roots and doc.meshes:
        # headless geometry (no Model objects): synthesize a node per mesh
        for mi in range(len(doc.meshes)):
            doc.nodes.append(GltfNode(name=os.path.basename(path), mesh=mi))
            doc.roots.append(len(doc.nodes) - 1)
    return doc
