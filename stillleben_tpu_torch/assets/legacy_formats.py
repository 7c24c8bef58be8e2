"""Autodesk 3DS and DirectX .x importers -> GltfDocument.

The reference imports these through Assimp (src/mesh.cpp:219-239 accepts the
whole Assimp extension list; .3ds/.x are the practical tail beyond
OBJ/PLY/STL/OFF/DAE/FBX/glTF). Both are self-contained parsers:

* **.3ds** — the classic chunked binary: MAIN(0x4D4D) > EDITOR(0x3D3D) >
  OBJECT(0x4000) > TRIMESH(0x4100) with VERTICES(0x4110), FACES(0x4120),
  per-face MSH_MAT_GROUP(0x4130), TEXCOORDS(0x4140); MATERIAL(0xAFFF) blocks
  with name(0xA000), diffuse(0xA020) and texture map(0xA200>0xA300).
  Unknown chunks are skipped by length, so files from any exporter load.
  The pivot matrix chunk (0x4160) is ignored: 3DS vertices are stored in
  mesh space already (the matrix matters only for keyframer animation).
* **.x** — the DirectX text format: ``Mesh`` blocks with vertex/face
  arrays plus optional ``MeshNormals`` / ``MeshTextureCoords`` /
  ``MeshMaterialList`` (per-face material indices + inline ``Material``
  blocks). Binary .x files are rejected with a clear error.

Faces with per-face materials are split into one GltfPrimitive per
material, matching how the consolidator builds sub-meshes.

Copied from ``stillleben_tpu/assets/legacy_formats.py`` with two faults of
that file fixed, to the reference's (Assimp's) semantics:

* a 3DS material without a name chunk is named ``UNNAMED_<index>``, as
  Assimp's 3DS importer names it, so unnamed materials stay distinct (the
  JAX package keys them all by ``""``, and the last one wins);
* the ``.x`` reference form ``{ MaterialName }`` inside a
  ``MeshMaterialList`` resolves the top-level ``Material`` of that name (the
  JAX package consumes the reference's ``}`` as the list's end).
"""

from __future__ import annotations

import re
import struct

import numpy as np

from .gltf import GltfDocument, GltfMaterial, GltfNode, GltfPrimitive

# ---------------------------------------------------------------------------
# 3DS
# ---------------------------------------------------------------------------

_M3D_MAIN = 0x4D4D
_M3D_EDITOR = 0x3D3D
_M3D_OBJECT = 0x4000
_M3D_TRIMESH = 0x4100
_M3D_VERTICES = 0x4110
_M3D_FACES = 0x4120
_M3D_MAT_GROUP = 0x4130
_M3D_TEXCOORDS = 0x4140
_M3D_MATERIAL = 0xAFFF
_M3D_MAT_NAME = 0xA000
_M3D_MAT_DIFFUSE = 0xA020
_M3D_MAT_TEXMAP = 0xA200
_M3D_MAT_MAPFILE = 0xA300
_COLOR_F32 = 0x0010
_COLOR_U8 = 0x0011
_COLOR_U8_GAMMA = 0x0012
_COLOR_F32_GAMMA = 0x0013


def _cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _chunks(buf: bytes, start: int, end: int):
    """Iterate (chunk_id, payload_start, payload_end) inside [start, end)."""
    off = start
    while off + 6 <= end:
        cid, length = struct.unpack_from("<HI", buf, off)
        if length < 6 or off + length > end:
            break  # malformed tail — stop rather than walk off the buffer
        yield cid, off + 6, off + length
        off += length


def _read_color(buf: bytes, start: int, end: int) -> np.ndarray:
    for cid, s, e in _chunks(buf, start, end):
        if cid in (_COLOR_U8, _COLOR_U8_GAMMA):
            r, g, b = struct.unpack_from("<3B", buf, s)
            return np.array([r / 255.0, g / 255.0, b / 255.0, 1.0], np.float32)
        if cid in (_COLOR_F32, _COLOR_F32_GAMMA):
            r, g, b = struct.unpack_from("<3f", buf, s)
            return np.array([r, g, b, 1.0], np.float32)
    return np.ones(4, np.float32)


def load_3ds(path: str) -> GltfDocument:
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 6 or struct.unpack_from("<H", buf, 0)[0] != _M3D_MAIN:
        raise ValueError(f"{path}: not a 3DS file (missing 0x4D4D chunk)")

    doc = GltfDocument()
    mat_index: dict[str, int] = {}

    def parse_material(start: int, end: int) -> None:
        mat = GltfMaterial(name=f"UNNAMED_{len(doc.materials)}", metallic=0.0, roughness=1.0)
        for cid, s, e in _chunks(buf, start, end):
            if cid == _M3D_MAT_NAME:
                mat.name, _ = _cstr(buf, s)
            elif cid == _M3D_MAT_DIFFUSE:
                mat.base_color = _read_color(buf, s, e)
            elif cid == _M3D_MAT_TEXMAP:
                for c2, s2, e2 in _chunks(buf, s, e):
                    if c2 == _M3D_MAT_MAPFILE:
                        # texture files are resolved by the caller's image
                        # loader if present next to the mesh; record nothing
                        # here (the reference drops unresolvable maps too)
                        pass
        mat_index[mat.name] = len(doc.materials)
        doc.materials.append(mat)

    def parse_trimesh(name: str, start: int, end: int) -> None:
        positions = np.zeros((0, 3), np.float32)
        texcoords = None
        faces = np.zeros((0, 3), np.uint32)
        groups: list[tuple[str, np.ndarray]] = []
        for cid, s, e in _chunks(buf, start, end):
            if cid == _M3D_VERTICES:
                (n,) = struct.unpack_from("<H", buf, s)
                positions = np.frombuffer(
                    buf, "<f4", count=3 * n, offset=s + 2
                ).reshape(n, 3).astype(np.float32)
            elif cid == _M3D_TEXCOORDS:
                (n,) = struct.unpack_from("<H", buf, s)
                texcoords = np.frombuffer(
                    buf, "<f4", count=2 * n, offset=s + 2
                ).reshape(n, 2).astype(np.float32)
            elif cid == _M3D_FACES:
                (n,) = struct.unpack_from("<H", buf, s)
                fd = np.frombuffer(buf, "<u2", count=4 * n, offset=s + 2)
                faces = fd.reshape(n, 4)[:, :3].astype(np.uint32)
                # MSH_MAT_GROUP subchunks follow the face array
                for c2, s2, e2 in _chunks(buf, s + 2 + 8 * n, e):
                    if c2 == _M3D_MAT_GROUP:
                        mname, off2 = _cstr(buf, s2)
                        (k,) = struct.unpack_from("<H", buf, off2)
                        idx = np.frombuffer(
                            buf, "<u2", count=k, offset=off2 + 2
                        ).astype(np.int64)
                        groups.append((mname, idx))
        if len(positions) == 0 or len(faces) == 0:
            return

        prims: list[GltfPrimitive] = []
        assigned = np.zeros(len(faces), bool)
        for mname, idx in groups:
            idx = idx[idx < len(faces)]
            if len(idx) == 0:
                continue
            assigned[idx] = True
            prims.append(
                GltfPrimitive(
                    positions=positions,
                    indices=faces[idx],
                    texcoords=texcoords,
                    material=mat_index.get(mname, -1),
                )
            )
        if not assigned.all():  # ungrouped faces: default material
            prims.append(
                GltfPrimitive(
                    positions=positions,
                    indices=faces[~assigned],
                    texcoords=texcoords,
                    material=-1,
                )
            )
        doc.nodes.append(
            GltfNode(name=name, mesh=len(doc.meshes))
        )
        doc.roots.append(len(doc.nodes) - 1)
        doc.meshes.append(prims)

    for cid, s, e in _chunks(buf, 0, len(buf)):
        if cid != _M3D_MAIN:
            continue
        for c1, s1, e1 in _chunks(buf, s, e):
            if c1 != _M3D_EDITOR:
                continue
            # materials first so face groups can resolve names
            for c2, s2, e2 in _chunks(buf, s1, e1):
                if c2 == _M3D_MATERIAL:
                    parse_material(s2, e2)
            for c2, s2, e2 in _chunks(buf, s1, e1):
                if c2 == _M3D_OBJECT:
                    name, off = _cstr(buf, s2)
                    for c3, s3, e3 in _chunks(buf, off, e2):
                        if c3 == _M3D_TRIMESH:
                            parse_trimesh(name, s3, e3)

    if not doc.meshes:
        raise ValueError(f"{path}: no triangle meshes found in 3DS file")
    return doc


# ---------------------------------------------------------------------------
# DirectX .x (text)
# ---------------------------------------------------------------------------

_X_TOKEN = re.compile(r"[A-Za-z_][\w]*|[{}]|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?\d+)?|[;,]|\"[^\"]*\"")


def _x_tokens(text: str):
    # strip // and # comments
    lines = []
    for line in text.splitlines():
        for marker in ("//", "#"):
            i = line.find(marker)
            if i >= 0:
                line = line[:i]
        lines.append(line)
    return _X_TOKEN.findall("\n".join(lines))


class _XParser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def skip_seps(self):
        while self.peek() in (";", ","):
            self.next()

    def number(self) -> float:
        self.skip_seps()
        return float(self.next())

    def integer(self) -> int:
        return int(self.number())

    def skip_block(self):
        """Skip a balanced { ... } block (current token must be '{')."""
        depth = 0
        while True:
            t = self.next()
            if t == "{":
                depth += 1
            elif t == "}":
                depth -= 1
                if depth == 0:
                    return


def load_x(path: str) -> GltfDocument:
    with open(path, "rb") as f:
        head = f.read(16)
        rest = f.read()
    if not head.startswith(b"xof "):
        raise ValueError(f"{path}: not a DirectX .x file (missing 'xof ' magic)")
    if b"txt" not in head[8:12]:
        raise ValueError(
            f"{path}: only text-format .x is supported (header {head!r})"
        )
    p = _XParser(_x_tokens(rest.decode("latin-1")))

    doc = GltfDocument()
    named: dict[str, int] = {}  # material name -> doc.materials index

    def parse_float_n(n: int) -> np.ndarray:
        return np.array([p.number() for _ in range(n)], np.float32)

    def parse_material() -> int:
        # Material { faceColor;; power; specular;; emissive;; [TextureFilename] }
        name = None
        if p.peek() and p.peek() not in "{}":
            name = p.next()  # optional name
        assert p.next() == "{"
        rgba = parse_float_n(4)
        p.number()  # specular power
        parse_float_n(3)  # specular
        emissive = parse_float_n(3)
        p.skip_seps()
        mat = GltfMaterial(
            base_color=rgba, emissive=emissive, metallic=0.0, roughness=1.0
        )
        while p.peek() != "}":
            t = p.next()
            if t == "TextureFilename":
                assert p.next() == "{"
                p.next()  # quoted filename — textures resolved by caller
                p.skip_seps()
                assert p.next() == "}"
            elif p.peek() == "{":
                p.next()
                p.skip_block()
        p.next()  # }
        doc.materials.append(mat)
        if name is not None:
            named[name] = len(doc.materials) - 1
        return len(doc.materials) - 1

    def parse_faces() -> list[list[int]]:
        nf = p.integer()
        out = []
        for _ in range(nf):
            k = p.integer()
            poly = [p.integer() for _ in range(k)]
            out.append(poly)
        return out

    def triangulate(polys: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
        """Fan-triangulate; returns (tris, poly_index per tri)."""
        tris, src = [], []
        for pi, poly in enumerate(polys):
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
                src.append(pi)
        return np.array(tris, np.uint32).reshape(-1, 3), np.array(src, np.int64)

    def parse_mesh(name: str):
        nv = p.integer()
        positions = np.stack([parse_float_n(3) for _ in range(nv)])
        polys = parse_faces()
        tris, tri_poly = triangulate(polys)
        normals = texcoords = None
        face_mats = None
        mat_ids: list[int] = []
        while True:
            p.skip_seps()
            t = p.peek()
            if t == "}":
                p.next()
                break
            t = p.next()
            if t == "MeshNormals":
                assert p.next() == "{"
                nn = p.integer()
                nrm = np.stack([parse_float_n(3) for _ in range(nn)])
                parse_faces()  # normal faces — assume same topology
                normals = nrm if nn == nv else None
                p.skip_seps()
                assert p.next() == "}"
            elif t == "MeshTextureCoords":
                assert p.next() == "{"
                nt = p.integer()
                uv = np.stack([parse_float_n(2) for _ in range(nt)])
                texcoords = uv if nt == nv else None
                p.skip_seps()
                assert p.next() == "}"
            elif t == "MeshMaterialList":
                assert p.next() == "{"
                p.integer()  # nMaterials
                nfi = p.integer()
                face_mats = np.array(
                    [p.integer() for _ in range(nfi)], np.int64
                )
                p.skip_seps()
                while p.peek() != "}":
                    t2 = p.next()
                    if t2 == "Material":
                        mat_ids.append(parse_material())
                    elif t2 == "{":  # a reference to a top-level material: { name }
                        ref = p.next()
                        assert p.next() == "}"
                        mat_ids.append(named.get(ref, -1))
                    elif p.peek() == "{":
                        p.next()
                        p.skip_block()
                p.next()  # }
            elif t == "{":
                p.skip_block()
            elif p.peek() == "{":
                p.next()
                p.skip_block()

        prims: list[GltfPrimitive] = []
        if face_mats is not None and len(mat_ids) > 0 and len(tris) > 0:
            fm = face_mats[np.clip(tri_poly, 0, len(face_mats) - 1)]
            for mi in np.unique(fm):
                sel = tris[fm == mi]
                mat = mat_ids[mi] if 0 <= mi < len(mat_ids) else -1
                prims.append(
                    GltfPrimitive(
                        positions=positions, indices=sel, normals=normals,
                        texcoords=texcoords, material=mat,
                    )
                )
        else:
            prims.append(
                GltfPrimitive(
                    positions=positions, indices=tris, normals=normals,
                    texcoords=texcoords, material=-1,
                )
            )
        doc.nodes.append(GltfNode(name=name, mesh=len(doc.meshes)))
        doc.roots.append(len(doc.nodes) - 1)
        doc.meshes.append(prims)

    def parse_frame_or_top():
        while p.peek() is not None:
            t = p.next()
            if t == "Mesh":
                name = ""
                if p.peek() not in ("{",):
                    name = p.next()
                assert p.next() == "{"
                parse_mesh(name)
            elif t == "Material":
                parse_material()
            elif t == "Frame":
                if p.peek() != "{":
                    p.next()  # frame name
                assert p.next() == "{"
                # recurse inline: frames just scope meshes; transforms are
                # rarely used by static assets — apply identity (the
                # consolidator bakes node transforms for formats that carry
                # them; .x FrameTransformMatrix support can be added when a
                # real asset needs it)
                continue
            elif t == "}":
                continue
            elif t == "template":
                if p.peek() != "{":
                    p.next()
                if p.peek() == "{":
                    p.next()
                    p.skip_block()
            elif p.peek() == "{":
                p.next()
                p.skip_block()

    parse_frame_or_top()
    if not doc.meshes:
        raise ValueError(f"{path}: no Mesh blocks found in .x file")
    return doc
