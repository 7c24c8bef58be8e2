"""Writers of the mesh formats the loaders read, for in-repo fixtures.

numpy and the standard library only. Each writer takes one triangle
primitive (``GltfPrimitive``: positions, uint32 indices, optional normals
and uvs, uvs with v pointing down as the loaders hand them out) and writes
it so that the port's loader reads the same positions back: float32
values are stored in full (binary) or with 9 significant digits (text),
and vertex order and faces are kept wherever the format keeps them.
``procedural.write_loader_fixtures`` uses them.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import zlib

import numpy as np

from .gltf import GltfPrimitive


def atomic_write(path: str, data: bytes | str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    os.replace(tmp, path)


def _floats(a) -> str:
    return " ".join(f"{float(v):.9g}" for v in np.asarray(a).reshape(-1))


# ---------------------------------------------------------------------------
# glTF / GLB
# ---------------------------------------------------------------------------


def _gltf_parts(prim: GltfPrimitive, image: bytes | None, embed_image: bool,
                mime: str = "image/png"):
    """(json dict without buffers, binary blob); the image, if embedded,
    is a bufferView of the blob."""
    arrays = [("POSITION", prim.positions.astype(np.float32), "VEC3", 5126, 34962)]
    if prim.normals is not None:
        arrays.append(("NORMAL", prim.normals.astype(np.float32), "VEC3", 5126, 34962))
    if prim.texcoords is not None:
        arrays.append(("TEXCOORD_0", prim.texcoords.astype(np.float32), "VEC2", 5126, 34962))
    arrays.append(("indices", prim.indices.astype(np.uint32).reshape(-1), "SCALAR", 5125, 34963))
    blob = bytearray()
    views, accessors, attributes = [], [], {}
    for name, arr, kind, comp, target in arrays:
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes,
                      "target": target})
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": kind}
        if name == "POSITION":
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        accessors.append(acc)
        if name != "indices":
            attributes[name] = len(accessors) - 1
        blob += arr.tobytes()
        blob += b"\0" * (-len(blob) % 4)
    doc = {
        "asset": {"version": "2.0", "generator": "stillleben_tpu_torch fixtures"},
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"name": "blob", "mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": len(accessors) - 1,
                                    "material": 0}]}],
        "materials": [{"name": "blob", "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.5}}],
        "accessors": accessors, "bufferViews": views,
    }
    if image is not None:
        pbr = doc["materials"][0]["pbrMetallicRoughness"]
        pbr["baseColorTexture"] = {"index": 0}
        doc["textures"] = [{"source": 0}]
        if embed_image:
            views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(image)})
            doc["images"] = [{"bufferView": len(views) - 1, "mimeType": mime}]
            blob += image
            blob += b"\0" * (-len(blob) % 4)
    return doc, bytes(blob)


def write_glb(path: str, prim: GltfPrimitive, image: bytes | None = None,
              mime: str = "image/png") -> None:
    """One mesh node; the image (if given, of type ``mime``) embedded as the
    base-colour texture."""
    doc, blob = _gltf_parts(prim, image, embed_image=True, mime=mime)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    atomic_write(path, struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


def write_gltf(path: str, prim: GltfPrimitive, bin_name: str, image_uri: str | None = None) -> None:
    """``.gltf`` JSON with an external buffer ``bin_name`` beside it (its
    URI ``%``-escaped) and the texture, if given, as an external image URI."""
    from urllib.parse import quote

    doc, blob = _gltf_parts(prim, None, embed_image=False)
    doc["buffers"] = [{"byteLength": len(blob), "uri": quote(bin_name)}]
    if image_uri is not None:
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
        doc["textures"] = [{"source": 0}]
        doc["images"] = [{"uri": image_uri}]
    atomic_write(os.path.join(os.path.dirname(path), bin_name), blob)
    atomic_write(path, json.dumps(doc, indent=1))


def data_uri(data: bytes, mime: str = "application/octet-stream") -> str:
    return f"data:{mime};base64," + base64.b64encode(data).decode()


# ---------------------------------------------------------------------------
# FBX (binary 7.4 / 7.5 and ASCII)
# ---------------------------------------------------------------------------


def _fbx_prop(v) -> bytes:
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    raise TypeError(type(v))


def _fbx_array(arr: np.ndarray, compress: bool) -> bytes:
    tag = {np.dtype(np.float64): b"d", np.dtype(np.int32): b"i"}[arr.dtype]
    raw = arr.tobytes()
    if compress:
        comp = zlib.compress(raw)
        return tag + struct.pack("<III", arr.size, 1, len(comp)) + comp
    return tag + struct.pack("<III", arr.size, 0, len(raw)) + raw


def _fbx_tree(prim: GltfPrimitive, color):
    """(name, props, children) nodes of one mesh: a Geometry (control
    points, polygon vertex indices, ByPolygonVertex normals, IndexToDirect
    uvs, one material AllSame), a Model at identity and a Material, and
    their connections. Array props are numpy arrays."""
    faces = prim.indices.astype(np.int32)
    pvi = faces.copy()
    pvi[:, 2] = ~pvi[:, 2]
    layers = []
    if prim.normals is not None:
        layers.append(("LayerElementNormal", [0], [
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", ["Direct"], []),
            ("Normals", [prim.normals[faces].reshape(-1).astype(np.float64)], []),
        ]))
    if prim.texcoords is not None:
        layers.append(("LayerElementUV", [0], [
            ("MappingInformationType", ["ByPolygonVertex"], []),
            ("ReferenceInformationType", ["IndexToDirect"], []),
            ("UV", [prim.texcoords.reshape(-1).astype(np.float64)], []),
            ("UVIndex", [faces.reshape(-1)], []),
        ]))
    layers.append(("LayerElementMaterial", [0], [
        ("MappingInformationType", ["AllSame"], []),
        ("ReferenceInformationType", ["IndexToDirect"], []),
        ("Materials", [np.zeros(1, np.int32)], []),
    ]))
    geometry = ("Geometry", [100, "Geometry::mesh\x00\x01", "Mesh"], [
        ("Vertices", [prim.positions.reshape(-1).astype(np.float64)], []),
        ("PolygonVertexIndex", [pvi.reshape(-1)], []),
    ] + layers)
    model = ("Model", [200, "Model::mesh\x00\x01", "Mesh"], [])
    material = ("Material", [300, "Material::mesh\x00\x01", ""], [
        ("Properties70", [], [
            ("P", ["DiffuseColor", "Color", "", "A"] + [float(c) for c in color], []),
        ]),
    ])
    connections = [("C", ["OO", a, b], []) for a, b in ((100, 200), (300, 200), (200, 0))]
    return [("Objects", [], [geometry, model, material]), ("Connections", [], connections)]


def _fbx_binary_node(node, base: int, wide: bool, compress: bool) -> bytes:
    name, props, children = node
    name = name.encode()
    pb = b"".join(_fbx_array(p, compress) if isinstance(p, np.ndarray) else _fbx_prop(p)
                  for p in props)
    hdr = (25 if wide else 13) + len(name)
    kids = b""
    if children:
        pos = base + hdr + len(pb)
        for c in children:
            s = _fbx_binary_node(c, pos, wide, compress)
            kids += s
            pos += len(s)
        kids += b"\0" * (25 if wide else 13)
    end = base + hdr + len(pb) + len(kids)
    head = (struct.pack("<QQQB", end, len(props), len(pb), len(name)) if wide
            else struct.pack("<IIIB", end, len(props), len(pb), len(name)))
    return head + name + pb + kids


def write_fbx_binary(path: str, prim: GltfPrimitive, color=(0.8, 0.8, 0.8),
                     version: int = 7400, compress: bool = False) -> None:
    """Binary FBX: 32-bit record offsets before version 7500, 64-bit from
    it; ``compress`` deflates the array properties."""
    wide = version >= 7500
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", version)
    for node in _fbx_tree(prim, color):
        out += _fbx_binary_node(node, len(out), wide, compress)
    atomic_write(path, out + b"\0" * (25 if wide else 13))


def _fbx_ascii_node(node, indent: str) -> str:
    name, props, children = node
    vals = []
    for p in props:
        if isinstance(p, np.ndarray):
            body = _floats(p) if p.dtype.kind == "f" else " ".join(str(int(v)) for v in p)
            vals.append(f"*{p.size} {{\n{indent}    a: {body.replace(' ', ',')}\n{indent}}}")
        elif isinstance(p, str):
            vals.append('"' + p.replace("\x00\x01", "") + '"')
        elif isinstance(p, float):
            vals.append(repr(p))
        else:
            vals.append(str(p))
    line = f"{indent}{name}: {', '.join(vals)}"
    if children:
        inner = "".join(_fbx_ascii_node(c, indent + "    ") for c in children)
        return f"{line} {{\n{inner}{indent}}}\n"
    return line + "\n"


def write_fbx_ascii(path: str, prim: GltfPrimitive, color=(0.8, 0.8, 0.8)) -> None:
    text = "; FBX 7.4.0 project file\nFBXHeaderExtension:  {\n    FBXVersion: 7400\n}\n"
    text += "".join(_fbx_ascii_node(n, "") for n in _fbx_tree(prim, color))
    atomic_write(path, text)


# ---------------------------------------------------------------------------
# 3DS and DirectX .x
# ---------------------------------------------------------------------------


def _chunk3ds(cid: int, payload: bytes) -> bytes:
    return struct.pack("<HI", cid, 6 + len(payload)) + payload


def write_3ds(path: str, prim: GltfPrimitive, name: str = "mesh", color=(204, 204, 204)) -> None:
    """MAIN > EDITOR > [MATERIAL ``name`` (8-bit diffuse), OBJECT ``name`` >
    TRIMESH (vertices, uvs, faces with one material group of every face)]."""
    nv, nf = prim.positions.shape[0], prim.indices.shape[0]
    cname = name.encode() + b"\0"
    mat = _chunk3ds(0xAFFF, _chunk3ds(0xA000, cname)
                    + _chunk3ds(0xA020, _chunk3ds(0x0011, bytes(color))))
    faces = np.concatenate([prim.indices.astype(np.uint16),
                            np.zeros((nf, 1), np.uint16)], axis=1)
    group = _chunk3ds(0x4130, cname + struct.pack("<H", nf) + np.arange(nf, dtype="<u2").tobytes())
    trimesh = _chunk3ds(0x4110, struct.pack("<H", nv) + prim.positions.astype("<f4").tobytes())
    if prim.texcoords is not None:
        trimesh += _chunk3ds(0x4140, struct.pack("<H", nv) + prim.texcoords.astype("<f4").tobytes())
    trimesh += _chunk3ds(0x4120, struct.pack("<H", nf) + faces.astype("<u2").tobytes() + group)
    obj = _chunk3ds(0x4000, cname + _chunk3ds(0x4100, trimesh))
    atomic_write(path, _chunk3ds(0x4D4D, _chunk3ds(0x3D3D, mat + obj)))


def write_x(path: str, prim: GltfPrimitive, name: str = "mesh", color=(0.8, 0.8, 0.8)) -> None:
    """Text ``.x``: a Mesh with its normals and uvs (per vertex) and a
    material list of one inline Material on every face."""
    def rows(a, k):
        lines = [";".join(f"{float(v):.9g}" for v in r) + ";" for r in np.asarray(a).reshape(-1, k)]
        return ",\n".join(lines) + ";\n"

    faces = prim.indices.astype(np.int64)
    face_text = ",\n".join(f"3;{a},{b},{c};" for a, b, c in faces) + ";\n"
    nv, nf = prim.positions.shape[0], faces.shape[0]
    text = f"xof 0303txt 0032\n// written by stillleben_tpu_torch.assets.writers\nMesh {name} {{\n"
    text += f"{nv};\n" + rows(prim.positions, 3) + f"{nf};\n" + face_text
    if prim.normals is not None:
        text += f"MeshNormals {{\n{nv};\n" + rows(prim.normals, 3) + f"{nf};\n" + face_text + "}\n"
    if prim.texcoords is not None:
        text += f"MeshTextureCoords {{\n{nv};\n" + rows(prim.texcoords, 2) + "}\n"
    text += (f"MeshMaterialList {{\n1;\n{nf};\n" + ",\n".join("0" for _ in range(nf)) + ";;\n"
             + "Material mat {\n" + ";".join(f"{c:.9g}" for c in color) + ";1.0;;\n"
             + "5.0;\n0.0;0.0;0.0;;\n0.0;0.0;0.0;;\n}\n}\n")
    atomic_write(path, text + "}\n")


# ---------------------------------------------------------------------------
# COLLADA, STL, OFF
# ---------------------------------------------------------------------------


def write_dae(path: str, prim: GltfPrimitive, image_file: str | None = None,
              color=(0.8, 0.8, 0.8, 1.0)) -> None:
    """COLLADA 1.4: one geometry of single-index triangles (positions,
    normals, uvs with v up), an effect with the diffuse colour or, with
    ``image_file``, a texture through sampler -> surface -> image, and a
    visual scene node with an identity matrix."""
    faces = prim.indices.astype(np.int64)
    inputs, sources = ['<input semantic="VERTEX" source="#mesh-vertices" offset="0"/>'], []

    def source(sid, arr, k):
        return (f'<source id="{sid}"><float_array id="{sid}-array" count="{arr.size}">'
                f'{_floats(arr)}</float_array><technique_common><accessor source="#{sid}-array" '
                f'count="{arr.shape[0]}" stride="{k}"/></technique_common></source>')

    sources.append(source("mesh-positions", prim.positions, 3))
    if prim.normals is not None:
        sources.append(source("mesh-normals", prim.normals, 3))
        inputs.append('<input semantic="NORMAL" source="#mesh-normals" offset="1"/>')
    if prim.texcoords is not None:
        uv = np.stack([prim.texcoords[:, 0], 1.0 - prim.texcoords[:, 1]], 1)
        sources.append(source("mesh-uvs", uv, 2))
        inputs.append(f'<input semantic="TEXCOORD" source="#mesh-uvs" offset="{len(inputs)}" set="0"/>')
    p = " ".join(str(int(i)) for i in np.repeat(faces.reshape(-1), len(inputs)))
    if image_file is not None:
        images = f'<library_images><image id="tex"><init_from>{image_file}</init_from></image></library_images>'
        diffuse = ('<newparam sid="tex-surface"><surface type="2D"><init_from>tex</init_from></surface>'
                   '</newparam><newparam sid="tex-sampler"><sampler2D><source>tex-surface</source>'
                   '</sampler2D></newparam><technique sid="common"><lambert><diffuse>'
                   '<texture texture="tex-sampler" texcoord="UVMap"/></diffuse></lambert></technique>')
    else:
        images = ""
        diffuse = (f'<technique sid="common"><lambert><diffuse><color>{_floats(color)}</color>'
                   '</diffuse></lambert></technique>')
    text = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
{images}
<library_effects><effect id="mat-effect"><profile_COMMON>{diffuse}</profile_COMMON></effect></library_effects>
<library_materials><material id="mat" name="mat"><instance_effect url="#mat-effect"/></material></library_materials>
<library_geometries><geometry id="mesh" name="mesh"><mesh>
{''.join(sources)}
<vertices id="mesh-vertices"><input semantic="POSITION" source="#mesh-positions"/></vertices>
<triangles material="mat" count="{faces.shape[0]}">{''.join(inputs)}<p>{p}</p></triangles>
</mesh></geometry></library_geometries>
<library_visual_scenes><visual_scene id="scene"><node id="node" name="mesh">
<matrix sid="transform">1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</matrix>
<instance_geometry url="#mesh"/></node></visual_scene></library_visual_scenes>
<scene><instance_visual_scene url="#scene"/></scene>
</COLLADA>
"""
    atomic_write(path, text)


def write_stl(path: str, prim: GltfPrimitive, ascii: bool = False) -> None:
    """Independent triangles with their face normals."""
    tri = prim.positions[prim.indices.astype(np.int64)].astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    if ascii:
        out = ["solid mesh"]
        for t, nn in zip(tri, n):
            out.append(f" facet normal {_floats(nn)}\n  outer loop")
            out += [f"   vertex {_floats(v)}" for v in t]
            out.append("  endloop\n endfacet")
        atomic_write(path, "\n".join(out) + "\nendsolid mesh\n")
        return
    rec = np.zeros(len(tri), np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")]))
    rec["n"], rec["v"] = n, tri
    head = b"binary STL".ljust(80, b" ")
    atomic_write(path, head + struct.pack("<I", len(tri)) + rec.tobytes())


def write_off(path: str, prim: GltfPrimitive) -> None:
    faces = prim.indices.astype(np.int64)
    lines = ["OFF", f"{prim.positions.shape[0]} {faces.shape[0]} 0"]
    lines += [_floats(v) for v in prim.positions]
    lines += [f"3 {a} {b} {c}" for a, b, c in faces]
    atomic_write(path, "\n".join(lines) + "\n")
