"""glTF 2.0 / GLB parser and the in-memory asset document every loader fills
(host-side, numpy).

Copied from ``stillleben_tpu/assets/gltf.py``: the ``GltfPrimitive`` /
``GltfMaterial`` / ``GltfNode`` / ``GltfDocument`` dataclasses and
``load_gltf`` (reference src/mesh.cpp:203-301, CgltfImporter): the node
hierarchy with TRS or matrix transforms, buffers from the GLB BIN chunk,
``data:`` URIs or external files (``%``-escaped names), strided and sparse
accessors, triangle primitives (POSITION / NORMAL / TEXCOORD_0 / COLOR_0 /
TANGENT + indices), materials with their ``has_*_factor`` presence bits,
and the images that materials reference, decoded lazily by the port's
own codec (``image.py``) instead of Pillow.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from dataclasses import dataclass, field
from urllib.parse import unquote

import numpy as np

from .image import decode_image, read_image

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclass
class GltfPrimitive:
    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (F, 3) u32
    normals: np.ndarray | None = None  # (V, 3) f32
    texcoords: np.ndarray | None = None  # (V, 2) f32
    colors: np.ndarray | None = None  # (V, 4) f32
    tangents: np.ndarray | None = None  # (V, 4) f32
    material: int = -1


@dataclass
class GltfMaterial:
    name: str = ""
    base_color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    base_color_texture: int = -1  # index into GltfDocument.images
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1
    # glTF spec: if metallicRoughnessTexture / metallicFactor absent,
    # factors default to 1.0. The reference applies its own defaulting on
    # top (src/shaders/render_shader.cpp:332-418); we record presence bits.
    has_metallic_factor: bool = False
    has_roughness_factor: bool = False


@dataclass
class GltfNode:
    name: str = ""
    transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    mesh: int = -1  # index into meshes
    children: list[int] = field(default_factory=list)


@dataclass
class GltfDocument:
    nodes: list[GltfNode] = field(default_factory=list)
    roots: list[int] = field(default_factory=list)
    meshes: list[list[GltfPrimitive]] = field(default_factory=list)
    materials: list[GltfMaterial] = field(default_factory=list)
    images: list[np.ndarray] = field(default_factory=list)  # (H, W, 4) u8 each
    # texture index -> image index mapping already resolved into materials


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        # glTF matrices are column-major
        return np.array(node["matrix"], dtype=np.float32).reshape(4, 4).T
    T = np.eye(4, dtype=np.float32)
    if "translation" in node:
        T[:3, 3] = node["translation"]
    R = np.eye(4, dtype=np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]  # glTF stores xyzw
        R[:3, :3] = _quat_to_mat(w, x, y, z)
    S = np.eye(4, dtype=np.float32)
    if "scale" in node:
        S[0, 0], S[1, 1], S[2, 2] = node["scale"]
    return T @ R @ S


def _quat_to_mat(w, x, y, z) -> np.ndarray:
    n = (w * w + x * x + y * y + z * z) ** 0.5
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


class _BufferStore:
    def __init__(self, gltf: dict, base_dir: str, glb_bin: bytes | None):
        self.gltf = gltf
        self.base_dir = base_dir
        self.glb_bin = glb_bin
        self._buffers: dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i in self._buffers:
            return self._buffers[i]
        spec = self.gltf["buffers"][i]
        uri = spec.get("uri")
        if uri is None:
            data = self.glb_bin
            if data is None:
                raise ValueError("glTF buffer without URI and no GLB BIN chunk")
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def buffer_view(self, i: int) -> tuple[bytes, int]:
        bv = self.gltf["bufferViews"][i]
        data = self.buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        return data[off : off + bv["byteLength"]], bv.get("byteStride", 0)

    def accessor(self, i: int) -> np.ndarray:
        acc = self.gltf["accessors"][i]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype=dtype)
        else:
            raw, stride = self.buffer_view(acc["bufferView"])
            off = acc.get("byteOffset", 0)
            natural = ncomp * itemsize
            if stride in (0, natural):
                out = np.frombuffer(raw, dtype=dtype, count=count * ncomp, offset=off)
                out = out.reshape(count, ncomp).copy()
            else:
                # strided: gather rows
                out = np.zeros((count, ncomp), dtype=dtype)
                arr = np.frombuffer(raw, dtype=np.uint8)
                for c in range(count):
                    start = off + c * stride
                    out[c] = np.frombuffer(arr[start : start + natural].tobytes(), dtype=dtype)
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        # sparse accessor support
        sp = acc.get("sparse")
        if sp:
            idx_acc = sp["indices"]
            idx_raw, _ = self.buffer_view(idx_acc["bufferView"])
            idx_dtype = _COMPONENT_DTYPES[idx_acc["componentType"]]
            idx = np.frombuffer(
                idx_raw, dtype=idx_dtype, count=sp["count"], offset=idx_acc.get("byteOffset", 0)
            )
            val_acc = sp["values"]
            val_raw, _ = self.buffer_view(val_acc["bufferView"])
            vals = np.frombuffer(
                val_raw,
                dtype=dtype,
                count=sp["count"] * ncomp,
                offset=val_acc.get("byteOffset", 0),
            ).reshape(sp["count"], ncomp)
            out[idx] = vals
        if ncomp == 1:
            out = out[:, 0]
        return out

    def image(self, i: int) -> np.ndarray:
        img_spec = self.gltf["images"][i]
        if "bufferView" in img_spec:
            raw, _ = self.buffer_view(img_spec["bufferView"])
            return decode_image(bytes(raw), f"glTF image {i}")
        uri = img_spec["uri"]
        if uri.startswith("data:"):
            return decode_image(base64.b64decode(uri.split(",", 1)[1]), f"glTF image {i}")
        return read_image(os.path.join(self.base_dir, unquote(uri)))


def load_gltf(path: str) -> GltfDocument:
    """Load a .gltf or .glb file into a GltfDocument."""
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":
            data = f.read()
            magic, version, length = struct.unpack_from("<III", data, 0)
            offset = 12
            gltf_json = None
            while offset < length:
                clen, ctype = struct.unpack_from("<II", data, offset)
                chunk = data[offset + 8 : offset + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    gltf_json = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = chunk
                offset += 8 + clen
            gltf = gltf_json
        else:
            gltf = json.load(io.TextIOWrapper(f, encoding="utf-8"))

    store = _BufferStore(gltf, base_dir, glb_bin)
    doc = GltfDocument()

    # images (decode lazily only those referenced by textures/materials)
    tex_to_img: dict[int, int] = {}
    for ti, tex in enumerate(gltf.get("textures", [])):
        if "source" in tex:
            tex_to_img[ti] = tex["source"]

    used_images: dict[int, int] = {}

    def _resolve_tex(tex_info) -> int:
        if not tex_info:
            return -1
        ti = tex_info.get("index", -1)
        if ti < 0 or ti not in tex_to_img:
            return -1
        src = tex_to_img[ti]
        if src not in used_images:
            used_images[src] = len(doc.images)
            doc.images.append(store.image(src))
        return used_images[src]

    for mspec in gltf.get("materials", []):
        m = GltfMaterial(name=mspec.get("name", ""))
        pbr = mspec.get("pbrMetallicRoughness", {})
        if "baseColorFactor" in pbr:
            m.base_color = np.array(pbr["baseColorFactor"], dtype=np.float32)
        m.has_metallic_factor = "metallicFactor" in pbr
        m.has_roughness_factor = "roughnessFactor" in pbr
        m.metallic = float(pbr.get("metallicFactor", 1.0))
        m.roughness = float(pbr.get("roughnessFactor", 1.0))
        m.base_color_texture = _resolve_tex(pbr.get("baseColorTexture"))
        m.metallic_roughness_texture = _resolve_tex(pbr.get("metallicRoughnessTexture"))
        m.normal_texture = _resolve_tex(mspec.get("normalTexture"))
        m.emissive_texture = _resolve_tex(mspec.get("emissiveTexture"))
        if "emissiveFactor" in mspec:
            m.emissive = np.array(mspec["emissiveFactor"], dtype=np.float32)
        m.alpha_mode = mspec.get("alphaMode", "OPAQUE")
        m.alpha_cutoff = float(mspec.get("alphaCutoff", 0.5))
        m.double_sided = bool(mspec.get("doubleSided", False))
        doc.materials.append(m)

    for mesh_spec in gltf.get("meshes", []):
        prims = []
        for p in mesh_spec.get("primitives", []):
            if p.get("mode", 4) != 4:  # triangles only
                continue
            attrs = p["attributes"]
            positions = store.accessor(attrs["POSITION"]).astype(np.float32)
            nv = positions.shape[0]
            if "indices" in p:
                idx = store.accessor(p["indices"]).astype(np.uint32)
            else:
                idx = np.arange(nv, dtype=np.uint32)
            idx = idx.reshape(-1, 3)
            prim = GltfPrimitive(positions=positions, indices=idx, material=p.get("material", -1))
            if "NORMAL" in attrs:
                prim.normals = store.accessor(attrs["NORMAL"]).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                prim.texcoords = store.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            if "TANGENT" in attrs:
                prim.tangents = store.accessor(attrs["TANGENT"]).astype(np.float32)
            if "COLOR_0" in attrs:
                col = store.accessor(attrs["COLOR_0"]).astype(np.float32)
                if col.ndim == 2 and col.shape[1] == 3:
                    col = np.concatenate([col, np.ones((nv, 1), np.float32)], axis=1)
                prim.colors = col
            prims.append(prim)
        doc.meshes.append(prims)

    child_set = set()
    for nspec in gltf.get("nodes", []):
        node = GltfNode(
            name=nspec.get("name", ""),
            transform=_node_transform(nspec),
            mesh=nspec.get("mesh", -1),
            children=list(nspec.get("children", [])),
        )
        doc.nodes.append(node)
        child_set.update(node.children)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [])
    if scenes:
        doc.roots = list(scenes[scene_idx].get("nodes", []))
    else:
        doc.roots = [i for i in range(len(doc.nodes)) if i not in child_set]

    return doc
