"""The in-memory asset document the loaders fill (host-side, numpy).

Copied from ``stillleben_tpu/assets/gltf.py:44-92``: the
``GltfPrimitive`` / ``GltfMaterial`` / ``GltfNode`` / ``GltfDocument``
dataclasses only. The glTF/GLB parser itself is not ported yet; the OBJ
and PLY loaders (``objfile.py``) produce these documents.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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

