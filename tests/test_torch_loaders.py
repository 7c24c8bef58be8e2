"""The port's mesh loaders against the JAX package's, on the same files.

Every fixture comes from ``procedural.write_loader_fixtures`` (the textured
blob as GLB and as ``.gltf`` with an external buffer, a small glTF with a
``data:`` URI, a strided view, a sparse accessor and node transforms, the
cube as binary 7.4 / 7.5 and ASCII FBX, 3DS and ``.x``, the sphere as DAE,
binary and ASCII STL and OFF) or from ``primitive://``. Each file goes
through the JAX loader and the port's: the documents are equal field for
field (arrays ``np.array_equal`` with their dtypes, matrices exact) and so
are the consolidated meshes. The two faults of the JAX package's
``legacy_formats.py`` (ROADMAP C-2) that the port fixes are held to the
reference's (Assimp's) semantics instead.
"""

import dataclasses
import os
import struct

import numpy as np
import pytest

from stillleben_tpu.assets import consolidate as jax_consolidate
from stillleben_tpu.assets import mesh as jax_mesh
from stillleben_tpu.assets.fbxfile import load_fbx as jax_fbx
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.legacy_formats import load_3ds as jax_3ds
from stillleben_tpu.assets.legacy_formats import load_x as jax_x
from stillleben_tpu.assets.objfile import load_dae as jax_dae
from stillleben_tpu.assets.objfile import load_off as jax_off
from stillleben_tpu.assets.objfile import load_stl as jax_stl
from stillleben_tpu.assets.primitive import load_primitive as jax_primitive
from stillleben_tpu_torch.assets.consolidate import consolidate
from stillleben_tpu_torch.assets.legacy_formats import load_3ds, load_x
from stillleben_tpu_torch.assets.mesh import LOADERS, Mesh
from stillleben_tpu_torch.assets.primitive import load_primitive
from stillleben_tpu_torch.assets.procedural import write_loader_fixtures, write_meshes
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

JAX_LOADERS = {
    "glb": jax_gltf, "gltf": jax_gltf, "features_gltf": jax_gltf, "fbx": jax_fbx,
    "fbx_7500": jax_fbx, "fbx_ascii": jax_fbx, "3ds": jax_3ds, "x": jax_x, "dae": jax_dae,
    "stl": jax_stl, "stl_ascii": jax_stl, "off": jax_off,
}
# the procedural OBJ each fixture was written from
SOURCE = {"glb": "blob_textured", "gltf": "blob_textured", "fbx": "cube", "fbx_7500": "cube",
          "fbx_ascii": "cube", "3ds": "cube", "x": "cube", "dae": "sphere", "stl": "sphere",
          "stl_ascii": "sphere", "off": "sphere"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("loaders"))
    paths = write_loader_fixtures(d, subdiv=3)
    paths["objs"] = write_meshes(d, subdiv=3)
    return paths


def assert_same(a, b, path="doc"):
    """Field for field: dataclasses recursively, arrays with their dtype
    and shape, every other value with its type."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _port_loader(path):
    return LOADERS[os.path.splitext(path)[1].lower()]


@pytest.mark.parametrize("name", sorted(JAX_LOADERS))
def test_document_matches_jax(files, name):
    port, ref = _port_loader(files[name])(files[name]), JAX_LOADERS[name](files[name])
    assert_same(port, ref)
    assert_same(consolidate(port, name), jax_consolidate.consolidate(ref, name), "consolidated")


@pytest.mark.parametrize("name", sorted(SOURCE))
def test_same_geometry_as_the_obj(files, name):
    """Each format holds the procedural mesh it was written from: the
    triangles' corner positions equal the OBJ's, exactly, but for STL,
    whose loader welds vertices rounded to 6 decimals (JAX objfile.py:296)."""
    got = consolidate(_port_loader(files[name])(files[name]))
    ref = consolidate(LOADERS[".obj"](files["objs"][SOURCE[name]]))
    a = got.positions[got.faces.astype(np.int64)]
    b = ref.positions[ref.faces.astype(np.int64)]
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-7 if name.startswith("stl") else 0)


def test_gltf_features(files):
    """The small glTF: the sparse accessor moved vertex 2, the line
    primitive is skipped, the root (no ``scenes``) is the node no other
    lists, the material's factors and presence bits, and the palette PNG
    with tRNS decoded from its ``data:`` URI."""
    doc = LOADERS[".gltf"](files["features_gltf"])
    (prim,) = doc.meshes[0]
    np.testing.assert_array_equal(prim.positions[2], [1.5, 1.25, 0.5])
    np.testing.assert_array_equal(prim.normals, np.tile([[0, 0, 1]], (4, 1)))
    np.testing.assert_allclose(prim.colors[1], [0, 1, 0, 128 / 255], rtol=1e-7)
    assert doc.roots == [0] and doc.nodes[0].children == [1] and doc.nodes[1].mesh == 0
    m = doc.materials[0]
    assert (m.alpha_mode, m.alpha_cutoff, m.double_sided) == ("MASK", 0.3, True)
    assert not m.has_metallic_factor and m.has_roughness_factor and m.roughness == 0.25
    assert doc.images[0].shape == (8, 8, 4) and set(np.unique(doc.images[0][..., 3])) <= {0, 128, 255}
    c = consolidate(doc)
    # the child's matrix turns y into z; the root scales by 2, turns 45
    # degrees about z and moves; vertex 0 is the root's translation
    np.testing.assert_allclose(c.positions[0], [0.5 + 2 * (0.1 * 0.70710678 - 0.2 * 0.70710678),
                                                -0.25 + 2 * (0.1 * 0.70710678 + 0.2 * 0.70710678),
                                                1.0 + 2 * 0.3], atol=1e-6)


@pytest.mark.parametrize("name", ["cube", "sphere", "plane"])
def test_primitive_matches_jax(name):
    port, ref = load_primitive(f"primitive://{name}"), jax_primitive(f"primitive://{name}")
    assert_same(port, ref)
    assert_same(consolidate(port), jax_consolidate.consolidate(ref), "consolidated")


def test_unknown_primitive_and_extension(tmp_path):
    with pytest.raises(ValueError, match="Unknown primitive 'cone'"):
        Mesh("primitive://cone")
    path = tmp_path / "mesh.abc"
    path.write_text("?")
    with pytest.raises(ValueError) as port_err:
        Mesh(str(path))
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.Mesh(str(path))
    assert str(port_err.value) == str(jax_err.value)
    for ext in (".gltf", ".glb", ".obj", ".ply", ".stl", ".off", ".dae", ".fbx", ".3ds", ".x",
                "primitive://"):
        assert ext in str(port_err.value)


def _hulls(mesh):
    return [(h.vertices, h.planes, np.float32(h.volume), h.center_of_mass, h.inertia)
            for h in mesh._physics.hulls]


def test_load_threaded_matches_sequential_and_jax(files, tmp_path, monkeypatch):
    """``Mesh.load_threaded`` over a mixed list, physics on with the native
    cooker in both packages: the same meshes, in order, as one ``Mesh``
    at a time and as the JAX package's ``load_threaded``."""
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")
    names = [files[k] for k in ("glb", "fbx", "dae", "stl", "off", "3ds", "x", "fbx_ascii")]
    names += ["primitive://cube", "primitive://sphere"]
    threaded = Mesh.load_threaded(names, max_workers=4)
    one_by_one = [Mesh(n) for n in names]
    ref = jax_mesh.Mesh.load_threaded(names, max_workers=4)
    for n, a, b, c in zip(names, threaded, one_by_one, ref):
        assert a.filename == n
        for other in (b, c):
            assert_same(a.consolidated.positions, other.consolidated.positions, n)
            assert_same(a.consolidated.faces, other.consolidated.faces, n)
            for ha, hb in zip(_hulls(a), _hulls(other), strict=True):
                for x, y in zip(ha, hb):
                    np.testing.assert_array_equal(x, y, err_msg=n)
    # one native entry of the port's per file, none for a primitive
    entries = [f for f in os.listdir(tmp_path / "cache") if ".torch-native." in f]
    assert len(entries) == len(names) - 2


def test_physics_data_and_dump_match_jax(files, tmp_path, monkeypatch):
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")
    port, ref = Mesh(files["dae"]), jax_mesh.Mesh(files["dae"])
    a, b = port.physics_mesh_data, ref.physics_mesh_data
    assert sorted(a) == sorted(b)
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], list) else [a[k]],
                        b[k] if isinstance(b[k], list) else [b[k]], strict=True):
            assert_same(x, y, k)
    port.dump_physics_meshes(str(tmp_path / "port_"))
    ref.dump_physics_meshes(str(tmp_path / "jax_"))
    dumped = sorted(f for f in os.listdir(tmp_path) if f.startswith("port_"))
    assert dumped == [f"port_{i:03d}.obj" for i in range(len(a["vertices"]))]
    for f in dumped:
        assert (tmp_path / f).read_text() == (tmp_path / f.replace("port_", "jax_")).read_text()
    assert port.num_sub_meshes == ref.num_sub_meshes
    for sub in (-1, 0):
        for acc in ("points", "normals", "colors", "faces"):
            assert_same(getattr(port, acc)(sub), getattr(ref, acc)(sub), acc)


# --- ROADMAP C-2: the two faults the port fixes --------------------------------


def _chunk(cid, payload):
    return struct.pack("<HI", cid, 6 + len(payload)) + payload


def test_3ds_unnamed_materials_stay_distinct(tmp_path):
    """Two materials without a name chunk and one named "red". Assimp's 3DS
    importer names an unnamed material ``UNNAMED_<index>``, so each stays
    its own material and a face group can name it; the JAX package keys
    both by "" and the last wins."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2, 0], [0, 2, 3, 0], [1, 2, 3, 0]], np.uint16)
    groups = b"".join(_chunk(0x4130, name + struct.pack("<HH", 1, i))
                      for i, name in enumerate((b"UNNAMED_0\0", b"red\0", b"UNNAMED_1\0")))
    trimesh = (_chunk(0x4110, struct.pack("<H", 4) + verts.tobytes())
               + _chunk(0x4120, struct.pack("<H", 3) + faces.tobytes() + groups))
    obj = _chunk(0x4000, b"quad\0" + _chunk(0x4100, trimesh))

    def material(name, rgb):
        return _chunk(0xAFFF, (_chunk(0xA000, name) if name else b"")
                      + _chunk(0xA020, _chunk(0x0011, bytes(rgb))))

    mats = material(None, (0, 255, 0)) + material(b"red\0", (255, 0, 0)) + material(None, (0, 0, 255))
    path = tmp_path / "unnamed.3ds"
    path.write_bytes(_chunk(0x4D4D, _chunk(0x3D3D, mats + obj)))

    doc = load_3ds(str(path))
    assert [m.name for m in doc.materials] == ["UNNAMED_0", "red", "UNNAMED_2"]
    assert [tuple(m.base_color[:3]) for m in doc.materials] == [(0, 1, 0), (1, 0, 0), (0, 0, 1)]
    by_face = {tuple(int(i) for i in p.indices[0]): p.material for p in doc.meshes[0]}
    # "UNNAMED_1" names no material here: the third one is "UNNAMED_2"
    assert by_face == {(0, 1, 2): 0, (0, 2, 3): 1, (1, 2, 3): -1}
    ref = jax_3ds(str(path))  # the JAX package: both unnamed materials keyed by ""
    assert [m.name for m in ref.materials] == ["", "red", ""]


_X_REFERENCE = """xof 0303txt 0032
Material red {
 1.0;0.0;0.0;1.0;;
 5.0;
 0.0;0.0;0.0;;
 0.0;0.0;0.0;;
}
Material blue {
 0.0;0.0;1.0;1.0;;
 5.0;
 0.0;0.0;0.0;;
 0.0;0.0;0.0;;
}
Mesh quad {
 4;
 0.0;0.0;0.0;,
 1.0;0.0;0.0;,
 1.0;1.0;0.0;,
 0.0;1.0;0.0;;
 2;
 3;0,1,2;,
 3;0,2,3;;
 MeshMaterialList {
  2;
  2;
  0,
  1;;
  { blue }
  { red }
 }
}
"""


def test_x_material_reference_resolves(tmp_path):
    """The reference form ``{ name }`` in a ``MeshMaterialList`` names a
    top-level ``Material`` (the form most exporters write): list slot 0 is
    blue, slot 1 red. The JAX package takes the reference's ``}`` for the
    list's end and raises ``IndexError``."""
    path = tmp_path / "ref.x"
    path.write_text(_X_REFERENCE)
    doc = load_x(str(path))
    assert len(doc.materials) == 2
    colors = {int(p.indices[0][2]): tuple(doc.materials[p.material].base_color) for p in doc.meshes[0]}
    assert colors == {2: (0, 0, 1, 1), 3: (1, 0, 0, 1)}
    with pytest.raises(IndexError):
        jax_x(str(path))
