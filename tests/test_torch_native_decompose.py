"""The port's native convex cooker (its own build of
``csrc/sl_decompose.cpp``) against the JAX package's (``native/``).

- With the default switch both packages cook natively, and the hulls are
  exactly equal: vertices, planes, volume, centre of mass, inertia (the
  cube, the blob, the cutout cube, and two separate boxes in one mesh,
  which cook to more than one hull).
- ``STILLLEBEN_TPU_NATIVE_DECOMP=0`` cooks with the Python path in both,
  equal within ``test_torch_assets.py``'s 1e-6.
- A compiler that fails raises with its message; nothing is cooked.
- The hull cache keys each cooker apart.
"""

import os
import stat

import numpy as np
import pytest

from stillleben_tpu.assets.mesh import Mesh as JaxMesh
from stillleben_tpu_torch.assets import convex, native_decompose
from stillleben_tpu_torch.assets.mesh import Mesh
from stillleben_tpu_torch.assets.primitive import cube_arrays
from stillleben_tpu_torch.assets.procedural import _write_obj, write_meshes
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hulls"))
    paths = write_meshes(d, subdiv=3)
    p, n, uv, f = cube_arrays()
    two = np.concatenate([p * 0.3 + [-3.0, 0, 0], p * 0.3 + [3.0, 0, 0]])
    paths["two_boxes"] = os.path.join(d, "two_boxes.obj")
    _write_obj(paths["two_boxes"], two.astype(np.float32), np.concatenate([f, f + len(p)]))
    return paths


def _load(monkeypatch, tmp_path, path, native: bool, port: bool, flags=0):
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1" if native else "0")
    return (Mesh if port else JaxMesh)(path, flags=flags)


def _fields(h):
    return (h.vertices, h.planes, np.float32(h.volume), h.center_of_mass, h.inertia)


@pytest.mark.parametrize("name", ["cube", "blob", "cube_cutout", "two_boxes", "sphere"])
def test_native_hulls_equal_jax(files, monkeypatch, tmp_path, name):
    port = _load(monkeypatch, tmp_path, files[name], True, True)
    ref = _load(monkeypatch, tmp_path, files[name], True, False)
    assert len(port._physics.hulls) == len(ref._physics.hulls)
    if name == "two_boxes":
        assert len(port._physics.hulls) >= 2
    for a, b in zip(port._physics.hulls, ref._physics.hulls):
        for x, y in zip(_fields(a), _fields(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_forced_single_hull_equal_jax(files, monkeypatch, tmp_path):
    flags = Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL
    port = _load(monkeypatch, tmp_path, files["two_boxes"], True, True, flags)
    ref = _load(monkeypatch, tmp_path, files["two_boxes"], True, False, flags)
    assert len(port._physics.hulls) == len(ref._physics.hulls) == 1
    for x, y in zip(_fields(port._physics.hulls[0]), _fields(ref._physics.hulls[0])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["cube", "two_boxes"])
def test_python_path_equal_jax(files, monkeypatch, tmp_path, name):
    port = _load(monkeypatch, tmp_path, files[name], False, True)
    ref = _load(monkeypatch, tmp_path, files[name], False, False)
    assert len(port._physics.hulls) == len(ref._physics.hulls)
    for a, b in zip(port._physics.hulls, ref._physics.hulls):
        for x, y in zip(_fields(a), _fields(b)):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


def test_failed_build_raises(files, monkeypatch, tmp_path):
    """A compiler that fails (here a ``g++`` first on ``PATH`` that prints a
    message and exits 1): cooking raises with that message, and the
    Python path does not stand in."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'broken compiler: cannot compile' >&2\nexit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native_decompose, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_decompose, "_lib", None)
    monkeypatch.setattr(convex, "convex_hull", lambda *a, **k: pytest.fail("Python path ran"))
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "cache"))
    monkeypatch.delenv("STILLLEBEN_TPU_NATIVE_DECOMP", raising=False)
    with pytest.raises(RuntimeError, match="broken compiler: cannot compile"):
        Mesh(files["cube"])
    assert not os.listdir(tmp_path / "build")  # the temporary file is gone
    assert not os.path.exists(tmp_path / "cache")


def test_build_is_cached_by_content(monkeypatch, tmp_path):
    """Two builds into one directory: one library, named by the source's,
    header's and flags' hash; a second build finds it."""
    monkeypatch.setattr(native_decompose, "BUILD_DIR", str(tmp_path))
    first = native_decompose.build()
    assert os.path.dirname(first) == str(tmp_path)
    assert os.path.basename(first).startswith("libsl_decompose_")
    assert native_decompose.build() == first and os.listdir(tmp_path) == [os.path.basename(first)]


def test_cache_keys_the_cooker(files, monkeypatch, tmp_path):
    """A native entry is never served to a Python request, nor the other
    way round: each cooker has its own file and content hash."""
    cache = tmp_path / "cache"
    native = _load(monkeypatch, tmp_path, files["blob"], True, True)
    c = native.consolidated
    assert convex.load_cached_physics(files["blob"], c.positions, c.faces, 0) is not None
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "0")
    assert convex.load_cached_physics(files["blob"], c.positions, c.faces, 0) is None
    python = Mesh(files["blob"])
    entries = sorted(os.listdir(cache))
    assert len(entries) == 2
    assert any(".torch-native." in e for e in entries) and any(".torch-python." in e for e in entries)
    assert convex.load_cached_physics(files["blob"], c.positions, c.faces, 0) is not None
    assert len(python._physics.hulls) >= 1
