"""The port's public API: the verify flow (``sl.init`` -> ``Mesh`` ->
``Scene`` -> ``simulate_tabletop_scene`` -> ``RenderPass().render``) on
the CPU, the lazy name table, the device rule (``init()`` raises without a
GPU unless asked for the CPU, and so do the scene's physics and the render
pass), the NaN/Inf audit of ``SL_SANITIZE``, the mesh's vertex edits and
cache against the JAX package's (1e-6), and a fresh interpreter that
refuses jax and the JAX package and runs every new module of the API."""

import importlib
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
from stillleben_tpu_torch.assets.procedural import write_meshes
from stillleben_tpu_torch.utils import sanitize
from torch_port_scene import build_meshes

PORTED = sorted(sl._LAZY)
context_mod = importlib.import_module("stillleben_tpu_torch.context")


@pytest.fixture(autouse=True)
def cpu_context():
    sl.init(device="cpu")
    yield
    sl.init(device="cpu")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    return write_meshes(str(d), subdiv=2), str(d)


def test_verify_flow_on_cpu(paths, monkeypatch):
    """The README's first example on an in-repo fixture, at 64x48."""
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", paths[1] + "/mesh_cache")
    mesh = sl.Mesh(paths[0]["cube"])
    mesh.scale_to_bbox_diagonal(0.25)
    scene = sl.Scene((64, 48))
    scene.seed(3)
    scene.add_object(sl.Object(mesh))
    scene.simulate_tabletop_scene()
    z = scene.objects[0].pose()[2, 3]
    assert 0.04 < z < 0.2, z  # resting on the tabletop
    result = sl.RenderPass().render(scene)
    rgb = result.rgb()
    assert rgb.shape == (48, 64, 4) and rgb.dtype == torch.uint8
    inst = result.instance_index().to(torch.int32)
    assert (inst == 1).sum() > 20, "the cube covers no pixels"
    assert torch.isfinite(result.coordDepth()).all() and torch.isfinite(result.normals()).all()


@pytest.mark.parametrize("name", PORTED)
def test_lazy_table_resolves(name):
    assert getattr(sl, name) is not None and name in dir(sl)


def _kind(value) -> str:
    if inspect.ismodule(value):
        return "module"
    if inspect.isclass(value):
        return "class"
    return "function" if callable(value) else type(value).__name__


@pytest.mark.parametrize("name", sorted(jsl._LAZY))
def test_name_is_the_jax_kind(name):
    """Each name of the JAX package's table is the same kind of object in
    the port: a class, a function or a module. The JAX side is read from
    its table's target (importing its submodule ``context`` rebinds the
    package's attribute ``context`` to that module)."""
    mod_name, attr = jsl._LAZY[name]
    module = importlib.import_module(mod_name, "stillleben_tpu")
    target = module if attr is None else getattr(module, attr)
    assert _kind(getattr(sl, name)) == _kind(target)


def test_lazy_table_is_the_jax_table():
    assert set(sl._LAZY) == set(jsl._LAZY) and sl.NOT_PORTED == ()
    with pytest.raises(AttributeError, match="no attribute"):
        sl.no_such_name  # noqa: B018


def test_device_is_never_hidden(paths, monkeypatch):
    """Without a CUDA device ``init()``, ``init_cuda()``, a scene's physics
    and a render pass raise; with ``device="cpu"`` they run there."""
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", paths[1] + "/mesh_cache")
    if torch.cuda.is_available():
        assert sl.init().device.type == "cuda"
        return
    scene = sl.Scene((32, 24))
    mesh = sl.Mesh(paths[0]["sphere"])
    mesh.scale_to_bbox_diagonal(0.2)
    scene.add_object(sl.Object(mesh))
    context_mod._reset_context_for_tests()
    for call in (sl.init, sl.init_cuda, lambda: sl.init("cuda"), lambda: scene.simulate(0.01),
                 scene.check_collisions, lambda: sl.RenderPass().render(scene)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert context_mod._context is None
    assert sl.init(device="cpu").device == torch.device("cpu")
    assert sl.context().platform == "cpu" and scene.device.type == "cpu"
    scene.simulate(0.01)
    assert scene._compiled[0].verts.device.type == "cpu"


def test_sanitize_reports_non_finite(paths, monkeypatch):
    """``check_finite`` names each offending tensor with its counts;
    ``SL_SANITIZE=1`` makes the render pass and the settle audit theirs."""
    from stillleben_tpu_torch.physics.types import make_empty_state

    state = make_empty_state(2, device="cpu")
    state.pos[0, 1, 2] = float("nan")
    state.lin_vel[0, 0, 0] = float("inf")
    with pytest.raises(sanitize.NonFiniteError) as err:
        sanitize.check_finite(state, "state")
    assert err.value.bad == [(".pos", 1, 0), (".lin_vel", 0, 1)]
    assert sanitize.check_finite({"a": [torch.ones(2)]}, raise_=False) == []

    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", paths[1] + "/mesh_cache")
    monkeypatch.setenv("SL_SANITIZE", "1")
    audited = []
    monkeypatch.setattr(sanitize, "check_finite", lambda tree, name: audited.append(name))
    mesh = sl.Mesh(paths[0]["cube"])
    mesh.scale_to_bbox_diagonal(0.25)
    scene = sl.Scene((32, 24))
    scene.add_object(sl.Object(mesh))
    with monkeypatch.context() as mp:  # the settle's audit, on a short settle
        from stillleben_tpu_torch.physics import tabletop as tt

        mp.setattr(tt, "MAX_ITERATIONS", 1)
        scene.simulate_tabletop_scene(vis_cb=lambda i: None)
    sl.RenderPass(ssao=False).render(scene)
    assert audited == ["simulate_tabletop_scene state", "RenderPass output"]


def test_mesh_edits_and_cache_match_jax(tmp_path):
    """1-based vertex edits, colours and the recomputed normals and bbox as
    in the JAX package (1e-6); each edit bumps ``_dirty``; ``MeshCache``
    loads a file once."""
    jm, _, _ = build_meshes(str(tmp_path), subdiv=2, native_decomp=False)
    pm, _, _ = build_meshes(str(tmp_path), subdiv=2, port=True, native_decomp=False)
    rng = np.random.default_rng(1)
    idx = np.array([1, 3, 5, 8])
    pos = rng.normal(size=(4, 3)).astype(np.float32)
    col = rng.random((4, 3)).astype(np.float32)
    dirty = pm._dirty
    for mesh in (jm, pm):
        mesh.update_positions_and_colors(idx, pos, col)
        mesh.set_new_colors(mesh.consolidated.colors[:, :3] * 0.5)
    assert pm._dirty > dirty
    for name in ("positions", "normals", "colors"):
        np.testing.assert_allclose(getattr(pm.consolidated, name), getattr(jm.consolidated, name),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pm.bbox.min, jm.bbox.min, atol=1e-6)
    with pytest.raises(IndexError):
        pm.update_positions([0], pos[:1])
    with pytest.raises(ValueError):
        pm.set_new_positions(pos)
    from stillleben_tpu_torch.assets.mesh import MeshCache

    cache = MeshCache()
    group = pm.serialize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "mesh_cache"))
        a = cache.load(group)
        b = cache.load(group)
    assert a is b and cache.get(pm.filename) is a
    np.testing.assert_allclose(a.pretransform, pm.pretransform, atol=1e-7)


SCRIPT = textwrap.dedent(
    """
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "stillleben_tpu", "PIL", "cv2")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import write_meshes
    from stillleben_tpu_torch.core import quat
    from stillleben_tpu_torch.physics import engine, tabletop
    from stillleben_tpu_torch.render import camera
    from stillleben_tpu_torch.render.frame import render_frame
    from stillleben_tpu_torch.scene import pose
    from stillleben_tpu_torch.utils import corrade_config, sanitize

    sl.init(device="cpu")
    paths = write_meshes(sys.argv[1], subdiv=1)
    scene = sl.Scene((32, 24))
    scene.seed(0)
    for name in ("cube", "sphere"):
        mesh = sl.Mesh(paths[name])
        mesh.scale_to_bbox_diagonal(0.2)
        obj = sl.Object(mesh)
        obj.set_pose(scene.place_object_randomly(0.2))
        scene.add_object(obj)
    scene.find_noncolliding_pose(scene.objects[1], "viewpoint", viewpoint=[0, 0, 1])
    scene.simulate(0.002)
    assert len(scene.check_collisions()) == 2
    text = scene.serialize()
    again = sl.Scene((8, 8))
    again.deserialize(text)
    assert again.serialize() == text
    result = sl.RenderPass(ssao=False).render(scene, predicate=lambda o: True)
    assert result.rgb().shape == (24, 32, 4)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK")
    """
)


def test_api_runs_without_jax(tmp_path):
    env = dict(os.environ, STILLLEBEN_TPU_MESH_CACHE=str(tmp_path / "mesh_cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
