"""The port's tools (``stillleben_tpu_torch/tools/``) against the JAX
package's scripts (``tools/``) on the CPU, on the procedural meshes of
``torch_port_scene.build_meshes`` (subdivision 3).

- ``settle_fidelity``: its configurations are the JAX script's; ``stats``
  and the printed lines are the JAX script's arithmetic on the same poses;
  the port's settle of the JAX draws (``jax.random.split(PRNGKey(7), 4)``'s
  stack orientations, fed through the ``quats`` seam as
  ``test_torch_physics.py`` feeds them) is within 1e-5 of the JAX
  package's ``vmap(settle_scene)`` under each of the six configurations
  (6 frames, the bench's ten-object composition from
  ``templates.add_objects``); the statistics follow within 1e-5 and the
  PASS/FAIL words are equal. The command line runs end to end on the CPU.
- ``align_mesh``: the ``.pretransform`` sidecar's bytes equal the JAX
  script's for the same arguments; an ``AlignSession`` key sequence gives
  the JAX session's matrix within 1e-6; its render and web window run.
- ``display_mesh``: the contact sheet is held to the JAX script's (the
  same views and light) by the frame tests' rule (ROADMAP C-5): within 1
  LSB on >= 99% of the pixels, 13 on all.
- ``viewer_demo``: on the same scene, the printed state lines equal the
  JAX script's and each frame is held as ``test_torch_viewer.py`` holds a
  dashboard (C-15); the command line runs end to end (settle cut to 5
  frames).
"""

import functools
import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu.core import math as jm
from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.parallel.batch import template_from_scene as jax_template_from_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu_torch.assets.image import read_png_samples
from stillleben_tpu_torch.assets.procedural import write_meshes
from stillleben_tpu_torch.convert import solver_config_from_jax
from stillleben_tpu_torch.parallel.batch import template_from_scene
from stillleben_tpu_torch.physics import tabletop
from stillleben_tpu_torch.tools import (
    align_mesh, display_mesh, settle_fidelity as sf, templates, viewer_demo,
)
from torch_port_scene import build_meshes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS, FRAMES = 4, 6
LIGHT = np.array([[-0.3, 0.4, -0.866]], np.float32) / np.float32(np.linalg.norm([-0.3, 0.4, -0.866]))


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def cpu_context():
    sl.init(device="cpu")


@pytest.fixture(autouse=True)
def native_cooker(monkeypatch, tmp_path):
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "mesh_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)


# ---------------------------------------------------------------------------
# settle_fidelity
# ---------------------------------------------------------------------------


def jax_configs():
    """The JAX script's configurations (tools/settle_fidelity.py:46-60)."""
    base = jax_default_config()
    return {
        "ref": base._replace(contact_gen="substep", max_narrow_pairs=256),
        "tuned": base._replace(contact_gen="every2", max_narrow_pairs=128),
        "frame_p128": base._replace(contact_gen="frame", max_narrow_pairs=128),
        "sleep10": base._replace(contact_gen="substep", max_narrow_pairs=256, sleep_frames=10),
        "sleep10_frame": base._replace(contact_gen="frame", max_narrow_pairs=128,
                                       sleep_frames=10),
        "sleep10_every2": base._replace(contact_gen="every2", max_narrow_pairs=128,
                                        sleep_frames=10),
    }


def jax_stats(p):
    """The JAX script's ``stats`` arithmetic (tools/settle_fidelity.py:65-71)."""
    p = np.asarray(p)
    assert np.isfinite(p).all(), "non-finite settle"
    z = p[:, :, 2, 3]
    xy = p[:, :, :2, 3]
    d = np.linalg.norm(xy[:, :, None, :] - xy[:, None, :, :], axis=-1)
    iu = np.triu_indices(p.shape[1], 1)
    return z, d[:, iu[0], iu[1]].ravel()


def jax_lines(results):
    """The JAX script's printed lines (tools/settle_fidelity.py:73-97)."""
    z_ref, pd_ref = results["ref"]
    lines = [f"ref: z_med {np.median(z_ref):.4f} z_q90 {np.quantile(z_ref, .9):.4f} "
             f"zmax {z_ref.max():.4f} pd_med {np.median(pd_ref):.4f} "
             f"pd_q90 {np.quantile(pd_ref, .9):.4f}"]
    for name, (z, pd) in results.items():
        if name == "ref":
            continue
        dz_med = abs(np.median(z) - np.median(z_ref))
        dz_q90 = abs(np.quantile(z, 0.9) - np.quantile(z_ref, 0.9))
        dz_max = abs(z.max() - z_ref.max())
        dpd_med = abs(np.median(pd) - np.median(pd_ref))
        dpd_q90 = abs(np.quantile(pd, 0.9) - np.quantile(pd_ref, 0.9))
        ok = (dz_med < 0.01 and dz_q90 < 0.02 and dz_max < 0.05
              and dpd_med < 0.10 and dpd_q90 < 0.20)
        lines.append(f"{name:16s} dz_med {dz_med:.4f} dz_q90 {dz_q90:.4f} "
                     f"dz_max {dz_max:.4f} dpd_med {dpd_med:.4f} dpd_q90 {dpd_q90:.4f} "
                     f"zmax {z.max():.3f}  {'PASS' if ok else 'FAIL'}")
    return lines


def test_configs_are_the_jax_scripts():
    port = sf.configs()
    jax_table = jax_configs()
    assert list(port) == list(jax_table)
    for name, cfg in jax_table.items():
        assert solver_config_from_jax(cfg) == port[name], name


def test_stats_and_lines_are_the_jax_scripts_arithmetic():
    """On the same poses (seeded, some configs a little off the reference,
    one far off), ``stats`` and every printed line equal the JAX script's."""
    rng = np.random.default_rng(3)
    base = np.tile(np.eye(4, dtype=np.float32), (SEEDS, 10, 1, 1))
    base[:, :, :3, 3] = rng.normal(0, 0.2, (SEEDS, 10, 3))
    poses = {"ref": base}
    for i, name in enumerate(sf.configs()):
        if name != "ref":
            p = base.copy()
            p[:, :, :3, 3] += rng.normal(0, 0.002 * (1 + i) ** 2, (SEEDS, 10, 3))
            poses[name] = p
    results_jax = {k: jax_stats(p) for k, p in poses.items()}
    results_port = {k: sf.stats(p) for k, p in poses.items()}
    for k in poses:
        for a, b in zip(results_jax[k], results_port[k]):
            np.testing.assert_array_equal(a, b)
    lines = [sf.ref_line(*results_port["ref"])]
    lines += [sf.config_line(k, *r, *results_port["ref"]) for k, r in results_port.items()
              if k != "ref"]
    assert lines == jax_lines(results_jax)
    assert {line.split()[-1] for line in lines[1:]} == {"PASS", "FAIL"}
    bad = base.copy()
    bad[0, 0, 2, 3] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite settle"):
        sf.stats(bad)


@pytest.fixture(scope="module")
def settle_setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("settle_meshes"))
    jmeshes = build_meshes(d, native_decomp=True)
    pmeshes = build_meshes(d, port=True, native_decomp=True)
    templates_ = []
    for meshes, scene_cls, object_cls in ((jmeshes, jsl.Scene, jsl.Object),
                                          (pmeshes, sl.Scene, sl.Object)):
        cube, sphere, blob = meshes
        cube.scale_to_bbox_diagonal(0.2)
        sphere.scale_to_bbox_diagonal(0.15)
        scene = scene_cls((48, 48))
        templates.add_objects(scene, (blob, cube, sphere), object_cls)
        templates_.append(scene)
    jtpl = jax_template_from_scene(templates_[0])
    ptpl = template_from_scene(templates_[1], "cpu")
    keys = jax.random.split(jax.random.PRNGKey(7), SEEDS)
    nb = ptpl.tabletop_geom.diameter.shape[0]
    quats = np.stack([np.asarray(jm.random_quaternion(jax.random.split(k, 3)[0], (nb,)))
                      for k in keys])
    return jtpl, ptpl, keys, torch.from_numpy(quats), {}


def _both(settle_setup, name):
    jtpl, ptpl, keys, quats, cache = settle_setup
    if name not in cache:
        cfg = jax_configs()[name]
        jp = jax.jit(jax.vmap(lambda k: jax_settle_scene(k, jtpl, cfg, FRAMES)[0]))(keys)
        pp = sf.settle_poses(ptpl, sf.configs()[name], SEEDS, FRAMES, quats=quats)
        cache[name] = (np.asarray(jp), pp)
    return cache[name]


@pytest.mark.parametrize("name", list(sf.configs()))
def test_settle_of_the_jax_draws(settle_setup, name):
    """The port's settle of the JAX draws equals the JAX package's within
    1e-5 under the configuration, and so do the statistics against the
    reference's; the PASS/FAIL word is the same."""
    jp, pp = _both(settle_setup, name)
    assert pp.shape == jp.shape == (SEEDS, 10, 4, 4)
    np.testing.assert_allclose(pp, jp, atol=1e-5)
    jref, pref = _both(settle_setup, "ref")
    zj, pdj = jax_stats(jp)
    zp, pdp = sf.stats(pp)
    np.testing.assert_allclose(zp, zj, atol=1e-5)
    np.testing.assert_allclose(pdp, pdj, atol=1e-5)
    if name != "ref":
        dj = sf.deltas(zj, pdj, *jax_stats(jref))
        dp = sf.deltas(zp, pdp, *sf.stats(pref))
        for k in dj:
            assert abs(dp[k] - dj[k]) < 1e-5, k
        assert jax_lines({"ref": jax_stats(jref), name: (zj, pdj)})[1].split()[-1] == \
            sf.config_line(name, zp, pdp, *sf.stats(pref)).split()[-1]


def test_settle_fidelity_command_line(monkeypatch, capsys):
    """``main`` on the CPU with two configs (the settle cut to 3 frames):
    the dense-mesh line, the ref line and one line per config; an unknown
    config is refused."""
    monkeypatch.setattr(templates, "load_meshes",
                        functools.partial(templates.load_meshes, subdiv=2))
    monkeypatch.setattr(sf, "FRAMES", 3)
    out = sf.main(["--device", "cpu", "--seeds", "2", "ref", "tuned"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dense mesh: the procedural blob (320 faces); 2 seeds x 3 frames on cpu"
    assert lines[1].startswith("ref: z_med") and lines[2].startswith("tuned ")
    assert lines[2].split()[-1] in ("PASS", "FAIL") and set(out) == {"ref", "tuned"}
    with pytest.raises(SystemExit):
        sf.main(["--device", "cpu", "nope"])


def test_device_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        sf.main(["ref"])


# ---------------------------------------------------------------------------
# align_mesh
# ---------------------------------------------------------------------------

ALIGN_ARGS = ["--rot-x", "90", "--rot-y", "-30", "--rot-z", "15", "--translate", "0.1", "-0.2",
              "0.05", "--scale", "0.5", "--diagonal", "0.4", "--center", "--write"]
KEYS = ["x", "right", "shift+right", "y", "up", "shift+down", "+", "z", "left", "-", "c", "u",
        "shift+left", "q"]


def _mesh_copy(tmp_path, sub: str) -> str:
    src = write_meshes(str(tmp_path / "meshes"), subdiv=2)["blob"]
    d = tmp_path / sub
    d.mkdir()
    dst = str(d / os.path.basename(src))
    shutil.copy(src, dst)
    return dst


def test_align_mesh_sidecar_is_the_jax_scripts(tmp_path, monkeypatch, capsys):
    jax_path, port_path = _mesh_copy(tmp_path, "jax"), _mesh_copy(tmp_path, "port")
    monkeypatch.setattr(sys, "argv", ["align_mesh.py", jax_path] + ALIGN_ARGS)
    jax_tool("align_mesh").main()
    jax_out = capsys.readouterr().out
    mesh = align_mesh.main([port_path] + ALIGN_ARGS + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    with open(jax_path + ".pretransform", "rb") as a, open(port_path + ".pretransform", "rb") as b:
        assert a.read() == b.read()
    assert port_out.replace(port_path, "M") == jax_out.replace(jax_path, "M")
    # the sidecar loads back into the port's Mesh
    again = sl.Mesh(port_path, physics=False)
    np.testing.assert_allclose(again.pretransform, mesh.pretransform, atol=1e-6)
    # a non-uniform scale is refused as the JAX Mesh refuses it
    with pytest.raises(ValueError):
        mesh.pretransform = np.diag([1.0, 2.0, 1.0, 1.0]).astype(np.float32)


def test_align_session_keys_match_jax(tmp_path, capsys):
    path = _mesh_copy(tmp_path, "session")
    JaxSession = jax_tool("align_mesh").AlignSession
    js = JaxSession(jsl.Mesh(path, physics=False))
    ps = align_mesh.AlignSession(sl.Mesh(path, physics=False))
    for k in KEYS:
        assert ps.handle_key(k) == js.handle_key(k), k
        np.testing.assert_allclose(ps.mesh.pretransform, js.mesh.pretransform, atol=1e-6)
    assert ps.axis == js.axis and ps._status() == js._status()
    img = ps.render(size=(40, 32))
    assert img.shape == (32, 40, 3) and img.dtype == np.uint8 and img.any()
    ps.handle_key("w")
    assert os.path.exists(path + ".pretransform")
    capsys.readouterr()


def test_align_session_web(tmp_path):
    import json
    import urllib.request

    session = align_mesh.AlignSession(sl.Mesh(_mesh_copy(tmp_path, "web"), physics=False))
    session.render = functools.partial(session.render, size=(32, 32))
    srv = session.run_web(port=0, block=False)
    try:
        req = urllib.request.Request(srv.url.rstrip("/") + "/event", method="POST",
                                     data=json.dumps({"type": "key", "key": "ArrowRight",
                                                      "shift": True}).encode())
        P0 = session.mesh.pretransform.copy()
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["seq"] == 1
        assert not np.allclose(P0, session.mesh.pretransform)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# display_mesh
# ---------------------------------------------------------------------------


def _hold_rgb(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    assert (d <= 1).mean() >= 0.99 and d.max() <= 13, ((d <= 1).mean(), d.max())


def test_display_mesh_sheet_is_the_jax_scripts(tmp_path, monkeypatch, capsys):
    path = write_meshes(str(tmp_path / "meshes"), subdiv=3)["blob"]

    def fixed_light(self):
        self.light_directions = LIGHT.copy()

    monkeypatch.setattr(jsl.Scene, "choose_random_light_direction", fixed_light)
    monkeypatch.setattr(sl.Scene, "choose_random_light_direction", fixed_light)
    jax_png = str(tmp_path / "jax.png")
    monkeypatch.setattr(sys, "argv", ["display_mesh.py", path, "--views", "3", "--size", "48",
                                      "--out", jax_png, "--physics"])
    jax_tool("display_mesh").main()
    jax_out = capsys.readouterr().out
    port_png = str(tmp_path / "port.png")
    sheet = display_mesh.main([path, "--views", "3", "--size", "48", "--out", port_png,
                               "--physics", "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert port_out.replace(port_png, "P").replace(str(tmp_path / "port"), "Q") == \
        jax_out.replace(jax_png, "P").replace(str(tmp_path / "jax"), "Q")
    got = read_png_samples(port_png).samples
    assert got.shape == (48, 144, 3) and np.array_equal(got, sheet)
    want = read_png_samples(jax_png).samples
    _hold_rgb(want, got)
    hulls = sorted(f for f in os.listdir(tmp_path) if f.startswith("port_hull_"))
    assert hulls == sorted(f.replace("jax_", "port_") for f in os.listdir(tmp_path)
                           if f.startswith("jax_hull_"))


# ---------------------------------------------------------------------------
# viewer_demo
# ---------------------------------------------------------------------------


def _demo_scene(pkg, size):
    scene = pkg.Scene((size, size))
    scene.ambient_light = (0.3, 0.3, 0.3)
    cube = pkg.Mesh("primitive://cube")
    cube.scale_to_bbox_diagonal(0.2)
    sphere = pkg.Mesh("primitive://sphere")
    sphere.scale_to_bbox_diagonal(0.18)
    for i, m in enumerate((cube, sphere, cube)):
        o = pkg.Object(m)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (-0.15 + 0.15 * i, 0.05 * i, 0.08 + 0.01 * i)
        o.set_pose(T)
        scene.add_object(o)
    scene.set_camera_look_at([0.5, -0.4, 0.45], [0, 0, 0.05])
    scene.light_directions = LIGHT.copy()
    return scene


def test_viewer_demo_is_the_jax_scripts(tmp_path):
    """The JAX script's loop (tools/viewer_demo.py:64-86) and the port's
    ``play`` on the same scene: the same lines, the frames held."""
    from test_torch_viewer import _hold_dashboard

    jtool = jax_tool("viewer_demo")
    scene = _demo_scene(jsl, 48)
    v = jsl.Viewer(scene)
    W, H = scene.viewport
    jax_lines_, idx = [], {"i": 0}

    def save(ev, img):
        jax_lines_.append(f"  [{idx['i']:02d}] {ev[0]:<7} -> {v._status_line()}")
        idx["i"] += 1

    jax_frames = v.play_script(jtool.demo_script(W, H), frame_cb=save)
    jax_lines_.append(f"viewer_demo: {len(jax_frames)} frames -> OUT")
    assert viewer_demo.demo_script(W, H) == jtool.demo_script(W, H)

    lines = []
    out_dir = str(tmp_path / "demo")
    frames = viewer_demo.play(_demo_scene(sl, 48), out_dir, out=lines.append)
    assert [line.replace(out_dir, "OUT") for line in lines] == jax_lines_
    assert len(frames) == len(jax_frames) == 12
    for a, b in zip(jax_frames, frames):
        _hold_dashboard(a, b, 48, 48, coords=False)
    for i, f in enumerate(frames):
        png = read_png_samples(os.path.join(out_dir, f"frame_{i:02d}.png")).samples
        assert np.array_equal(png, f)
    strip = read_png_samples(os.path.join(out_dir, "contact_sheet.png")).samples
    assert np.array_equal(strip, np.concatenate(frames[:6], axis=1))


def test_viewer_demo_command_line(tmp_path, monkeypatch, capsys):
    """``main`` on the CPU (the settle cut to 5 frames): 12 frames written."""
    monkeypatch.setattr(tabletop, "simulate_tabletop",
                        functools.partial(tabletop.simulate_tabletop, iterations=5))
    out_dir = str(tmp_path / "cli")
    frames = viewer_demo.main([out_dir, "--size", "32", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(frames) == 12 and lines[-1] == f"viewer_demo: 12 frames -> {out_dir}"
    assert sorted(os.listdir(out_dir)) == ["contact_sheet.png"] + [f"frame_{i:02d}.png"
                                                                  for i in range(12)]
