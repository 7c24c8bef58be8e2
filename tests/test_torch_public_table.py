"""The small modules of the public table against the JAX package's on the
CPU: ``Animator``, ``utils/arcball``, ``profiling``, ``extension`` and
``physics/telemetry``, on the same numpy inputs made from a seed.

Tolerances: every tick of an ``Animator`` within 1e-6 (the slerp's float32
rounding), keyframes with antipodal and near-equal quaternions included;
the arcball's ``camera_pose()`` bitwise equal after the same drags and
zooms (both are the same float64 numpy); ``matrix_to_quat`` and
``quat_slerp``, which the new modules call, within 1e-6; the profiling
report's text equal for the same nesting; the telemetry's records,
``summary``, JSONL ``save``/``load`` and redrop counts within 1e-6 (the
records round to 6 decimals, so a value on a rounding edge may move by one
unit there) for scenes given the same poses and velocities. The scenes are
seeded and the states set, not settled: the telemetry is numpy over the
host API, and an unseeded settle gives another stack on every run
(ROADMAP C-1)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu import profiling as jprof
from stillleben_tpu.core import math as jm
from stillleben_tpu.physics.telemetry import PhysicsTelemetry as JTelemetry
from stillleben_tpu.utils.arcball import ArcBall as JArcBall
from stillleben_tpu_torch import extension, profiling
from stillleben_tpu_torch.core import math as m
from stillleben_tpu_torch.physics.telemetry import PhysicsTelemetry
from stillleben_tpu_torch.utils.arcball import ArcBall


@pytest.fixture(scope="module", autouse=True)
def cpu_context():
    sl.init(device="cpu")


def _quats(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _poses(seed, quats):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (len(quats), 1, 1))
    T[:, :3, :3] = np.asarray(jm.quat_to_matrix(jnp.asarray(quats)))
    T[:, :3, 3] = rng.normal(size=(len(quats), 3))
    return T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternion_math_matches_jax(seed):
    """What the animator and the telemetry call: ``matrix_to_quat`` (each
    Shepperd branch) and ``quat_slerp`` on random, antipodal and
    near-equal pairs."""
    q0 = _quats(seed, 64)
    R = np.array(jm.quat_to_matrix(jnp.asarray(q0)))
    np.testing.assert_allclose(m.matrix_to_quat(torch.from_numpy(R)).numpy(),
                               np.asarray(jm.matrix_to_quat(jnp.asarray(R))), atol=1e-6)
    near = q0 + 1e-7 * np.random.default_rng(seed + 9).normal(size=q0.shape).astype(np.float32)
    for q1 in (_quats(seed + 5, 64), -q0, near / np.linalg.norm(near, axis=1, keepdims=True)):
        for t in (0.0, 0.3, 0.5, 1.0):
            got = m.quat_slerp(torch.from_numpy(q0), torch.from_numpy(q1), np.float32(t))
            ref = jm.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.float32(t))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("n_keys,ticks,seed", [(3, 17, 0), (4, 30, 1), (5, 9, 2)])
def test_animator_matches_jax(n_keys, ticks, seed):
    q = _quats(seed, n_keys)
    q[1] = -q[0]  # the antipodal keyframe: the same rotation, the other hemisphere
    if n_keys > 3:  # a near-equal pair
        near = q[2] + np.float32(1e-6)
        q[3] = near / np.linalg.norm(near)
    poses = _poses(seed + 10, q)
    ja, pa = jsl.Animator(list(poses), ticks), sl.Animator(list(poses), ticks)
    assert len(pa) == len(ja) == pa.total_ticks == ticks
    got, ref = list(pa), list(ja)
    assert len(got) == len(ref) == ticks
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == (4, 4)
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got[0], poses[0], atol=1e-6)
    np.testing.assert_allclose(got[-1], poses[-1], atol=1e-6)
    # __call__ advances; __iter__ restarts
    pa2 = sl.Animator(list(poses), ticks)
    np.testing.assert_array_equal(pa2(), got[0])
    np.testing.assert_array_equal(pa2(), got[1])
    assert len(list(iter(pa2))) == ticks
    with pytest.raises(ValueError, match="at least 2"):
        sl.Animator([poses[0]], ticks)


def test_animator_translation_as_jax_test():
    """``tests/test_tools.py::test_animator`` on the port."""
    p0, p1 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    p1[:3, 3] = [1, 0, 0]
    poses = list(sl.Animator([p0, p1], ticks=5))
    assert len(poses) == 5
    np.testing.assert_allclose(poses[0][:3, 3], [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(poses[-1][:3, 3], [1, 0, 0], atol=1e-6)
    assert poses[2][0, 3] == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_arcball_matches_jax(seed):
    """The same drags (inside and outside the unit disc) and zooms: the
    camera pose bitwise equal after each event."""
    rng = np.random.default_rng(seed)
    eye = rng.normal(size=3) * 2
    center, up, window = rng.normal(size=3) * 0.2, [0.0, 0.0, 1.0], (320, 240)
    balls = JArcBall(eye, center, up, window), ArcBall(eye, center, up, window)
    for step in range(12):
        if step % 4 == 3:
            f = float(rng.choice([1.1, 1 / 1.1, 2.0]))
            for b in balls:
                b.zoom(f)
        else:
            x0, y0, x1, y1 = rng.uniform(-40, 360, size=4)
            moved = []
            for b in balls:
                b.start(x0, y0)
                moved.append(b.drag(x1, y1))
                moved.append(b.drag(x1 + 3.0, y1 - 2.0))
                b.stop()
            assert moved[:2] == moved[2:]
        assert np.array_equal(balls[0].camera_pose(), balls[1].camera_pose())
        assert np.array_equal(balls[0].eye, balls[1].eye) and np.array_equal(balls[0].up, balls[1].up)


def test_arcball_orbit_as_jax_test():
    """``tests/test_tools.py::test_arcball_orbit`` on the port."""
    ball = ArcBall(eye=[0, -3, 1], center=[0, 0, 0.5], up=[0, 0, 1], window_size=(200, 200))
    r0 = np.linalg.norm(np.asarray(ball.eye) - ball.center)
    ball.start(100, 100)
    assert ball.drag(140, 90)
    r1 = np.linalg.norm(ball.eye - ball.center)
    assert abs(r1 - r0) < 1e-9
    T = ball.camera_pose()
    R = T[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    c_cam = R.T @ (np.asarray(ball.center) - T[:3, 3])
    assert c_cam[2] > 0
    np.testing.assert_allclose(c_cam[:2], 0.0, atol=1e-6)
    ball.zoom(2.0)
    assert abs(np.linalg.norm(ball.eye - ball.center) - r1 / 2) < 1e-9


@pytest.mark.parametrize("sync", [False, True])
def test_profiling_report_matches_jax(capsys, monkeypatch, sync):
    outs = []
    for mod in (jprof, profiling):
        ticks = iter(np.arange(100) * 0.00125)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(ticks)))
        monkeypatch.setattr(mod.Timer, "enabled", True)
        x = (jnp.ones(3) if mod is jprof else torch.ones(3)) if sync else None
        with mod.Timer("outer", sync=x):
            with mod.Timer("inner"):
                pass
            with mod.Timer("inner", sync=x):
                with mod.Timer("leaf"):
                    pass
        with mod.Timer("second"):
            pass
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "outer" in outs[1] and "leaf" in outs[1]


def test_profiling_records_and_decorator(monkeypatch):
    """Disabled scopes record nothing; ``drain_records`` returns (depth,
    label, seconds) records of open scopes and clears them; ``@Timer``."""
    monkeypatch.setattr(profiling.Timer, "enabled", False)
    with profiling.Timer("off"):
        pass
    assert profiling.drain_records() == []
    monkeypatch.setattr(profiling.Timer, "enabled", True)

    @profiling.Timer("fn", sync={"a": [torch.ones(2)]})
    def fn():
        return 1

    with profiling.Timer("top"):
        fn()
        recs = [(d, label) for d, label, _ in profiling._records]
    assert recs == [(0, "top"), (1, "fn")]
    assert profiling.drain_records() == []  # the report drained them


def test_profiling_sync_skips_cpu_tensors(monkeypatch):
    """``sync`` synchronizes the CUDA devices of the tree's tensors only:
    none for CPU tensors (the card's case runs in ``chip_smoke.py``)."""
    synced = []
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(profiling.Timer, "enabled", True)
    tree = [torch.ones(1), {"k": (torch.ones(1),)}]
    with profiling.Timer("cpu", sync=tree):
        pass
    assert synced == [] and profiling._cuda_devices(tree, set()) == set()


def test_extension_include_paths():
    paths = extension.include_paths()
    assert len(paths) == 1 and os.path.isfile(os.path.join(paths[0], "sl_decompose.h"))
    assert os.path.normpath(paths[0]).endswith(os.path.join("stillleben_tpu_torch", "csrc"))


def test_extension_load_builds_and_calls(tmp_path):
    """A small source that includes ``sl_decompose.h`` from
    ``include_paths()``, built with the port's cooker source into one
    library by g++, calls ``sl_convex_hull`` on a unit cube's corners."""
    import ctypes

    src = tmp_path / "probe.cpp"
    src.write_text(
        '#include "sl_decompose.h"\n'
        'extern "C" float sl_probe_volume(const float* pts, int n) {\n'
        "  float v[64 * 3], p[64 * 4], vol = 0.f, com[3], inertia[9];\n"
        "  int nv = 0, np_ = 0;\n"
        "  if (sl_convex_hull(pts, n, 64, 64, v, &nv, p, &np_, &vol, com, inertia) != 1) return -1.f;\n"
        "  return vol;\n}\n")
    cooker = os.path.join(extension.include_paths()[0], "sl_decompose.cpp")
    lib = extension.load("sl_probe", [str(src), cooker])
    assert isinstance(lib, ctypes.CDLL)
    fn = lib.sl_probe_volume
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    fn.restype = ctypes.c_float
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    vol = fn(corners.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 8)
    assert vol == pytest.approx(1.0, rel=1e-5)
    # the same sources load the same build; a failing source raises with g++'s text
    assert extension.load("sl_probe", [str(src), cooker])._name == lib._name
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        extension.load("sl_bad", [str(bad)])


def _tele_scenes(monkeypatch, n=3, seed=0):
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")
    out = []
    for pkg in (jsl, sl):
        scene = pkg.Scene((64, 48))
        scene.seed(seed)
        mesh = pkg.Mesh("primitive://cube")
        for _ in range(n):
            scene.add_object(pkg.Object(mesh))
        out.append(scene)
    return out


def _set_state(scenes, seed, sep=True):
    rng = np.random.default_rng(seed)
    n = len(scenes[0].objects)
    poses = _poses(seed, _quats(seed, n))
    lin, ang = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)
    lin[0] *= 0.01  # one slow body: the resting rule sees both cases across frames
    seps = rng.normal(scale=0.01, size=n)
    seps[-1] = np.inf
    for scene in scenes:
        for i, o in enumerate(scene.objects):
            o.set_pose(poses[i])
            o.linear_velocity, o.angular_velocity = lin[i], ang[i]
            if sep:
                o.separation = float(seps[i])
    return poses


def _assert_frames_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "bodies":
            assert len(a[k]) == len(b[k])
            for ba, bb in zip(a[k], b[k]):
                assert ba.keys() == bb.keys()
                for f in ba:
                    if ba[f] is None or bb[f] is None:
                        assert ba[f] is bb[f], f
                    else:
                        np.testing.assert_allclose(ba[f], bb[f], atol=1e-6, err_msg=f)
        elif isinstance(a[k], float) or isinstance(b[k], float):
            assert a[k] == pytest.approx(b[k], abs=1e-6), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1])
def test_telemetry_matches_jax(monkeypatch, tmp_path, seed):
    """Four frames of the same states in both packages: free bodies, a
    resting frame, a teleport up (a redrop) and a frame without
    separations; then each package's JSONL capture read by both loaders
    and ``replay`` of every frame."""
    scenes = _tele_scenes(monkeypatch, seed=seed)
    teles = JTelemetry(), PhysicsTelemetry()
    for f in range(4):
        poses = _set_state(scenes, seed * 10 + f, sep=f != 3)
        for scene in scenes:
            if f == 1:  # at rest
                for o in scene.objects:
                    o.linear_velocity, o.angular_velocity = np.zeros(3), np.zeros(3)
            if f == 2:  # body 1 jumps up by 0.5 m: one redrop
                T = scene.objects[1].pose()
                T[2, 3] = teles[0].frames[-1]["bodies"][1]["pos"][2] + 0.5
                scene.objects[1].set_pose(T)
        got = [t.record(s, iteration=f * 3 if f % 2 else None) for t, s in zip(teles, scenes)]
        _assert_frames_close(got[0], got[1])
    assert teles[1].frames[1]["resting"] and teles[1].frames[2]["redrops"] >= 1
    sj, sp = teles[0].summary(), teles[1].summary()
    assert sj.keys() == sp.keys()
    for k in sj:
        assert sp[k] == pytest.approx(sj[k], abs=1e-6), k
    assert PhysicsTelemetry().summary() == JTelemetry().summary() == {"frames": 0}
    paths = teles[0].save(str(tmp_path / "jax.jsonl")), teles[1].save(str(tmp_path / "port.jsonl"))
    for path in paths:
        (fj, sumj), (fp, sump) = JTelemetry.load(path), PhysicsTelemetry.load(path)
        assert fj == fp and sumj == sump
    frames_p, summary_p = PhysicsTelemetry.load(paths[1])
    assert summary_p == teles[1].summary() and frames_p == teles[1].frames
    for a, b in zip(PhysicsTelemetry.load(paths[0])[0], frames_p):
        _assert_frames_close(a, b)
    for f in range(4):
        for t, s in zip(teles, scenes):
            t.replay(s, f)
        for oj, op in zip(scenes[0].objects, scenes[1].objects):
            np.testing.assert_allclose(op.pose(), oj.pose(), atol=1e-6)


def test_telemetry_vis_cb_and_simulate(monkeypatch):
    """``vis_cb`` records one frame per call with its iteration; a
    ``simulate`` step of two overlapping cubes reports each body's
    separation (``tests/test_telemetry.py::test_record_through_settle``'s
    second part), the JAX package's within 1e-5 (one physics step, as
    ``test_torch_scene.py`` holds ``simulate``)."""
    scenes = _tele_scenes(monkeypatch, n=2)
    teles = JTelemetry(), PhysicsTelemetry()
    cb = teles[1].vis_cb(scenes[1])
    cb(0)
    cb(7)
    assert [f["frame"] for f in teles[1].frames] == [0, 7]
    teles[1].frames.clear()
    frames = []
    for scene, tele in zip(scenes, teles):
        T = np.eye(4, dtype=np.float32)
        scene.objects[0].set_pose(T)
        T[0, 3] = 1.95  # the primitive cube's corners are at +-1: 5 cm of overlap
        scene.objects[1].set_pose(T)
        scene.simulate(0.004)
        frames.append(tele.record(scene))
    assert frames[1]["min_separation"] is not None
    for bj, bp in zip(frames[0]["bodies"], frames[1]["bodies"]):
        assert bp["separation"] == pytest.approx(bj["separation"], abs=1e-5)
        np.testing.assert_allclose(bp["pos"], bj["pos"], atol=1e-5)
    assert frames[1]["min_separation"] == pytest.approx(frames[0]["min_separation"], abs=1e-5)
