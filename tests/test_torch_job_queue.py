"""``JobQueue`` of the port on the CPU, and the locks that its worker
threads need.

Held: two seeded scenes settled through two worker threads are bitwise
equal (poses, velocities, camera, plane) to the same scenes settled one
after another, since each scene draws only from its own generators; the
queue's FIFO order, the error pass-through, the camelCase aliases and
``close``; a worker runs with the context's device. The shared caches:
``ops/nvcc.py`` builds and loads a library once when many threads reach it
at the same time (the build stubbed, more threads than cores, a short
switch interval), and a ``Mesh`` shared by threads is cooked once. The
settle runs 40 of its 100 frames here, to keep the file short."""

import ctypes
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu_torch.assets import mesh as mesh_mod
from stillleben_tpu_torch.ops import nvcc
from stillleben_tpu_torch.physics import tabletop as tt

context_mod = sys.modules["stillleben_tpu_torch.context"]


@pytest.fixture(autouse=True)
def cpu_context():
    sl.init(device="cpu")


def _seeded_scene(mesh, seed):
    scene = sl.Scene((32, 32))
    scene.seed(seed)
    for _ in range(2):
        scene.add_object(sl.Object(mesh))
    return scene


def _state(scene):
    objs = [(o.pose(), o.linear_velocity, o.angular_velocity) for o in scene.objects]
    return objs, scene.camera_pose(), scene.background_plane_pose


def test_threaded_settle_equals_serial(monkeypatch):
    """The settle cut to 40 of its 100 frames (the file's time): what is
    held is that two threads stepping at once change no bit."""
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")
    monkeypatch.setattr(tt, "simulate_tabletop", functools.partial(tt.simulate_tabletop,
                                                                   iterations=40))
    mesh = sl.Mesh("primitive://cube")
    mesh.scale_to_bbox_diagonal(0.2)
    threaded = [_seeded_scene(mesh, s) for s in (2, 3)]
    q = sl.JobQueue(num_threads=2)
    try:
        for s in threaded:
            q.add_scene(s)
        done = [q.retrieve_scene() for _ in threaded]
    finally:
        q.close()
    assert {id(s) for s in done} == {id(s) for s in threaded}
    for scene, seed in zip(threaded, (2, 3)):
        serial = _seeded_scene(mesh, seed)
        serial.simulate_tabletop_scene()
        (a, cam_a, plane_a), (b, cam_b, plane_b) = _state(scene), _state(serial)
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert np.array_equal(u, v)
        assert np.array_equal(cam_a, cam_b) and np.array_equal(plane_a, plane_b)
        z = [o.pose()[2, 3] for o in scene.objects]
        assert all(0.0 < v < 1.0 for v in z), z  # settled above the floor
    # the two seeds settled differently
    assert not np.array_equal(threaded[0].objects[0].pose(), threaded[1].objects[0].pose())


class _FakeScene:
    """What the queue calls: ``simulate_tabletop_scene``."""

    def __init__(self, name, delay=0.0, error=None):
        self.name, self.delay, self.error = name, delay, error
        self.device = None

    def simulate_tabletop_scene(self):
        time.sleep(self.delay)
        self.device = context_mod.context().device
        if self.error is not None:
            raise self.error


def test_fifo_errors_aliases_and_close():
    q = sl.JobQueue(num_threads=1)
    scenes = [_FakeScene(i, delay=0.02 * (3 - i)) for i in range(3)]
    for s in scenes:
        q.addScene(s)
    assert [q.retrieveScene().name for _ in scenes] == [0, 1, 2]  # one worker: FIFO
    assert scenes[0].device == torch.device("cpu")
    q.add_scene(_FakeScene("bad", error=ValueError("settle failed")))
    q.add_scene(_FakeScene("after"))
    with pytest.raises(ValueError, match="settle failed"):
        q.retrieve_scene()
    assert q.retrieve_scene().name == "after"  # the worker kept running
    q.close()
    for t in q._threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_results_come_in_completion_order():
    q = sl.JobQueue(num_threads=2)
    try:
        q.add_scene(_FakeScene("slow", delay=0.5))
        q.add_scene(_FakeScene("fast", delay=0.0))
        assert [q.retrieve_scene().name for _ in range(2)] == ["fast", "slow"]
    finally:
        q.close()
    assert len(q._threads) == 2


def _race(n_threads, fn):
    """Run ``fn`` from ``n_threads`` threads at once (a short switch
    interval, restored after); returns their results."""
    barrier = threading.Barrier(n_threads)
    out = [None] * n_threads

    def run(i):
        barrier.wait(timeout=30)
        out[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    return out


def test_nvcc_load_builds_once_under_threads(monkeypatch):
    """``load`` from many threads at once, the build stubbed: one build,
    one load, every thread gets the same library."""
    builds, loads = [], []

    def fake_build(source):
        builds.append(source)
        time.sleep(0.05)  # a compile takes time: the others arrive meanwhile
        return f"/lib{source}.so", "log"

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            self.sl_entry = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(nvcc, "_build", fake_build)
    monkeypatch.setattr(nvcc.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(nvcc, "_loaded", {})
    libs = _race(32, lambda: nvcc.load("race.cu", "sl_entry", []))
    assert builds == ["race.cu"] and loads == ["/librace.cu.so"]
    assert all(lib is libs[0] for lib in libs)
    # another source builds on its own; build() takes the same lock
    _race(8, lambda: nvcc.build("other.cu"))
    assert builds.count("other.cu") == 8  # build() compiles (the stub caches nothing)
    assert set(nvcc._locks) >= {"race.cu", "other.cu"}


def test_shared_mesh_is_cooked_once(monkeypatch):
    calls = []
    original = mesh_mod.decompose

    def counting(*args, **kwargs):
        calls.append(1)
        time.sleep(0.02)
        return original(*args, **kwargs)

    monkeypatch.setattr(mesh_mod, "decompose", counting)
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "0")
    mesh = sl.Mesh("primitive://sphere", physics=False)
    hulls = _race(16, lambda: (mesh.load_physics(), mesh._physics)[1])
    assert len(calls) == 1 and all(h is hulls[0] for h in hulls)
