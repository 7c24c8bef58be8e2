"""``ManipulationSim`` of the port against the JAX package's on the CPU:
``tests/test_tools.py``'s two cases on 0.2 m ``primitive://cube`` bodies
(cooked natively in both packages) with gravity 0.

Tolerances: with a lone pusher nothing collides, so each step is the
spring drive and one integration: the port's trajectory within 1e-4 of the
JAX package's at every one of 100 steps, its rotation within 1e-5 of the
identity. The torque-transfer case is contact-rich, so it is held by its
properties, as the JAX test holds it: the target pushed past 0.20 m and
spun (> 1e-3 rad/s or 5e-3 rad), the pusher's rotation within 1e-5 of the
identity. The rotation lock reaches the solver through ``Scene._compile``:
its stamp holds ``lock_rotation``, so a compiled body set from before the
lock is never reused."""

import numpy as np
import pytest

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu_torch.scene import manipulation_sim


@pytest.fixture(scope="module", autouse=True)
def cpu_context():
    sl.init(device="cpu")


@pytest.fixture(autouse=True)
def native_cooker(monkeypatch):
    monkeypatch.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1")


def _scene(pkg, target=False):
    mesh = pkg.Mesh("primitive://cube")
    mesh.scale_to_bbox_diagonal(0.2)
    scene = pkg.Scene((32, 32))
    scene.gravity = [0.0, 0.0, 0.0]
    pusher = pkg.Object(mesh)
    scene.add_object(pusher)
    if target:
        t = pkg.Object(mesh)
        tpose = np.eye(4, dtype=np.float32)
        # offset in +x, shifted in y so the push line misses the target's COM
        tpose[:3, 3] = [0.18, 0.07, 0.0]
        t.set_pose(tpose)
        scene.add_object(t)
    return scene, pusher


def test_constants_are_the_reference_drive():
    from stillleben_tpu.scene import manipulation_sim as jms

    assert (manipulation_sim.STIFFNESS, manipulation_sim.DAMPING, manipulation_sim.FORCE_LIMIT) \
        == (jms.STIFFNESS, jms.DAMPING, jms.FORCE_LIMIT) == (600.0, 0.1, 60.0)


@pytest.mark.parametrize("goal_x,initial", [(0.2, None), (-0.5, 0.1)])
def test_lone_pusher_trajectory_matches_jax(goal_x, initial):
    """``test_manipulation_sim`` in both packages, step by step; the far
    goal (-0.5 m) starts beyond the force limit, so the clamp is held
    too."""
    sims, objs = [], []
    for pkg in (jsl, sl):
        scene, obj = _scene(pkg)
        start = np.eye(4, dtype=np.float32)
        if initial is not None:
            start[:3, 3] = [initial, -initial, 0.05]
        sims.append(pkg.ManipulationSim(scene, obj, start))
        objs.append(obj)
    goal = np.eye(4, dtype=np.float32)
    goal[:3, 3] = [goal_x, 0.0, 0.0]
    for _ in range(100):
        for sim in sims:
            sim.step(goal, 0.01)
        np.testing.assert_allclose(objs[1].pose()[:3, 3], objs[0].pose()[:3, 3], atol=1e-4)
        np.testing.assert_allclose(objs[1].linear_velocity, objs[0].linear_velocity, atol=1e-3)
    p = objs[1].pose()[:3, 3]
    assert (p[0] > 0.05) if goal_x > 0 else (p[0] < initial - 0.1), p
    np.testing.assert_allclose(objs[1].pose()[:3, :3], np.eye(3), atol=1e-5)


def test_torque_transfer_by_properties():
    """``test_manipulation_torque_transfer`` on the port: pushing a free
    cube off-centre spins it, while the lock keeps the pusher unrotated."""
    scene, pusher = _scene(sl, target=True)
    target = scene.objects[1]
    sim = sl.ManipulationSim(scene, pusher, np.eye(4, dtype=np.float32))
    goal = np.eye(4, dtype=np.float32)
    goal[:3, 3] = [0.35, 0.0, 0.0]
    for _ in range(120):
        sim.step(goal, 0.01)
    assert target.pose()[0, 3] > 0.20, f"target not pushed: {target.pose()[:3, 3]}"
    spin = float(np.abs(target.angular_velocity).max())
    Rt = target.pose()[:3, :3]
    rot_angle = float(np.arccos(np.clip((np.trace(Rt) - 1) / 2, -1, 1)))
    assert spin > 1e-3 or rot_angle > 5e-3, (spin, rot_angle)
    np.testing.assert_allclose(pusher.pose()[:3, :3], np.eye(3), atol=1e-5)


def test_lock_reaches_the_compiled_bodies():
    """The pusher's inverse inertia is zero in the compiled body set after
    the lock, with or without ``_invalidate``: the compile stamp holds the
    flag, so a set compiled before the lock is not reused."""
    scene, pusher = _scene(sl, target=True)
    before = scene._compile()[1].inv_inertia_body
    assert before[0].abs().max() > 0
    pusher.lock_rotation = True  # no _invalidate: the stamp changes
    locked = scene._compile()[1].inv_inertia_body
    assert locked[0].abs().max() == 0 and locked[1].abs().max() > 0
    pusher.lock_rotation = False
    assert scene._compile()[1].inv_inertia_body[0].abs().max() > 0
    sl.ManipulationSim(scene, pusher)
    assert pusher.lock_rotation and scene._compiled is None
    assert scene._compile()[1].inv_inertia_body[0].abs().max() == 0
