"""The port's frame and every2 contact cadences and the sleep exit against
the JAX package on the small scene.

One ``frame_fn`` call (the ``frame`` cadence: contacts generated once per
frame with a speculative margin, 4 warm-started substeps) and one
``every2`` block (2 substeps) run from the same fixed states and
accumulators in both packages, B = 2 scenes whose fastest bodies differ, so
their margins differ; the JAX function is vmapped over the scenes. The
sleep exit runs B = 2 scenes, one already at rest and one dropped by 2 cm
onto its resting pose: each scene's stop frame equals the JAX package's,
the resting scene's final state equals it within 1e-5 and equals the port's
run of that scene alone (the finished scene's carry is held while the
other goes on), and the poses differ from the port's own fixed schedule by
less than the 2e-3 m of ``tests/test_physics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.physics import engine as jeng
from stillleben_tpu.physics import tabletop as jtt
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu_torch.convert import (
    accumulators_from_numpy, solver_config_from_jax, state_from_numpy, template_from_numpy,
)
from stillleben_tpu_torch.physics import tabletop as tt
from stillleben_tpu_torch.physics.engine import frame_fn, gather_contacts
from stillleben_tpu_torch.physics.types import BodyState
from torch_port_scene import build_meshes, jax_template, to_numpy

JCFG = jax_default_config()
ITERATIONS = 80  # both scenes of the sleep test stop before this


def _quats(seed, n):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


_jsettle = jax.jit(jtt.settle, static_argnames=("cfg", "iterations", "substeps"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    tpl = jax_template(meshes)
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    n = len(meshes)

    def stacked(seed):
        return jtt.stack_objects(None, tpl.tabletop_geom, tpl.base_z,
                                 quats=jnp.asarray(_quats(seed, n)))

    def settled(seed, frames):
        return _jsettle(tpl.hull_atlas, tpl.body_params, stacked(seed), tpl.floor, tpl.pairs,
                        tpl.tabletop_geom, JCFG, iterations=frames)

    # a pile in contact, and a scene a few frames into its fall: the
    # fastest bodies (and so the speculative margins) differ
    contact = jax.tree.map(lambda a, b: jnp.stack([a, b]), settled(11, 8), settled(12, 3))
    # the sleep test's pair: a scene at rest after the full schedule, and a
    # resting pile lifted by 2 cm and dropped (a full stack's fall is
    # chaotic: its stop frame would not be a property of the code)
    rest = settled(12, 100)
    dropped = rest._replace(pos=rest.pos.at[:, 2].add(0.02))
    sleep = jax.tree.map(lambda a, b: jnp.stack([a, b]), settled(11, 100), dropped)
    return tpl, ptpl, contact, sleep


def _accumulators(nc, seed=5):
    """Fixed warm-start accumulators for both scenes: normal impulses in
    [0, 2e-3), tangential ones of either sign (the solver clamps them to
    the friction cone)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 2e-3, (2, nc)).astype(np.float32),
            rng.normal(0, 5e-4, (2, nc)).astype(np.float32),
            rng.normal(0, 5e-4, (2, nc)).astype(np.float32))


def _contact_count(ptpl, state):
    c = gather_contacts(ptpl.hull_atlas, ptpl.body_params, state, ptpl.floor, ptpl.pairs,
                        JCFG.max_narrow_pairs)
    return c.depth.shape[1]


@pytest.mark.parametrize("cadence", ["frame", "every2"])
def test_frame_fn_matches_jax(setup, cadence):
    tpl, ptpl, contact, _ = setup
    speed = np.linalg.norm(np.asarray(contact.lin_vel), axis=-1).max(1)
    assert abs(speed[0] - speed[1]) > 0.1, f"the scenes' fastest bodies are alike: {speed}"
    frame_dt, substeps = ((jtt.FRAME_TIME, jtt.SUBSTEPS) if cadence == "frame"
                          else (jtt.FRAME_TIME / 2, 2))
    jcfg = JCFG._replace(contact_gen=cadence)
    p0 = state_from_numpy(to_numpy(contact), "cpu")
    acc = _accumulators(_contact_count(ptpl, p0))

    def one(st, a):
        return jeng.frame_fn(tpl.hull_atlas, tpl.body_params, st, tpl.floor, tpl.pairs,
                             frame_dt, substeps, jcfg, warm=a)

    sj, rep_j, acc_j = jax.jit(jax.vmap(one))(contact, tuple(jnp.asarray(a) for a in acc))
    assert np.isfinite(np.asarray(rep_j.min_separation)).any(), "no contacts in the test state"
    sp, rep_p, acc_p = frame_fn(
        ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs, frame_dt, substeps,
        solver_config_from_jax(jcfg), warm=accumulators_from_numpy(acc, "cpu"),
    )
    for name in BodyState._fields:
        # 1e-5 as one substep, and 1e-5 relative for the velocities: over
        # the frame's 4 substeps of 12 solver iterations a body spinning at
        # 1.6 rad/s was measured 1.34e-5 rad/s (1.4e-6 relative) apart
        rtol = 1e-5 if name.endswith("vel") else 0
        np.testing.assert_allclose(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=rtol, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(rep_p.min_separation.numpy(), np.asarray(rep_j.min_separation),
                               rtol=0, atol=1e-5)
    for a, b in zip(acc_p, acc_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _jax_sleep_settle(tpl, states, cfg):
    """The JAX settle vmapped over the scenes, with each scene's stop frame:
    the loop counter of its ``while_loop``, read through a wrapper of
    ``jax.lax.while_loop`` while the program is traced."""

    def run(st):
        carries = []
        original = jax.lax.while_loop

        def recording(cond, body, init):
            carries.append(original(cond, body, init))
            return carries[-1]

        jax.lax.while_loop = recording
        try:
            out = jtt.settle(tpl.hull_atlas, tpl.body_params, st, tpl.floor, tpl.pairs,
                             tpl.tabletop_geom, cfg, iterations=ITERATIONS)
        finally:
            jax.lax.while_loop = original
        return out, carries[0][3]

    return jax.jit(jax.vmap(run))(states)


@pytest.mark.parametrize("cadence", ["substep", "frame"])
def test_sleep_exit_matches_jax(setup, cadence):
    tpl, ptpl, _, sleep = setup
    jcfg = JCFG._replace(contact_gen=cadence, sleep_frames=10)
    sj, stop_j = _jax_sleep_settle(tpl, sleep, jcfg)
    stop_j = np.asarray(stop_j)
    assert stop_j.max() < ITERATIONS, f"a scene did not come to rest: {stop_j}"
    cfg = solver_config_from_jax(jcfg)
    p0 = state_from_numpy(to_numpy(sleep), "cpu")
    args = (ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs, ptpl.tabletop_geom)
    sp, stop_p = tt.settle_with_stop(*args, cfg, iterations=ITERATIONS)
    np.testing.assert_array_equal(stop_p.numpy(), stop_j)
    for name in BodyState._fields:  # the resting scene, which stops first
        np.testing.assert_allclose(getattr(sp, name)[0].numpy(), np.asarray(getattr(sj, name))[0],
                                   rtol=0, atol=1e-5, err_msg=name)
    alone, stop_0 = tt.settle_with_stop(
        *args[:2], BodyState(*(x[:1] for x in p0)), *args[3:], cfg, iterations=ITERATIONS)
    assert int(stop_0[0]) == int(stop_p[0]) < int(stop_p[1])
    # a batch of one rounds apart by up to 5.1e-6 (quat, measured); had the
    # resting scene run on to the other's stop frame, its angular velocity
    # would be 1e-4 rad/s off
    for a, b in zip(alone, sp):
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=1e-5)
    fixed = tt.settle(*args, cfg._replace(sleep_frames=0), iterations=ITERATIONS)
    d = (sp.pos - fixed.pos).abs().max()
    assert d < 2e-3, f"the sleep exit moved resting poses by {float(d):.4f} m"


def test_every2_needs_even_substeps(setup):
    _, ptpl, contact, _ = setup
    cfg = solver_config_from_jax(JCFG._replace(contact_gen="every2"))
    p0 = state_from_numpy(to_numpy(contact), "cpu")
    with pytest.raises(ValueError, match="even substep count"):
        tt.settle(ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs,
                  ptpl.tabletop_geom, cfg, iterations=1, substeps=3)
    with pytest.raises(ValueError, match="contact_gen"):
        tt.settle(ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs,
                  ptpl.tabletop_geom, cfg._replace(contact_gen="often"), iterations=1)
