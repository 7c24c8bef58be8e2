"""The port's settle physics against the JAX package on the small scene.

Stacking, one substep and a 2-frame settle are compared pointwise, from
the same numpy-sampled orientations (the ``quats`` seam of
``stack_objects``) and the same template: one substep within 1e-5, two
frames within 1e-4. The full 100-frame settle is chaotic, so it is held to
a property in both packages: every body ends at rest on the floor. The
camera fit is compared for a given rotation within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.physics import tabletop as jtt
from stillleben_tpu.physics.engine import step_fn as jax_step_fn
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.scene.camera_fit import fit_camera_position as jax_fit_camera_position
from stillleben_tpu_torch.convert import state_from_numpy, template_from_numpy
from stillleben_tpu_torch.physics import tabletop as tt
from stillleben_tpu_torch.physics.contacts import world_hull_verts
from stillleben_tpu_torch.physics.engine import step_fn
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.scene.camera_fit import fit_camera_position
from torch_port_scene import build_meshes, jax_template, to_numpy

CFG = default_config()
JCFG = jax_default_config()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    tpl = jax_template(meshes)
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    q = np.random.default_rng(11).normal(size=(len(meshes), 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return tpl, ptpl, q


def _jax_settle(tpl, state, iterations):
    return jax.jit(
        jtt.settle, static_argnames=("cfg", "iterations", "substeps")
    )(tpl.hull_atlas, tpl.body_params, state, tpl.floor, tpl.pairs, tpl.tabletop_geom,
      JCFG, iterations=iterations)


def _assert_state_close(port_state, jax_state, atol):
    for name in ("pos", "quat", "lin_vel", "ang_vel"):
        np.testing.assert_allclose(
            getattr(port_state, name)[0].numpy(), np.asarray(getattr(jax_state, name)),
            rtol=0, atol=atol, err_msg=name,
        )


def test_stack_objects_matches_jax(setup):
    tpl, ptpl, q = setup
    sj = jtt.stack_objects(None, tpl.tabletop_geom, tpl.base_z, quats=jnp.asarray(q))
    sp = tt.stack_objects(ptpl.tabletop_geom, ptpl.base_z, torch.from_numpy(q)[None])
    _assert_state_close(sp, sj, 1e-6)


# 2 < the scene's 3 hull pairs: the broadphase keeps the 2 most overlapping
@pytest.mark.parametrize("narrow_pairs", [256, 2])
def test_one_substep_matches_jax(setup, narrow_pairs):
    tpl, ptpl, q = setup
    s0 = jtt.stack_objects(None, tpl.tabletop_geom, tpl.base_z, quats=jnp.asarray(q))
    s0 = _jax_settle(tpl, s0, 8)  # a pile in contact: floor and pair contacts active
    dt = jtt.FRAME_TIME / jtt.SUBSTEPS
    jcfg = JCFG._replace(max_narrow_pairs=narrow_pairs)
    sj, rep_j, _ = jax_step_fn(tpl.hull_atlas, tpl.body_params, s0, tpl.floor, tpl.pairs, dt, jcfg)
    assert np.isfinite(np.asarray(rep_j.min_separation)).any(), "no contacts in the test state"
    p0 = state_from_numpy(to_numpy(s0), "cpu")
    cfg = CFG._replace(max_narrow_pairs=narrow_pairs)
    sp, rep_p, _ = step_fn(ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs, dt, cfg)
    _assert_state_close(sp, sj, 1e-5)
    np.testing.assert_allclose(rep_p.min_separation[0].numpy(), np.asarray(rep_j.min_separation),
                               rtol=0, atol=1e-5)


def test_two_frame_settle_matches_jax(setup):
    tpl, ptpl, q = setup
    s0 = jtt.stack_objects(None, tpl.tabletop_geom, tpl.base_z, quats=jnp.asarray(q))
    sj = _jax_settle(tpl, s0, 2)
    p0 = state_from_numpy(to_numpy(s0), "cpu")
    sp = tt.settle(ptpl.hull_atlas, ptpl.body_params, p0, ptpl.floor, ptpl.pairs,
                   ptpl.tabletop_geom, CFG, iterations=2)
    _assert_state_close(sp, sj, 1e-4)


def _at_rest_on_floor(verts_z_min, lin_vel):
    assert (verts_z_min >= jtt.FLOOR_TOP_Z - 5e-3).all(), verts_z_min
    assert (np.linalg.norm(lin_vel, axis=-1) < 1e-2).all(), lin_vel


def test_full_settle_comes_to_rest_in_both(setup):
    tpl, ptpl, q = setup
    s0 = jtt.stack_objects(None, tpl.tabletop_geom, tpl.base_z, quats=jnp.asarray(q))
    sj = to_numpy(_jax_settle(tpl, s0, jtt.MAX_ITERATIONS))
    sp = tt.settle(ptpl.hull_atlas, ptpl.body_params, state_from_numpy(to_numpy(s0), "cpu"),
                   ptpl.floor, ptpl.pairs, ptpl.tabletop_geom, CFG)
    for state in (state_from_numpy(sj, "cpu"), sp):
        z = world_hull_verts(ptpl.hull_atlas, state)[0, ..., 2]
        z = torch.where(ptpl.hull_atlas.vert_valid, z, torch.inf)
        body = ptpl.hull_atlas.hull_body.long()
        zmin = torch.full((state.pos.shape[1],), torch.inf).scatter_reduce(0, body, z.amin(1), "amin")
        _at_rest_on_floor(zmin.numpy(), state.lin_vel[0].numpy())


def test_fit_camera_position_matches_jax(setup):
    tpl, ptpl, _ = setup
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.3, 0.3, (24, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2])
    a, e = 0.7, 0.6
    R = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    ) @ np.array([[np.cos(e), 0, np.sin(e)], [0, 1, 0], [-np.sin(e), 0, np.cos(e)]]) @ np.array(
        [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
    )
    R = R.astype(np.float32)
    valid = np.ones(24, bool)
    valid[3] = False
    pj = jax_fit_camera_position(jnp.asarray(R), tpl.base_inputs.projection, jnp.asarray(pts),
                                 jnp.asarray(valid))
    pp = fit_camera_position(torch.from_numpy(R)[None], ptpl.base_inputs.projection,
                             torch.from_numpy(pts)[None], torch.from_numpy(valid)[None])
    np.testing.assert_allclose(pp[0].numpy(), np.asarray(pj), rtol=0, atol=1e-5)
