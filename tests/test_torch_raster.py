"""The port's cell raster against the JAX package's, and against the port's
brute-force oracle, on the small procedural scene.

Both packages get the very same projected vertices (numpy from the JAX
geometry stage). The cell lists must be identical (same class windows,
budget and stable sort); the images must agree on >= 99.9% of pixels, and
every disagreeing pixel must be a depth tie within 1e-5 or a pixel centre
on an edge of either winner (|E|/|Esum| < 1e-5): XLA on the CPU fuses
multiply-adds that PyTorch rounds separately. Where the ids agree, depth
agrees within 1e-5, except at the few ill-conditioned pixels where the
reference's own float32 depth is off the float64 value by more than that
(see ``torch_port_scene.check_depth``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_vertices_cells as jax_cells
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.render.rasterize import geometry_stage, rasterize
from stillleben_tpu_torch.render.rasterize_tiled import (
    build_cells,
    rasterize_tiled,
    rasterize_vertices_cells,
)
from torch_port_scene import (
    H, W, build_meshes, check_depth, check_id_agreement, depth_f64, jax_template, to_numpy,
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    tpl = jax_template(meshes)
    poses, cam, light = jax_settle_scene(
        jax.random.PRNGKey(5), tpl, jax_default_config(), settle_iterations=10
    )
    nb = tpl.base_inputs.obj_to_world.shape[0]
    inputs = tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:nb].set(poses[:nb]), cam_pose=cam
    )
    geom = jax_geometry_stage(tpl.render_atlas, inputs, W, H)
    v = np.asarray(geom.pix_hom)[np.asarray(tpl.render_atlas.faces)]
    return tpl, inputs, v


def test_cells_identical_to_jax(scene):
    _, _, v = scene
    act = np.ones(v.shape[0], bool)
    ids_j, tile_j = jax_cells(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.asarray(act), W, H, 0.1, 10.0,
        big_capacity=64, min_depth=None, stop_after="cells",
    )
    vt = torch.from_numpy(v)
    _, ids_t, tile_t, *_ = build_cells(vt, vt[..., 2], torch.from_numpy(act), W, H, 0.1, 10.0, 64)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(tile_t.numpy(), np.asarray(tile_j))
    assert (ids_t >= 0).sum() > 100


def test_cell_raster_matches_jax(scene):
    _, _, v = scene
    act = np.ones(v.shape[0], bool)
    dj, tj = jax_cells(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.asarray(act), W, H, 0.1, 10.0,
        big_capacity=64, min_depth=None,
    )
    vt = torch.from_numpy(v)
    dt, tt = rasterize_vertices_cells(vt, vt[..., 2], torch.from_numpy(act), W, H, 0.1, 10.0, 64)
    dj, tj, dt, tt = np.asarray(dj), np.asarray(tj), dt.numpy(), tt.numpy()
    assert (tj >= 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tt, tj, v, v[..., 2])
    check_depth(dt, dj, depth_f64(v, v[..., 2], tj), agree & (tj >= 0))


def test_cell_raster_matches_brute_force_oracle(scene):
    tpl, inputs, _ = scene
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    pin = ptpl.base_inputs._replace(
        obj_to_world=torch.from_numpy(np.asarray(inputs.obj_to_world)),
        cam_pose=torch.from_numpy(np.asarray(inputs.cam_pose)),
    )
    geom = geometry_stage(ptpl.render_atlas, pin, W, H)
    tiled = rasterize_tiled(geom, ptpl.render_atlas, pin, W, H)
    brute = rasterize(geom, ptpl.render_atlas, pin, W, H, chunk=64)
    v = geom.pix_hom[ptpl.render_atlas.faces.long()].numpy()
    ids_t, ids_b = tiled.tri_id.numpy(), brute.tri_id.numpy()
    assert (ids_b >= 0).sum() > 100
    agree = check_id_agreement(ids_t, ids_b, v, v[..., 2])
    check_depth(tiled.depth.numpy(), brute.depth.numpy(), depth_f64(v, v[..., 2], ids_b),
                agree & (ids_b >= 0))
