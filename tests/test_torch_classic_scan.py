"""The classic raster's scan rule (``FrameConfig.classic_fine="scan"``,
``render/rasterize_tiled.py::scan_fine_stage``) against the JAX package's
XLA fine stage (``rasterize_vertices(use_pallas=False)``,
``stillleben_tpu/render/rasterize_tiled.py:670-744``), and against the
port's own fine-kernel rule.

Both packages get the same projected vertices of the CPU tests' scene at
160 x 120 (numpy from the JAX geometry stage), with and without the pixel
stage: triangle ids agree on >= 99.9% of the pixels, every mismatch a depth
tie or a pixel centre on an edge (``torch_port_scene.check_id_agreement``:
XLA's dot and torch's matmul round the three-term edge sums differently,
C-5), and depth within 1e-5 where both are within 5e-6 of float64 (the
rest, at most 3% of the hits at this size, within 1e-4 of float64). The classic shadow
pass with the scan rule is held to JAX's by the bounds of
``tests/test_torch_raster_classic.py``. Against the kernel's rule
(C-7: the lowest id within a chunk, not the first slot) every
disagreement is a tie or an edge (``test_torch_gpu.py::scan_rule_split``'s
class (a)); class (b) stays under 0.01% of the pixels. Tiles in groups
(``SCAN_STEP_ELEMENTS``) give the same result as one group, and the frame
configuration refuses the scan rule off the classic raster.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.parallel.batch import template_from_scene as jax_template_from_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_vertices as jax_rasterize_vertices
from stillleben_tpu.render.shadow import _ortho_rasterize_depth as jax_ortho_depth
from stillleben_tpu_torch.render import rasterize_tiled as rt
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.shadow import _ortho_rasterize_depth
from test_torch_gpu import scan_rule_split
from test_torch_raster_classic import shadow_depth_bounds, shadow_triangles
from torch_port_scene import build_meshes, check_depth, check_id_agreement, depth_f64

NEAR, FAR = 0.1, 10.0
SIZE = (160, 120)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The projected vertices (F, 3, 3) of the CPU tests' scene at 160 x 120."""
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    s = jsl.Scene(SIZE)
    s.seed(0)
    for mesh in meshes:
        s.add_object(jsl.Object(mesh))
    tpl = jax_template_from_scene(s)
    poses, cam, _ = jax_settle_scene(jax.random.PRNGKey(5), tpl, jax_default_config(),
                                     settle_iterations=10)
    nb = tpl.base_inputs.obj_to_world.shape[0]
    inputs = tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:nb].set(poses[:nb]), cam_pose=cam)
    geom = jax_geometry_stage(tpl.render_atlas, inputs, *SIZE)
    return np.asarray(geom.pix_hom)[np.asarray(tpl.render_atlas.faces)]


def run_port(v, pixel_stage, fine):
    vt = torch.from_numpy(v)
    d, t = rt.rasterize_vertices(vt, vt[..., 2], torch.ones(v.shape[0], dtype=torch.bool), *SIZE,
                                 NEAR, FAR, 256, 64, 128, pixel_stage, fine=fine)
    return d.numpy(), t.numpy()


@pytest.mark.parametrize("pixel_stage", [False, True])
def test_scan_rule_matches_jax(scene, pixel_stage):
    v = scene
    dj, tj = (np.asarray(x) for x in jax_rasterize_vertices(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.ones(v.shape[0], bool), *SIZE, NEAR, FAR,
        256, 64, 128, None, pixel_stage=pixel_stage, use_pallas=False))
    dp, tp = run_port(v, pixel_stage, "scan")
    assert (tj >= 0).sum() > 1000, "scene unexpectedly empty"
    agree = check_id_agreement(tp, tj, v, v[..., 2])
    # both within 5e-6 of float64, so within 1e-5 of each other; at this
    # size 68 of the 4,141 hits are beyond 5e-6 on JAX's side (its kernel
    # path's too), 58 on the port's, 97 in all (2.3%): at most 3%, within
    # 1e-4 of float64
    check_depth(dp, dj, depth_f64(v, v[..., 2], tj), agree & (tj >= 0), well_tol=5e-6,
                max_ill_frac=0.03)


def test_scan_rule_against_the_kernel_rule(scene):
    v = scene
    dk, tk = run_port(v, False, "kernel")
    ds, ts = run_port(v, False, "scan")
    a, b = scan_rule_split(tk, ts, v, v[..., 2])
    assert b.sum() <= 1e-4 * tk.size, f"pixels outside the tie and edge class: {np.argwhere(b)}"
    same = tk == ts
    assert same.mean() >= 0.999
    np.testing.assert_allclose(ds[same], dk[same], rtol=0, atol=1e-5)
    assert ((tk != ts) == (a | b)).all()


def test_tile_groups_do_not_change_the_scan(scene, monkeypatch):
    one = run_port(scene, True, "scan")
    monkeypatch.setattr(rt, "SCAN_STEP_ELEMENTS", 1)  # one tile per step
    grouped = run_port(scene, True, "scan")
    np.testing.assert_array_equal(grouped[0], one[0])
    np.testing.assert_array_equal(grouped[1], one[1])


@pytest.mark.parametrize("size,n", [(64, 200), (256, 400)])
def test_scan_shadow_depth_matches_jax(size, n):
    xy, z, faces, on = shadow_triangles(3, size, n)
    dj = np.asarray(jax_ortho_depth(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(faces), jnp.asarray(on), size,
        use_pallas=False))
    dp = _ortho_rasterize_depth(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(faces), torch.from_numpy(on),
        size, raster="classic", classic_fine="scan").numpy()
    covered = dj < 1.0
    assert covered.sum() > 0.02 * size * size, "the map is nearly empty"
    ys, xs = np.nonzero(np.abs(dp - dj) > 1e-5)
    assert len(ys) <= 0.01 * covered.sum(), f"{len(ys)} ill-conditioned pixels"
    lo, hi = shadow_depth_bounds(xy, z, faces, on, ys, xs)
    assert (hi - lo > 1e-5).all(), "a well-conditioned pixel differs by more than 1e-5"
    assert (dp[ys, xs] >= lo).all() and (dp[ys, xs] <= hi).all()


def test_frame_config_refuses_the_scan_off_the_classic_raster():
    FrameConfig(width=16, height=16, raster="classic", classic_fine="scan").check()
    with pytest.raises(ValueError, match="classic_fine"):
        FrameConfig(width=16, height=16, classic_fine="scan").check()
    with pytest.raises(ValueError, match="classic_fine"):
        FrameConfig(width=16, height=16, raster="classic", classic_fine="xla").check()
    with pytest.raises(ValueError, match="fine"):
        run_port(np.zeros((1, 3, 3), np.float32), False, "xla")
