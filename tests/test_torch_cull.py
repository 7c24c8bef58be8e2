"""The port's facing culls against the JAX package: the camera pass's
back-face cull (``FrameConfig.backface_cull``, the JAX package's
``SL_BACKFACE_CULL=1``) and the shadow pass's front-face cull
(``shadow_cull``, ``SL_SHADOW_CULL=1``), through the cell and the classic
raster.

The JAX package reads its environment variables when it traces, so its
side runs eagerly here with the variables set. Triangle ids follow the
raster rule (``torch_port_scene.check_id_agreement``), depths the
ill-conditioned-pixel rules of ``tests/test_torch_raster_classic.py``. The
cell lists under the cull are identical to the JAX package's, also where
the windows shrunk by the cull bind and drop triangles. The cull leaves
the faces of open meshes (the sphere's, here) alone, and on closed meshes
the culled frame equals the unculled one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import rasterize_tiled as jrt
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.shadow import _ortho_rasterize_depth as jax_ortho_depth
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.parallel.batch import render_with_poses
from stillleben_tpu_torch.render import rasterize_tiled as rt
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.shadow import _ortho_rasterize_depth
from test_torch_raster_classic import shadow_depth_bounds, shadow_triangles
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_meshes, check_depth, check_frame_pair, check_id_agreement,
    depth_f64, frame_inputs, jax_template, render_pair, settled_scene, to_numpy, vsm_penumbra,
)

NEAR, FAR = 0.1, 10.0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    tpl = jax_template(meshes)
    poses, cam, light = settled_scene(tpl, key=5)
    jin = frame_inputs(tpl, poses, cam, light)
    geom = jax_geometry_stage(tpl.render_atlas, jin, W, H)
    v = np.asarray(geom.pix_hom)[np.asarray(tpl.render_atlas.faces)]
    cull = np.asarray(tpl.render_atlas.face_cullable)
    # the cube and the blob are closed; the sphere's open seam keeps its faces
    assert cull.any() and not cull.all(), "expected a mixed cull mask"
    return tpl, template_from_numpy(to_numpy(tpl), "cpu"), poses, cam, light, v, cull


def _jax_raster(v, cull, raster, pixel_stage, sign=-1):
    act = jnp.ones(v.shape[0], bool)
    kw = dict(cull_sign=sign, cull_mask=jnp.asarray(cull))
    if raster == "cells":
        return jrt.rasterize_vertices_cells(jnp.asarray(v), jnp.asarray(v[..., 2]), act, W, H,
                                            NEAR, FAR, 64, None, **kw)
    return jrt.rasterize_vertices(jnp.asarray(v), jnp.asarray(v[..., 2]), act, W, H, NEAR, FAR,
                                  256, 64, 128, None, pixel_stage=pixel_stage, use_pallas=True,
                                  **kw)


def _port_raster(v, cull, raster, pixel_stage, sign=-1):
    vt = torch.from_numpy(v)
    act = torch.ones(v.shape[0], dtype=torch.bool)
    kw = dict(cull_sign=sign, cull_mask=torch.from_numpy(cull))
    if raster == "cells":
        return rt.rasterize_vertices_cells(vt, vt[..., 2], act, W, H, NEAR, FAR, 64, **kw)
    return rt.rasterize_vertices(vt, vt[..., 2], act, W, H, NEAR, FAR, 256, 64, 128,
                                 pixel_stage, **kw)


@pytest.mark.parametrize("raster,pixel_stage", [("cells", None), ("classic", False),
                                                ("classic", True)])
def test_camera_cull_matches_jax(scene, monkeypatch, raster, pixel_stage):
    *_, v, cull = scene
    monkeypatch.setenv("SL_RASTER", raster)
    dj, tj = (np.asarray(x) for x in _jax_raster(v, cull, raster, pixel_stage))
    dp, tp = (x.numpy() for x in _port_raster(v, cull, raster, pixel_stage))
    assert (tj >= 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tp, tj, v, v[..., 2])
    check_depth(dp, dj, depth_f64(v, v[..., 2], tj), agree & (tj >= 0), well_tol=5e-6,
                max_ill_frac=0.02)
    # what the cull keeps: faces turned to the camera (det < 0), and the
    # faces of open meshes
    det = np.einsum("fi,fi->f", v[:, 0].astype(np.float64),
                    np.cross(v[:, 1], v[:, 2]).astype(np.float64))
    won = tp[tp >= 0]
    assert ((det[won] < 0) | ~cull[won]).all() and cull[won].any()


def test_cell_lists_under_the_cull_identical_to_jax(scene):
    *_, v, cull = scene
    vt = torch.from_numpy(v)
    act = torch.ones(v.shape[0], dtype=torch.bool)
    ids_j, tile_j = jrt.rasterize_vertices_cells(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.ones(v.shape[0], bool), W, H, NEAR, FAR, 64,
        None, stop_after="cells", cull_sign=-1, cull_mask=jnp.asarray(cull))
    _, ids, cell_tile, *_ = rt.build_cells(vt, vt[..., 2], act, W, H, NEAR, FAR, 64, cull_sign=-1,
                                           cull_mask=torch.from_numpy(cull))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(cell_tile.numpy(), np.asarray(tile_j))
    _, ids0, *_ = rt.build_cells(vt, vt[..., 2], act, W, H, NEAR, FAR, 64)
    assert 0 < (ids >= 0).sum() < 0.8 * (ids0 >= 0).sum(), "the cull kept most pairs"


def _facing_triangles(n, size, seed=0):
    """``n`` camera-facing triangles (det < 0) about 8 px across, each
    centred on a corner of the 16-px tile grid of a size^2 viewport, so that
    each spans 2 x 2 tiles; homogeneous (u w, v w, w), w in [1, 5]."""
    rng = np.random.default_rng(seed)
    g = size // 16
    corner = rng.integers(1, g, (n, 1, 2)) * 16.0
    p = corner + rng.uniform(-4.0, 4.0, (n, 3, 2))
    w = rng.uniform(1.0, 5.0, (n, 1, 1)) + rng.uniform(0.0, 0.1, (n, 3, 1))
    v = np.concatenate([p * w, w], -1)
    det = np.einsum("fi,fi->f", v[:, 0], np.cross(v[:, 1], v[:, 2]))
    v[det > 0] = v[det > 0][:, [0, 2, 1]]
    return v.astype(np.float32)


def test_shrunk_windows_bind_as_in_jax():
    """36,000 faces, all facing the camera and cullable, all spanning 2 x 2
    tiles: the cull removes none, but its windows hold 21,845 of them
    (2,048 more in the wider window) where the uncut ones hold 32,768, and
    the cell budget shrinks to 5/4 pair entries per face. The cell lists
    are identical to JAX's and drop triangles that the uncut lists keep."""
    size = 256
    v = _facing_triangles(36000, size)
    F = v.shape[0]
    vt = torch.from_numpy(v)
    act = torch.ones(F, dtype=torch.bool)
    mask = np.ones(F, bool)
    ids_j, tile_j = jrt.rasterize_vertices_cells(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.ones(F, bool), size, size, NEAR, FAR, 64,
        None, stop_after="cells", cull_sign=-1, cull_mask=jnp.asarray(mask))
    _, ids, cell_tile, *_ = rt.build_cells(vt, vt[..., 2], act, size, size, NEAR, FAR, 64,
                                           cull_sign=-1, cull_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(cell_tile.numpy(), np.asarray(tile_j))
    _, ids0, *_ = rt.build_cells(vt, vt[..., 2], act, size, size, NEAR, FAR, 64)
    kept, kept0 = (np.unique(x[x >= 0]).size for x in (ids.numpy(), ids0.numpy()))
    assert kept < kept0 < F, f"the shrunk windows keep {kept}, the uncut ones {kept0} of {F}"


@pytest.mark.parametrize("raster", ["cells", "classic"])
def test_shadow_cull_matches_jax(monkeypatch, raster):
    size = 64
    xy, z, faces, on = shadow_triangles(3, size, 200)
    cullable = np.random.default_rng(4).random(faces.shape[0]) < 0.7
    monkeypatch.setenv("SL_RASTER", raster)
    monkeypatch.setenv("SL_SHADOW_CULL", "1")
    dj = np.asarray(jax_ortho_depth(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(faces), jnp.asarray(on), size,
        use_pallas=True, tri_cullable=jnp.asarray(cullable),
    ))
    args = (torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(faces),
            torch.from_numpy(on), size, raster)
    dp = _ortho_rasterize_depth(*args, tri_cullable=torch.from_numpy(cullable)).numpy()
    two_sided = _ortho_rasterize_depth(*args).numpy()
    assert (dp != two_sided).mean() > 0.01, "the cull changed nothing"
    # the faces that stay: not cullable, or turned away from the light
    p = np.concatenate([xy, np.ones_like(xy[:, :1])], 1)[faces].astype(np.float64)
    det = np.einsum("fi,fi->f", p[:, 0], np.cross(p[:, 1], p[:, 2]))
    kept = on & (~cullable | (det > 0))
    covered = dj < 1.0
    assert covered.sum() > 0.02 * size * size, "the map is nearly empty"
    ys, xs = np.nonzero(np.abs(dp - dj) > 1e-5)
    assert len(ys) <= 0.01 * covered.sum(), f"{len(ys)} ill-conditioned pixels"
    lo, hi = shadow_depth_bounds(xy, z, faces, kept, ys, xs)
    assert (hi - lo > 1e-5).all(), "a well-conditioned pixel differs by more than 1e-5"
    assert (dp[ys, xs] >= lo).all() and (dp[ys, xs] <= hi).all()


@pytest.mark.parametrize("raster", ["cells", "classic"])
def test_frame_with_both_culls_matches_jax(scene, monkeypatch, raster):
    tpl, ptpl, poses, cam, light, *_ = scene
    monkeypatch.setenv("SL_RASTER", raster)
    monkeypatch.setenv("SL_BACKFACE_CULL", "1")
    monkeypatch.setenv("SL_SHADOW_CULL", "1")
    jcfg = JaxFrameConfig(
        width=W, height=H, shading="pbr", ssao=False, max_lights=1, shadow_size=SHADOW_SIZE,
        shadow_mode="vsm", sample_textures=False, sample_stickers=False, alpha_peel=False,
        shading_dtype="f32", use_pallas=True if raster == "classic" else None,
    )
    cfg = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                      sample_textures=False, sample_stickers=False, raster=raster,
                      backface_cull=True, shadow_cull=True)
    fj, fp, tri_j, tri_p, v = render_pair(tpl, ptpl, poses, cam, light, jcfg, cfg)
    # the shadow cull moves the stored depth to the casters' far sides, so
    # more of the lit surfaces fall in the VSM penumbra: 29% of the hit
    # pixels stay outside it (measured, classic; 35% with cells)
    check_frame_pair(fj, fp, tri_j, tri_p, v, ~vsm_penumbra(fj, tpl, poses, cam, light, jcfg),
                     min_quiet=0.2)


# the classic raster at 160x120: at 48x48 its 256-slot tile lists drop the
# farthest triangles, and the cull changes which (18 pixels, measured)
@pytest.mark.parametrize("raster,size", [("cells", (W, H)), ("classic", (160, 120))])
def test_backface_cull_leaves_closed_meshes_unchanged(scene, raster, size):
    _, ptpl, poses, cam, light, *_ = scene
    cfg = FrameConfig(width=size[0], height=size[1], max_lights=1, shadow_size=SHADOW_SIZE,
                      ssao=False, sample_textures=False, sample_stickers=False, raster=raster)
    args = [torch.from_numpy(np.array(x)) for x in (poses, cam)]
    a = render_with_poses(ptpl, *args, cfg, torch.from_numpy(np.array(light)))
    b = render_with_poses(ptpl, *args, cfg._replace(backface_cull=True),
                          torch.from_numpy(np.array(light)))
    assert a.valid.sum() > 100
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
