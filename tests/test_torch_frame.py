"""A whole PBR frame of the port against the JAX package: the same template
(carried across by ``convert.template_from_numpy``), the same settled poses,
camera and light, rendered by both ``render_with_poses``.

Tolerances: triangle ids follow the raster rule (>= 99.9% equal, every
mismatch a depth tie or an on-edge pixel), and the instance, class and
vertex-index maps may differ only where the triangle ids do. Where the ids
agree: object and camera coordinates within 1e-5 absolute; depth within
1e-5 by the ill-conditioned-pixel rule of ``torch_port_scene.check_depth``;
normals within 1e-5 where both packages' barycentrics are well-conditioned
(within 1e-5 of float64) and 1e-4 elsewhere; hdr within 1e-4 relative at
well-conditioned pixels outside the VSM penumbra; rgb within 1 LSB at every
pixel. The VSM moments of the 64^2 shadow pass within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from stillleben_tpu.parallel.batch import render_with_poses as jax_render
from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_tiled as jax_rasterize_tiled
from stillleben_tpu.render.shadow import render_shadow_maps as jax_shadow_maps
from stillleben_tpu.render.shadow import shadow_factor_vsm_planar as jax_shadow_factor
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.parallel.batch import render_with_poses
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.rasterize import geometry_stage
from stillleben_tpu_torch.render.rasterize_tiled import rasterize_tiled
from stillleben_tpu_torch.render.shadow import render_shadow_maps
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_meshes, check_depth, check_id_agreement, depth_f64,
    jax_template, to_numpy, well_conditioned,
)

JAX_CFG = JaxFrameConfig(
    width=W, height=H, shading="pbr", ssao=False, max_lights=1, shadow_size=SHADOW_SIZE,
    shadow_mode="vsm", sample_textures=False, sample_stickers=False, alpha_peel=False,
    shading_dtype="f32",
)
CFG = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                  sample_textures=False, sample_stickers=False)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return make_frames(tmp_path_factory, "cells")


def make_frames(tmp_path_factory, raster):
    """Both packages' frames of one settled scene through ``raster``, with
    what the checks need. The JAX package takes the classic path from
    ``SL_RASTER=classic``, which the caller sets, with its Pallas kernel
    in interpret mode, whose tie rule the port follows."""
    jax_cfg = JAX_CFG if raster == "cells" else JAX_CFG._replace(use_pallas=True)
    cfg = CFG._replace(raster=raster)
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    rng = np.random.default_rng(7)
    mr = [(float(rng.random()), float(rng.random())) for _ in meshes]
    tpl = jax_template(meshes, metallic_roughness=mr)
    poses, cam, light = jax_settle_scene(
        jax.random.PRNGKey(3), tpl, jax_default_config(), settle_iterations=10
    )
    fj = to_numpy(jax_render(tpl, poses, cam, jax_cfg, light))
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    pposes, pcam, plight = (torch.from_numpy(np.array(x)) for x in (poses, cam, light))
    fp = render_with_poses(ptpl, pposes, pcam, cfg, plight)
    fp = type(fp)(*(x.to(torch.int32).numpy() if x.dtype == torch.uint16 else x.numpy() for x in fp))

    # both packages' inputs of this frame and their triangle-id images
    nb = tpl.base_inputs.obj_to_world.shape[0]
    jin = tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:nb].set(poses[:nb]), cam_pose=cam,
        light_directions=tpl.base_inputs.light_directions.at[0].set(light),
    )
    jgeom = jax_geometry_stage(tpl.render_atlas, jin, W, H)
    tri_j = np.asarray(jax_rasterize_tiled(
        jgeom, tpl.render_atlas, jin, W, H, use_pallas=jax_cfg.use_pallas,
    ).tri_id)
    pin = ptpl.base_inputs._replace(
        obj_to_world=torch.from_numpy(np.asarray(jin.obj_to_world)), cam_pose=pcam,
        light_directions=torch.from_numpy(np.asarray(jin.light_directions)),
    )
    pgeom = geometry_stage(ptpl.render_atlas, pin, W, H)
    tri_p = rasterize_tiled(pgeom, ptpl.render_atlas, pin, W, H, raster=raster).tri_id.numpy()
    v = np.asarray(jgeom.pix_hom)[np.asarray(tpl.render_atlas.faces)]
    shadows = (
        to_numpy(jax_shadow_maps(tpl.render_atlas, jin, jgeom, jax_cfg)),
        [x.numpy() for x in render_shadow_maps(ptpl.render_atlas, pin, SHADOW_SIZE, 1, raster)],
    )
    well = well_conditioned(fj.barycentric_coeffs, fp.barycentric_coeffs, tri_j, v)
    pen = penumbra(fj, shadows[0], np.asarray(cam))
    return fj, fp, tri_j, tri_p, v, shadows, well, pen


def penumbra(fj, shadow_j, cam_pose):
    """Pixels in the VSM penumbra of the JAX frame (shadow factor strictly
    between 0 and 1): the Chebyshev bound there turns 1e-7 differences of
    the world position into relative colour changes of 1e-3."""
    maps, mats = shadow_j
    cam = fj.cam_coordinates[..., :3].reshape(-1, 3).T.astype(np.float64)
    world = (cam_pose[:3, :3] @ cam + cam_pose[:3, 3:4]).reshape(3, H, W)
    sf = np.asarray(jax_shadow_factor(maps, mats, 0, world.astype(np.float32)))
    return (sf > 1e-3) & (sf < 1 - 1e-3)


def test_frame_ids_match_jax(frames):
    fj, fp, tri_j, tri_p, v, *_ = frames
    assert (fj.instance_index > 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tri_p, tri_j, v, v[..., 2])
    for name in ("instance_index", "class_index", "vertex_indices"):
        a, b = getattr(fp, name), getattr(fj, name)
        diff = (a != b).reshape(H, W, -1).any(-1)
        assert not (diff & agree).any(), f"{name} differs where the triangle ids agree"
    assert fp.rgb.dtype == np.uint8 and fp.vertex_indices.dtype == np.int32


def test_frame_geometry_buffers_match_jax(frames):
    fj, fp, tri_j, tri_p, v, _, well, _ = frames
    agree = tri_p == tri_j
    hit = agree & (tri_j >= 0)
    np.testing.assert_array_equal(fp.valid, fj.valid)
    check_depth(fp.depth, fj.depth, depth_f64(v, v[..., 2], tri_j), hit)
    assert (hit & well).sum() >= 0.4 * hit.sum(), "too few well-conditioned pixels"
    for name in ("object_coordinates", "cam_coordinates"):
        np.testing.assert_allclose(
            getattr(fp, name)[agree], getattr(fj, name)[agree], rtol=0, atol=1e-5, err_msg=name
        )
    # normals interpolate per-vertex normals with the barycentrics: 1e-5
    # where those are well-conditioned, 1e-4 where they are not
    np.testing.assert_allclose(fp.normals[agree & (well | ~hit)], fj.normals[agree & (well | ~hit)],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(fp.normals[hit & ~well], fj.normals[hit & ~well], rtol=0, atol=1e-4)


def test_frame_colour_matches_jax(frames):
    fj, fp, tri_j, tri_p, _, _, well, pen = frames
    agree = tri_p == tri_j
    hit = agree & (tri_j >= 0)
    calm = agree & ((well & ~pen) | (tri_j < 0))
    assert (hit & calm).sum() >= 0.3 * hit.sum(), "too few pixels outside penumbra"
    np.testing.assert_allclose(fp.hdr[calm], fj.hdr[calm], rtol=1e-4, atol=1e-6)
    d = np.abs(fp.rgb.astype(np.int32) - fj.rgb.astype(np.int32))
    assert d[agree].max() <= 1


def test_shadow_moments_match_jax(frames):
    ((maps_j, mats_j), (maps_p, mats_p)) = frames[5]
    assert maps_p.shape == maps_j.shape == (1, SHADOW_SIZE, SHADOW_SIZE, 2)
    assert (maps_j[..., 0] < 0.999).mean() > 0.02, "shadow map unexpectedly empty"
    np.testing.assert_allclose(mats_p, mats_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(maps_p, maps_j, rtol=0, atol=1e-5)
