"""The full frame of the port against the JAX package at 48x48: textures,
the background plane, the image-based light with its skybox and SSAO
(case "bench", the small version of the bench-full configuration, through
``render_with_poses``), and stickers, the anisotropic filter, the alpha peel
on the cutout texture and a background image (case "extras", through
``render_frame_core``). The template and the light map are the JAX
package's, carried across by ``convert.template_from_numpy``; poses, camera
and light come from the JAX settle.

Tolerances, as in ``test_torch_frame.py`` (ROADMAP C-5): first-pass
triangle ids by ``check_id_agreement`` (>= 99.9% equal, every mismatch a
depth tie or an on-edge pixel); instance, class and vertex-index maps differ
only where the ids do; where they agree, coordinates 1e-5, depth 1e-5 by
``check_depth``, normals 1e-5 at well-conditioned pixels and 1e-4 elsewhere
(with textures the normal goes through the normal map's neutral texel, a
renormalization more: 2e-5 and 2e-4). hdr at well-conditioned pixels
outside the VSM penumbra: within 2e-4 relative (+1e-5) on at least 99% of
them, because SSAO's occlusion compare is discontinuous (a flipped tap moves
a pixel's occlusion by up to 4%, spread over the blur's 25 taps), and no
pixel beyond 5%. The 64^2 shadow map puts nearly all of the 3 m plane into
the VSM penumbra, where the Chebyshev bound turns 1e-7 of world position
into 1e-3 of colour (``test_torch_frame.penumbra``): there 1e-2 relative.
The skybox and the background image within 1e-5 relative.
rgb within 1 LSB on >= 99.5% of the agreeing pixels, 3 LSB everywhere.
Pixels that the alpha peel replaced show a surface behind the cutout:
deeper than the first pass's winner, ground truth within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_frame as plain_frame
from stillleben_tpu.parallel.batch import render_with_poses as jax_render
from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu.render.frame import render_frame_core as jax_render_frame_core
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_tiled as jax_rasterize_tiled
from stillleben_tpu.render.shadow import render_shadow_maps as jax_shadow_maps
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.parallel.batch import render_with_poses
from stillleben_tpu_torch.render.atlas import has_cutout_materials
from stillleben_tpu_torch.render.frame import FrameConfig, render_frame_core
from stillleben_tpu_torch.render.rasterize import geometry_stage
from stillleben_tpu_torch.render.rasterize_tiled import rasterize_tiled
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_full_meshes, check_depth, check_id_agreement, depth_f64,
    jax_full_template, jax_light_map, to_numpy, well_conditioned,
)

COMMON = dict(width=W, height=H, shading="pbr", ssao=True, max_lights=1,
              shadow_size=SHADOW_SIZE, shadow_mode="vsm", sample_textures=True)
CASES = {
    "bench": dict(COMMON, sample_stickers=False, texture_filter="trilinear", ssao_mode="fast"),
    "extras": dict(COMMON, sample_stickers=True, texture_filter="aniso", ssao_mode="fast",
                   alpha_peel=True),
}


@pytest.fixture(scope="module")
def light_map():
    return jax_light_map()


def numpy_frame(f):
    return type(f)(*(x.to(torch.int32).numpy() if x.dtype == torch.uint16 else x.numpy()
                     for x in f))


def make_full_frames(tmp_path_factory, light_map, case, raster="cells"):
    """Both packages' frames of one settled full scene, with what the
    checks need (the layout of ``test_torch_frame.make_frames``, plus the
    port's first-pass frame for the peel)."""
    kw = CASES[case]
    jax_cfg = JaxFrameConfig(shading_dtype="f32", use_pallas=True if raster == "classic" else None,
                             **kw)
    cfg = FrameConfig(raster=raster, **kw)
    cube, sphere, blob, cutout = build_full_meshes(str(tmp_path_factory.mktemp("meshes")),
                                                   native_decomp=False)
    extras = case == "extras"
    meshes = (cutout, sphere, blob) if extras else (cube, sphere, blob)
    tpl = jax_full_template(meshes, light_map, stickers=extras, overrides=not extras)
    poses, cam, light = jax_settle_scene(
        jax.random.PRNGKey(3), tpl, jax_default_config(), settle_iterations=10
    )
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    assert ptpl.light_map is not None and ptpl.render_atlas.num_objects == 4
    assert has_cutout_materials(ptpl.render_atlas) == extras
    pposes, pcam, plight = (torch.from_numpy(np.array(x)) for x in (poses, cam, light))

    nb = poses.shape[0]
    jin = tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:nb].set(poses), cam_pose=cam,
        light_directions=tpl.base_inputs.light_directions.at[0].set(light),
    )
    pin = ptpl.base_inputs._replace(
        obj_to_world=torch.from_numpy(np.array(jin.obj_to_world)), cam_pose=pcam,
        light_directions=torch.from_numpy(np.array(jin.light_directions)),
    )
    bg = None
    if extras:  # a seeded background image, straight into render_frame_core
        bg = np.random.default_rng(9).random((H, W, 4)).astype(np.float32)
        fj = to_numpy(jax_render_frame_core(tpl.render_atlas, jin, jax_cfg,
                                            background_image=jnp.asarray(bg),
                                            light_map=tpl.light_map))
        fp = render_frame_core(ptpl.render_atlas, pin, cfg, background_image=torch.from_numpy(bg),
                               light_map=ptpl.light_map)
        first = render_frame_core(ptpl.render_atlas, pin, cfg._replace(alpha_peel=False),
                                  light_map=ptpl.light_map)
    else:
        fj = to_numpy(jax_render(tpl, poses, cam, jax_cfg, light))
        fp = first = render_with_poses(ptpl, pposes, pcam, cfg, plight)
    fp, first = numpy_frame(fp), numpy_frame(first)

    jgeom = jax_geometry_stage(tpl.render_atlas, jin, W, H)
    tri_j = np.asarray(jax_rasterize_tiled(
        jgeom, tpl.render_atlas, jin, W, H, use_pallas=jax_cfg.use_pallas).tri_id)
    pgeom = geometry_stage(ptpl.render_atlas, pin, W, H)
    tri_p = rasterize_tiled(pgeom, ptpl.render_atlas, pin, W, H, raster=raster).tri_id.numpy()
    v = np.asarray(jgeom.pix_hom)[np.asarray(tpl.render_atlas.faces)]
    peeled = (tri_p >= 0) & ~first.valid  # the first pass's winner failed the cutoff
    well = well_conditioned(fj.barycentric_coeffs, fp.barycentric_coeffs, tri_j, v) & ~peeled
    shadow_j = to_numpy(jax_shadow_maps(tpl.render_atlas, jin, jgeom, jax_cfg))
    pen = plain_frame.penumbra(fj, shadow_j, np.asarray(cam))
    return dict(fj=fj, fp=fp, first=first, tri_j=tri_j, tri_p=tri_p, v=v, well=well, pen=pen,
                peeled=peeled, bg=bg, cfg=cfg)


@pytest.fixture(scope="module", params=["bench", "extras"])
def frames(request, tmp_path_factory, light_map):
    return make_full_frames(tmp_path_factory, light_map, request.param)


def test_full_frame_ids_match_jax(frames):
    fj, fp, tri_j, tri_p, v = (frames[k] for k in ("fj", "fp", "tri_j", "tri_p", "v"))
    assert (fj.instance_index > 0).sum() > 100, "scene unexpectedly empty"
    plane = fj.valid & (fj.instance_index == 0)
    assert plane.sum() > 100 and (fj.class_index[plane] == 0).all(), "no background plane in view"
    np.testing.assert_array_equal(fp.valid & (fp.instance_index == 0), plane)
    agree = check_id_agreement(tri_p, tri_j, v, v[..., 2])
    for name in ("instance_index", "class_index", "vertex_indices"):
        diff = (getattr(fp, name) != getattr(fj, name)).reshape(H, W, -1).any(-1)
        assert not (diff & agree).any(), f"{name} differs where the triangle ids agree"
    assert (fp.vertex_indices[plane] == 0).all()


def test_full_frame_geometry_buffers_match_jax(frames):
    fj, fp, tri_j, tri_p, v, well, peeled = (
        frames[k] for k in ("fj", "fp", "tri_j", "tri_p", "v", "well", "peeled"))
    agree = (tri_p == tri_j)
    hit = agree & (tri_j >= 0) & ~peeled
    np.testing.assert_array_equal(fp.valid, fj.valid)
    check_depth(fp.depth, fj.depth, depth_f64(v, v[..., 2], tri_j), hit)
    assert (hit & well).sum() >= 0.4 * hit.sum(), "too few well-conditioned pixels"
    for name in ("object_coordinates", "cam_coordinates"):
        np.testing.assert_allclose(getattr(fp, name)[agree & ~peeled],
                                   getattr(fj, name)[agree & ~peeled], rtol=0, atol=1e-5,
                                   err_msg=name)
    calm = agree & ~peeled & (well | (tri_j < 0))
    np.testing.assert_allclose(fp.normals[calm], fj.normals[calm], rtol=0, atol=2e-5)
    np.testing.assert_allclose(fp.normals[hit & ~well], fj.normals[hit & ~well], rtol=0, atol=2e-4)


def test_full_frame_colour_matches_jax(frames):
    fj, fp, tri_j, tri_p, well, pen, peeled, bg = (
        frames[k] for k in ("fj", "fp", "tri_j", "tri_p", "well", "pen", "peeled", "bg"))
    agree = tri_p == tri_j
    hit = agree & fj.valid & ~peeled
    calm = hit & well & ~pen
    # the plane is most of the frame and nearly all of it is penumbra
    assert calm.sum() >= 0.05 * hit.sum(), "too few pixels outside the penumbra"
    err = np.abs(fp.hdr - fj.hdr)
    far = (err > 2e-4 * np.abs(fj.hdr) + 1e-5).any(-1)
    assert far[calm].mean() <= 0.01, f"{far[calm].mean():.4f} of calm pixels beyond 2e-4"
    assert (err[calm] <= 0.05 * np.abs(fj.hdr[calm]) + 1e-4).all()
    shade = hit & well & pen
    np.testing.assert_allclose(fp.hdr[shade], fj.hdr[shade], rtol=1e-2, atol=1e-4)
    # background: the image where one was given, else the skybox; alpha 1
    back = agree & ~fj.valid
    assert back.sum() > 20, "no background in view"
    np.testing.assert_allclose(fp.hdr[back], fj.hdr[back], rtol=1e-5, atol=1e-6)
    assert (fp.hdr[back][:, 3] == 1).all()  # opaque behind the objects
    if bg is not None:
        np.testing.assert_array_equal(fp.hdr[back][:, :3], bg[back][:, :3])
    d = np.abs(fp.rgb.astype(np.int32) - fj.rgb.astype(np.int32)).max(-1)
    assert (d[agree] <= 1).mean() >= 0.995 and d[agree].max() <= 3


def test_full_frame_peel(frames):
    """Where the first pass's winner failed the alpha cutoff, the peeled
    frame shows the surface behind it, as in the JAX package."""
    fj, fp, first, peeled, cfg, tri_p, v = (
        frames[k] for k in ("fj", "fp", "first", "peeled", "cfg", "tri_p", "v"))
    if not cfg.alpha_peel:
        assert not peeled.any()  # an opaque scene discards nothing
        return
    assert peeled.sum() >= 10, "the cutout texture discarded nothing in view"
    assert not first.valid[peeled].any()
    shown = peeled & fp.valid
    assert shown.sum() >= 0.9 * peeled.sum()
    np.testing.assert_array_equal(fp.valid[peeled], fj.valid[peeled])
    same = shown & (fp.vertex_indices == fj.vertex_indices).all(-1)
    assert same.sum() >= 0.98 * shown.sum()
    for name in ("object_coordinates", "cam_coordinates", "normals", "depth"):
        np.testing.assert_allclose(getattr(fp, name)[same], getattr(fj, name)[same],
                                   rtol=0, atol=1e-4, err_msg=name)
    # behind the cutout: deeper than the first pass's winner at that pixel
    assert (fp.depth[shown] > depth_f64(v, v[..., 2], tri_p)[shown] + 1e-5).all()
