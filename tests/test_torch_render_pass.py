"""``RenderPass.render`` of the port against the JAX package's on the CPU,
on the same scene state at 160x120: three objects (a cube, a sphere and the
textured blob, with metallic/roughness overrides), the 3 x 3 m checker
plane, the sky light map with its sun, and a lit scene light.

Covered: the light map's sun merged into the free slot 1 (so
``max_lights`` = 2, two shadow passes), the ``tile_capacity`` pick from the
face density (512 at 160x120, 256 at 320x240), visibility by
``predicate``, ``depth_peel`` behind a first result, ``supersample=2`` with
a background image resized to the 320x240 render, every accessor's shape
and dtype, and the frame configuration each package chose.

Tolerances (``test_torch_frame_full.py``, ROADMAP C-5): triangle ids by
``check_id_agreement``; instance, class and vertex-index maps equal where
the ids agree; depth 1e-5 by ``check_depth`` (well-conditioned where both
are within 5e-6 of the float64 depth: the far plane's depths reach 2.7 m);
where the ids agree, coordinates 1e-5 and normals 2e-5 at well-conditioned
pixels; where the barycentrics are ill-conditioned coordinates 1e-4, and
normals 1e-3 on >= 98% of those pixels and 5e-3 everywhere (the blob's
normal map turns an error of the texture coordinate into texel steps). hdr
at well-conditioned pixels outside the VSM penumbra within 2e-4 relative
on >= 99% of them and 5% everywhere (SSAO's discontinuous compare), 1e-2
relative in the penumbra; the skybox and the background image 1e-5
relative; rgb within 1 LSB on >= 99.5% of the agreeing pixels, 3 where
the hdr is within 2e-4 outside the penumbra, and 13 (5%) everywhere. The peel's pixels where a winner's depth
ties the floor's test (within 1e-4, check_depth's float64 bound) may
differ, at most 1% of the pixels the first pass covered; its depths are
ill-conditioned on up to 2% of its pixels (1% elsewhere) and its calm hdr
beyond 2e-4 on up to 5% (1% elsewhere). The supersampled
frame is held at its centre samples (ids on >= 99.5% of the 320x240 pixels, each mismatch a tie or on an edge; the
index maps and coordinates as above) and by the same rgb rule after the
box filter (99%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
from stillleben_tpu.core import math as jm
from stillleben_tpu.render import render_pass as jrp_mod
from stillleben_tpu.render.atlas import render_inputs_from_scene as jax_render_inputs
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_tiled as jax_rasterize_tiled
from stillleben_tpu.render.shadow import render_shadow_maps as jax_shadow_maps
from stillleben_tpu.render.shadow import shadow_factor_vsm_planar as jax_shadow_factor
from stillleben_tpu_torch.assets.procedural import checker_texture
from stillleben_tpu_torch.assets.texture import Texture, Texture2D
from stillleben_tpu_torch.convert import light_map_from_numpy
from stillleben_tpu_torch.render import render_pass as prp_mod
from stillleben_tpu_torch.render.light_map import LightMap
from stillleben_tpu_torch.render.rasterize import geometry_stage
from stillleben_tpu_torch.render.rasterize_tiled import rasterize_tiled
from torch_port_scene import (
    build_full_meshes, check_depth, check_id_agreement, depth_f64, edge_values, fill_full_scene,
    jax_light_map, to_numpy, well_conditioned,
)

W, H = 160, 120
ACCESSORS = {  # name: (trailing shape, dtype)
    "rgb": ((4,), torch.uint8), "class_index": ((), torch.uint16),
    "instance_index": ((), torch.uint16), "coordinates": ((3,), torch.float32),
    "depth": ((), torch.float32), "coordDepth": ((4,), torch.float32),
    "normals": ((4,), torch.float32), "vertex_indices": ((3,), torch.int32),
    "barycentric_coeffs": ((3,), torch.float32), "cam_coordinates": ((4,), torch.float32),
}
CFG_FIELDS = ("width", "height", "shading", "ssao", "ssao_mode", "tile_capacity",
              "sample_textures", "sample_stickers", "shadow_mode", "texture_filter",
              "alpha_peel", "max_lights", "shadow_size")


def _poses():
    out = []
    for (x, y, ang), z in zip(((-0.15, 0.02, 0.3), (0.12, 0.06, 1.1), (0.0, -0.12, 2.0)),
                              (0.0722, 0.15, 0.09)):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(jm.rotation_z(jnp.float32(ang)))
        T[:3, 3] = (x, y, z)
        out.append(T)
    return out


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same scene in both packages, with one light map's data."""
    sl.init(device="cpu")
    d = str(tmp_path_factory.mktemp("meshes"))
    jmeshes = build_full_meshes(d, native_decomp=False)[:3]
    pmeshes = build_full_meshes(d, port=True, native_decomp=False)[:3]
    jlm = jax_light_map()
    plm = LightMap()
    plm.path, plm.light_directions, plm.light_colors = jlm.path, jlm.light_directions, jlm.light_colors
    plm.data = light_map_from_numpy(to_numpy(jlm.data), "cpu")
    js = fill_full_scene(jsl.Scene((W, H)), jmeshes, jsl.Object, jsl.Texture, jsl.Texture2D, jlm)
    ps = fill_full_scene(sl.Scene((W, H)), pmeshes, sl.Object, Texture, Texture2D, plm)
    cam = np.asarray(jm.look_at(jnp.array([0.55, -0.45, 0.42]), jnp.array([0.0, 0.0, 0.12]),
                                jnp.array([0.0, 0.0, 1.0])))
    for scene in (js, ps):
        scene.set_camera_projection(js.projection_matrix())
        scene.set_camera_pose(cam)
        scene.light_directions = np.array([[-0.4, 0.3, -0.85]], np.float32)
        scene.light_colors = np.array([[2.5, 2.4, 2.2]], np.float32)
        for o, T in zip(scene.objects, _poses()):
            o.set_pose(T)
    bg = np.random.default_rng(4).integers(0, 256, size=(70, 100, 4), dtype=np.uint8)
    return js, ps, jsl.Texture(bg), Texture(bg)


def _render(js, ps, rps, **kw):
    """Both packages' ``RenderPass.render`` with the configuration each
    chose; ``kw`` may name a result pair for ``depth_peel``."""
    cfgs = {}

    def spy(mod, name, key):
        original = getattr(mod, name)

        def wrapped(atlas, inputs, cfg, **kwargs):
            cfgs[key] = cfg
            return original(atlas, inputs, cfg, **kwargs)
        return wrapped

    peel = kw.pop("depth_peel", (None, None))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrp_mod, "render_frame", spy(jrp_mod, "render_frame", "jax"))
        mp.setattr(prp_mod, "render_frame_core", spy(prp_mod, "render_frame_core", "port"))
        rj = rps[0].render(js, depth_peel=peel[0], **kw)
        rp = rps[1].render(ps, depth_peel=peel[1], **kw)
    return rj, rp, cfgs


def _numpy(f):
    return type(f)(*(x.to(torch.int32).numpy() if x.dtype == torch.uint16 else x.numpy()
                     for x in f))


def _tri_ids(js, ps, rps, cfg, visible=None, min_depth=None):
    """Both packages' camera-raster triangle ids at the render's size, the
    projected vertices (F, 3, 3) and the JAX inputs with the merged lights.
    ``min_depth``: each package's (JAX, port) depth-peel floor."""
    jatlas, patlas = rps[0]._atlas, rps[1]._atlas
    jin = jax_render_inputs(js, jatlas)
    lights = np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32)
    lights[0][:2] = [js.light_directions[0], js.light_map.light_directions[0]]
    lights[1][:2] = [js.light_colors[0], js.light_map.light_colors[0]]
    jin = jin._replace(light_directions=jnp.asarray(lights[0]), light_colors=jnp.asarray(lights[1]))
    pin = prp_mod.render_inputs_from_scene(ps, patlas, "cpu")
    if visible is not None:
        jin = jin._replace(obj_visible=jnp.asarray(visible))
        pin = pin._replace(obj_visible=torch.from_numpy(visible))
    w, h = cfg.width, cfg.height
    jgeom = jax_geometry_stage(jatlas, jin, w, h)
    md = None if min_depth is None else jnp.asarray(min_depth[0])
    tri_j = np.asarray(jax_rasterize_tiled(jgeom, jatlas, jin, w, h, min_depth=md).tri_id)
    pmd = None if min_depth is None else torch.from_numpy(min_depth[1])
    tri_p = rasterize_tiled(geometry_stage(patlas, pin, w, h), patlas, pin, w, h,
                            min_depth=pmd).tri_id.numpy()
    v = np.asarray(jgeom.pix_hom)[np.asarray(jatlas.faces)]
    return tri_j, tri_p, v, jin, jgeom


def _penumbra(fj, jatlas, jin, jgeom, cfg, cam_pose):
    """Pixels in the VSM penumbra of any shadowed light of the JAX frame."""
    maps, mats = jax_shadow_maps(jatlas, jin, jgeom, cfg)
    h, w = fj.valid.shape
    cc = fj.cam_coordinates[..., :3].reshape(-1, 3).T.astype(np.float64)
    world = (cam_pose[:3, :3] @ cc + cam_pose[:3, 3:4]).reshape(3, h, w).astype(np.float32)
    pen = np.zeros((h, w), bool)
    for i in range(cfg.max_lights):
        sf = np.asarray(jax_shadow_factor(maps, mats, i, world))
        pen |= (sf > 1e-3) & (sf < 1 - 1e-3)
    return pen


def _check_accessors(r, w, h):
    for name, (shape, dtype) in ACCESSORS.items():
        x = getattr(r, name)()
        assert tuple(x.shape) == (h, w) + shape and x.dtype == dtype, (name, x.shape, x.dtype)
        assert x.device.type == "cpu"
    assert torch.equal(r.depth(), r.coordDepth()[..., 3]) and (r.depth()[~r.frame.valid] == 3000).all()
    assert (r.vertex_indices()[~r.frame.valid] == 0).all()


def _check_frames(fj, fp, tri_j, tri_p, v, pen, min_frac=0.999, skip=None, max_ill_frac=0.01,
                  max_far=0.01):
    """The rules above; ``skip``: pixels where the ids may differ for a
    reason the caller checked, left out of every comparison."""
    assert (fj.instance_index > 0).sum() > 100, "scene unexpectedly empty"
    h, w = fj.valid.shape
    skip = np.zeros((h, w), bool) if skip is None else skip
    agree = check_id_agreement(np.where(skip, tri_j, tri_p), tri_j, v, v[..., 2],
                               min_frac=min_frac) & ~skip
    for name in ("instance_index", "class_index", "vertex_indices"):
        diff = (getattr(fp, name) != getattr(fj, name)).reshape(h, w, -1).any(-1)
        assert not (diff & agree).any(), f"{name} differs where the triangle ids agree"
    np.testing.assert_array_equal(fp.valid, fj.valid)
    hit = agree & (tri_j >= 0)
    check_depth(fp.depth, fj.depth, depth_f64(v, v[..., 2], tri_j), hit, well_tol=5e-6,
                max_ill_frac=max_ill_frac)
    well = well_conditioned(fj.barycentric_coeffs, fp.barycentric_coeffs, tri_j, v)
    calm = agree & (well | (tri_j < 0))
    for name in ("object_coordinates", "cam_coordinates"):
        a, b = getattr(fp, name), getattr(fj, name)
        np.testing.assert_allclose(a[calm], b[calm], rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[hit & ~well], b[hit & ~well], rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(fp.normals[calm], fj.normals[calm], rtol=0, atol=2e-5)
    # the normal map turns the barycentrics' error into texel steps
    ill = np.abs(fp.normals[hit & ~well] - fj.normals[hit & ~well]).max(-1)
    assert (ill <= 1e-3).mean() >= 0.98 and ill.max() <= 5e-3, (ill > 1e-3).mean()
    quiet = hit & well & ~pen
    # two shadowed lights put most of the plane into a penumbra
    assert quiet.sum() >= 0.02 * hit.sum(), "too few pixels outside the penumbra"
    err = np.abs(fp.hdr - fj.hdr)
    far = (err > 2e-4 * np.abs(fj.hdr) + 1e-5).any(-1)
    assert far[quiet].mean() <= max_far, f"{far[quiet].mean():.4f} of calm pixels beyond 2e-4"
    assert (err[quiet] <= 0.05 * np.abs(fj.hdr[quiet]) + 1e-4).all()
    shade = hit & well & pen
    np.testing.assert_allclose(fp.hdr[shade], fj.hdr[shade], rtol=1e-2, atol=1e-4)
    back = agree & ~fj.valid
    assert back.sum() > 20, "no background in view"
    np.testing.assert_allclose(fp.hdr[back], fj.hdr[back], rtol=1e-5, atol=1e-6)
    d = np.abs(fp.rgb.astype(np.int32) - fj.rgb.astype(np.int32)).max(-1)
    assert (d[agree] <= 1).mean() >= 0.995 and d[agree & ~pen & ~far].max() <= 3
    # where SSAO's compare flipped (5% of the hdr) or in the penumbra (1e-2)
    assert d[agree].max() <= 13
    return agree


@pytest.fixture(scope="module")
def base(scenes):
    """The default pass: the first render, then the predicate's and the
    peel's renders through the same pass objects."""
    js, ps, *_ = scenes
    rps = (jsl.RenderPass(), sl.RenderPass())
    return rps, _render(js, ps, rps)


def test_render_pass_config_matches_jax(scenes, base):
    """The light merge puts the sun in slot 1: two shadow passes; the tile
    capacity from 2,254 faces over 70 tiles is 512; textures on, stickers
    off, no cutout; the JAX package's CPU shadow size."""
    _, (rj, rp, cfgs) = base
    for name in CFG_FIELDS:
        want = getattr(cfgs["jax"], name)
        assert getattr(cfgs["port"], name) == (want or 512 if name == "shadow_size" else want), name
    assert cfgs["port"].max_lights == 2 and cfgs["port"].tile_capacity == 512
    assert cfgs["port"].sample_textures and not cfgs["port"].alpha_peel
    _check_accessors(rp, W, H)


def test_render_pass_frame_matches_jax(scenes, base):
    js, ps, *_ = scenes
    rps, (rj, rp, cfgs) = base
    tri_j, tri_p, v, jin, jgeom = _tri_ids(js, ps, rps, cfgs["port"])
    fj, fp = to_numpy(rj.frame), _numpy(rp.frame)
    pen = _penumbra(fj, rps[0]._atlas, jin, jgeom, cfgs["jax"], js.camera_pose())
    _check_frames(fj, fp, tri_j, tri_p, v, pen)
    plane = fj.valid & (fj.instance_index == 0)
    assert plane.sum() > 100, "no background plane in view"


def test_render_pass_predicate_matches_jax(scenes, base):
    """``predicate`` hides the sphere: it leaves the frame in both."""
    js, ps, *_ = scenes
    rps, _ = base
    rj, rp, cfgs = _render(js, ps, rps, predicate=lambda o: o.instance_index != 2)
    fj, fp = to_numpy(rj.frame), _numpy(rp.frame)
    assert not (fp.instance_index == 2).any() and (fp.instance_index == 1).any()
    visible = np.array([True, False, True, True])
    tri_j, tri_p, v, jin, jgeom = _tri_ids(js, ps, rps, cfgs["port"], visible)
    jin = jin._replace(obj_visible=jnp.asarray(visible))
    pen = _penumbra(fj, rps[0]._atlas, jin, jgeom, cfgs["jax"], js.camera_pose())
    _check_frames(fj, fp, tri_j, tri_p, v, pen)


def test_render_pass_depth_peel_matches_jax(scenes, base):
    """A second pass behind the first result's depth: the surfaces behind
    the first winners, in both packages."""
    js, ps, *_ = scenes
    rps, (rj0, rp0, _) = base
    rj, rp, cfgs = _render(js, ps, rps, depth_peel=(rj0, rp0))
    fj, fp = to_numpy(rj.frame), _numpy(rp.frame)
    first = np.asarray(rj0.depth())
    floors = [np.where(d >= 2999.0, 0.0, d).astype(np.float32)
              for d in (first, rp0.depth().numpy())]
    floor = floors[0]
    tri_j, tri_p, v, jin, jgeom = _tri_ids(js, ps, rps, cfgs["port"], min_depth=floors)
    shown = fp.valid & (first < 2999.0)  # mostly a surface behind the first one
    assert shown.sum() > 100 and (fp.depth[shown] > first[shown] + 1e-3).mean() > 0.9
    # a floor tie: where the ids differ, one winner's depth lies within 1e-4
    # of the floor's test (w > floor + 1e-5): the raster's float32 depth of a
    # small triangle is that far from float64 (ROADMAP C-5), so it flips
    ys, xs = np.nonzero(tri_j != tri_p)
    skip = np.zeros((H, W), bool)
    for y, x in zip(ys, xs):
        for t in (tri_j[y, x], tri_p[y, x]):
            if t >= 0:
                E, Es = edge_values(v, np.array([t]), np.array([y]), np.array([x]))
                d = float((E[0] * v[t, :, 2].astype(np.float64)).sum() / Es[0])
                skip[y, x] |= abs(d - (floor[y, x] + 1e-5)) <= 1e-4
    # the same test on each frame's own winner (JAX's frame is compiled, its
    # raster rounds otherwise than the eager one above)
    for f, fl in zip((fj, fp), floors):
        skip |= f.valid & (fl > 0) & (np.abs(f.depth - (fl + 1e-5)) <= 1e-4)
    assert skip.sum() <= 0.01 * (first < 2999.0).sum(), skip.sum()
    pen = _penumbra(fj, rps[0]._atlas, jin, jgeom, cfgs["jax"], js.camera_pose())
    # the second layer is mostly the small back-facing triangles of the
    # blob and sphere, in the occluders' shade: ill-conditioned depths on up
    # to 2% of its pixels, SSAO's compare flipping on up to 5%
    _check_frames(fj, fp, tri_j, tri_p, v, pen, skip=skip, max_ill_frac=0.02, max_far=0.05)


def test_render_pass_supersample_background_matches_jax(scenes):
    """``supersample=2`` with a 100x70 background image resized to the
    320x240 render (Pillow in the JAX package, the port's own resize):
    the centre samples' ground truth as at 1x, rgb and the background after
    the box filter."""
    js, ps, jbg, pbg = scenes
    js.background_image, ps.background_image = jbg, pbg
    try:
        rps = (jsl.RenderPass(supersample=2), sl.RenderPass(supersample=2))
        rj, rp, cfgs = _render(js, ps, rps)
    finally:
        js.background_image = ps.background_image = None
    assert cfgs["port"].width == 2 * W and cfgs["port"].tile_capacity == 256
    assert cfgs["jax"].tile_capacity == 256
    _check_accessors(rp, W, H)
    fj, fp = to_numpy(rj.frame), _numpy(rp.frame)
    tri_j, tri_p, v, *_ = _tri_ids(js, ps, rps, cfgs["port"])
    agree = check_id_agreement(tri_p, tri_j, v, v[..., 2], min_frac=0.995)[1::2, 1::2]
    for name in ("instance_index", "class_index", "vertex_indices"):
        diff = (getattr(fp, name) != getattr(fj, name)).reshape(H, W, -1).any(-1)
        assert not (diff & agree).any(), name
    # the centre samples' barycentrics against float64 at their full-size pixel
    tri_c = tri_j[1::2, 1::2]
    ys, xs = np.nonzero(tri_c >= 0)
    E, Es = edge_values(v, tri_c[ys, xs], 2 * ys + 1, 2 * xs + 1)
    b64 = E / Es[:, None]
    well = np.zeros((H, W), bool)
    well[ys, xs] = ((np.abs(fj.barycentric_coeffs[ys, xs] - b64).max(1) <= 1e-5)
                    & (np.abs(fp.barycentric_coeffs[ys, xs] - b64).max(1) <= 1e-5))
    hit = agree & (tri_c >= 0)
    for name in ("object_coordinates", "cam_coordinates"):
        a, b = getattr(fp, name), getattr(fj, name)
        calm = agree & (well | (tri_c < 0))
        np.testing.assert_allclose(a[calm], b[calm], rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[hit & ~well], b[hit & ~well], rtol=0, atol=1e-4, err_msg=name)
    # every sample of a pixel on the background: the resized image, equal
    tj = tri_j.reshape(H, 2, W, 2)
    back = (tj < 0).all(axis=(1, 3)) & agree
    assert back.sum() > 20, "no background in view"
    np.testing.assert_allclose(fp.hdr[back], fj.hdr[back], rtol=1e-5, atol=1e-6)
    assert fp.hdr[back][:, :3].std() > 0.05  # the image, not a colour
    d = np.abs(fp.rgb.astype(np.int32) - fj.rgb.astype(np.int32)).max(-1)
    assert (d[agree] <= 1).mean() >= 0.99 and d[agree].max() <= 3


def test_render_pass_validates_as_jax():
    for kw in (dict(shading="toon"), dict(shadow_mode="soft"), dict(texture_filter="cubic"),
               dict(supersample=0)):
        with pytest.raises(ValueError):
            jsl.RenderPass(**kw)
        with pytest.raises(ValueError):
            sl.RenderPass(**kw)
    assert sl.RenderPass(shading="phong")._shading == jsl.RenderPass(shading="phong")._shading


def test_background_resize_is_pillows():
    """The port's resize of a non-square RGBA image to another aspect is
    Pillow's BILINEAR resize, bit for bit."""
    from PIL import Image

    from stillleben_tpu_torch.render.atlas import resize_bilinear_u8

    img = np.random.default_rng(8).integers(0, 256, size=(70, 100, 4), dtype=np.uint8)
    img[..., 3] = np.maximum(img[..., 3], 40)
    for size in ((320, 240), (64, 90), (100, 35)):
        want = np.asarray(Image.fromarray(img, "RGBA").resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_u8(img, size), want)
    np.testing.assert_array_equal(resize_bilinear_u8(checker_texture(64), 32),
                                  np.asarray(Image.fromarray(checker_texture(64), "RGBA").resize(
                                      (32, 32), Image.BILINEAR)))
