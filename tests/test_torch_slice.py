"""The datagen slice of the port end to end on the CPU: its own template
construction against the JAX package's, each from its own loader of the
same mesh files (the JAX side cooking hulls with its Python decomposition,
the port's one algorithm), and ``generate_batch`` through either raster
producing every ``RenderedFrame`` field with the JAX package's shapes and
dtypes."""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.parallel.batch import SceneTemplate, generate_batch
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.shading import INVALID
from stillleben_tpu_torch.assets.procedural import sky_equirect
from stillleben_tpu_torch.render.light_map import LightMap
from torch_port_scene import (
    H, SHADOW_SIZE, SUN, W, build_full_meshes, build_meshes, jax_template, port_full_template,
    port_template, to_numpy,
)


# the untextured configuration of the first slices
PLAIN_CFG = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                        sample_textures=False, sample_stickers=False)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The port's own meshes."""
    return build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    return build_meshes(str(tmp_path_factory.mktemp("jax_meshes")), native_decomp=False)


def _leaves(tree, prefix=""):
    """(path, value) for every array leaf of nested NamedTuples."""
    if hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{prefix}{name}.")
    else:
        yield prefix.rstrip("."), tree


def test_template_from_scene_matches_jax(meshes, jax_meshes):
    rng = np.random.default_rng(7)
    mr = [(float(rng.random()), float(rng.random())) for _ in meshes]
    jt = to_numpy(jax_template(jax_meshes, metallic_roughness=mr))
    pt = port_template(meshes, metallic_roughness=mr)
    compared = 0
    for path, value in _leaves(pt):
        if value is None:
            continue
        ref = jt
        for part in path.split("."):
            ref = getattr(ref, part)
        if isinstance(value, int):
            assert value == int(ref), path
            continue
        got = value.numpy()
        ref = np.asarray(ref)
        assert got.shape == ref.shape, path
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=path)
        compared += 1
    assert compared >= 40


def test_generate_batch_end_to_end_on_cpu(meshes):
    check_generate_batch(meshes, PLAIN_CFG)


def test_generate_batch_classic_end_to_end_on_cpu(meshes):
    check_generate_batch(meshes, PLAIN_CFG._replace(raster="classic"))


@pytest.fixture(scope="module")
def sky_light_map():
    """The port's own precompute of the benchmark's sky, once for the file."""
    return LightMap.from_equirect(sky_equirect(), lights=[SUN], device="cpu")


@pytest.mark.parametrize("raster", ["cells", "classic"])
def test_generate_batch_full_configuration_on_cpu(tmp_path_factory, sky_light_map, raster):
    """B = 2 through the small version of the bench-full configuration: the
    port's own template with the textured blob, the checker plane and the
    sky light map; SSAO, trilinear textures, no stickers."""
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                              native_decomp=False)
    tpl = port_full_template((blob, cube, sphere), sky_light_map)
    assert tpl.light_map is not None and tpl.render_atlas.num_objects == 4
    assert tpl.base_inputs.obj_instance.shape == (4,) and tpl.bbox_corners.shape[0] == 3
    cfg = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=True,
                      sample_textures=True, sample_stickers=False, tile_capacity=128,
                      raster=raster)
    frames = generate_batch(torch.Generator().manual_seed(0), 2, tpl, cfg, default_config(),
                            settle_iterations=3)
    for name in ("hdr", "object_coordinates", "cam_coordinates", "normals", "depth"):
        assert torch.isfinite(getattr(frames, name)).all(), name
    inst = frames.instance_index.to(torch.int32)
    plane = frames.valid & (inst == 0)
    assert plane.flatten(1).any(1).all(), "a scene without plane pixels"
    assert (frames.class_index.to(torch.int32)[plane] == 0).all()
    assert (frames.vertex_indices[plane] == 0).all()
    assert ((inst > 0) & frames.valid).flatten(1).any(1).all(), "a scene without object pixels"
    # opaque everywhere: the skybox's alpha is 1, an object's the sum of
    # its texture taps' weights (1 to an ulp)
    assert (frames.hdr[..., 3] > 0.9999).all()
    assert (frames.cam_coordinates[~frames.valid] == INVALID).all()
    # the same poses without texture, light map or SSAO give another image
    plain = generate_batch(torch.Generator().manual_seed(0), 2, tpl._replace(light_map=None),
                           PLAIN_CFG._replace(raster=raster, tile_capacity=128), default_config(),
                           settle_iterations=3)
    assert torch.equal(plain.instance_index, frames.instance_index)
    assert (plain.hdr[..., :3] - frames.hdr[..., :3]).abs().mean() > 1e-3


def test_frame_config_accepts_the_full_options(tmp_path_factory, sky_light_map):
    cfg = FrameConfig(width=W, height=H, ssao=True, sample_textures=True, sample_stickers=True,
                      alpha_peel=True, texture_filter="aniso", ssao_mode="reference",
                      max_lights=1, shadow_size=SHADOW_SIZE)
    cfg.check()
    # and it renders: the cutout cube and stickered objects, plane and sky
    _, sphere, blob, cutout = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                                native_decomp=False)
    tpl = port_full_template((cutout, sphere, blob), sky_light_map, stickers=True)
    frames = generate_batch(torch.Generator().manual_seed(1), 1, tpl, cfg, default_config(),
                            settle_iterations=2)
    assert torch.isfinite(frames.hdr).all() and frames.valid.any()
    # what is shown passed the 0.5 cutoff; the sky behind is opaque
    assert (frames.hdr[..., 3][frames.valid] >= 0.5).all()
    assert (frames.hdr[..., 3][~frames.valid] == 1).all()
    for bad in (dict(texture_filter="nearest"), dict(ssao_mode="hbao"),
                dict(alpha_peel_rounds=-1)):
        with pytest.raises(ValueError):
            cfg._replace(**bad).check()
    for ported in (dict(shading="phong"), dict(shading="flat"), dict(shadow_mode="pcf"),
                   dict(shadow_mode="off"), dict(backface_cull=True, shadow_cull=True, vsm_taps=1,
                                                 ibl_prefilter="nearest", ibl_sh=False)):
        cfg._replace(**ported).check()
    for bad in (dict(shading="toon"), dict(shadow_mode="esm"), dict(vsm_taps=2),
                dict(ibl_prefilter="linear"), dict(backface_cull=1), dict(shadow_cull="yes"),
                dict(ibl_sh=None)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            cfg._replace(**bad).check()


def test_frame_config_rejects_unknown_choices():
    with pytest.raises(ValueError):
        FrameConfig(width=W, height=H, raster="scanline").check()
    with pytest.raises(ValueError):
        FrameConfig(width=W, height=H, raster="classic", fine_tiles_per_cell=3).check()
    FrameConfig(width=W, height=H, raster="classic", fine_tiles_per_cell=8).check()


def check_generate_batch(meshes, cfg):
    tpl = port_template(meshes)
    assert isinstance(tpl, SceneTemplate)
    frames = generate_batch(torch.Generator().manual_seed(0), 2, tpl, cfg, default_config(),
                            settle_iterations=3)
    want = dict(
        rgb=((2, H, W, 4), torch.uint8), hdr=((2, H, W, 4), torch.float32),
        object_coordinates=((2, H, W, 4), torch.float32),
        cam_coordinates=((2, H, W, 4), torch.float32),
        class_index=((2, H, W), torch.uint16), instance_index=((2, H, W), torch.uint16),
        normals=((2, H, W, 4), torch.float32), vertex_indices=((2, H, W, 3), torch.int32),
        barycentric_coeffs=((2, H, W, 3), torch.float32), depth=((2, H, W), torch.float32),
        valid=((2, H, W), torch.bool),
    )
    assert set(frames._fields) == set(want)
    for name, (shape, dtype) in want.items():
        x = getattr(frames, name)
        assert tuple(x.shape) == shape and x.dtype == dtype, name
        if dtype == torch.float32:
            assert torch.isfinite(x).all(), name
    valid = frames.valid
    inst = frames.instance_index.to(torch.int32)
    assert ((inst > 0) == valid).all()
    assert valid.flatten(1).any(1).all(), "a scene without any object pixel"
    assert (frames.cam_coordinates[~valid] == INVALID).all()
    assert (frames.object_coordinates[~valid] == INVALID).all()
    assert (frames.vertex_indices[valid] > 0).all()
    assert frames.rgb.float().std() > 1
