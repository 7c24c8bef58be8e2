"""The port's shadow and shading modes against the JAX package on the small
scene: PCF (the raw depth maps and the 4x4 compare), the 1-tap VSM lookup,
and whole frames with ``shadow_mode="off"``, ``shading="flat"`` and
``shading="phong"``.

Tolerances: the raw PCF maps within 1e-5, as the VSM moments of
``tests/test_torch_frame.py``, but at ill-conditioned pixels (at most 0.1%
of the covered ones, within 1e-4). The PCF compare ``z - bias <= stored`` and
the 1-tap VSM's rounding flip on last-bit differences of their inputs (XLA
fuses multiply-adds, PyTorch rounds each): on the same maps, matrices and
world points both lookups are exact at every pixel except those with a tap
within 1e-6 of the compare, or a coordinate within 1e-4 of the rounding or
truncation boundary, and such pixels are at most 0.5% of all. Frames by the
rules of ``tests/test_torch_frame.py`` (``torch_port_scene.check_frame_pair``);
the phong frame equals the pbr frame of the same package bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import shadow as jsh
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.parallel.batch import render_with_poses
from stillleben_tpu_torch.render import shadow as sh
from stillleben_tpu_torch.render.frame import FrameConfig
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_meshes, check_frame_pair, frame_inputs, jax_template,
    render_pair, settled_scene, to_numpy, vsm_penumbra,
)

JAX_CFG = JaxFrameConfig(
    width=W, height=H, shading="pbr", ssao=False, max_lights=1, shadow_size=SHADOW_SIZE,
    shadow_mode="vsm", sample_textures=False, sample_stickers=False, alpha_peel=False,
    shading_dtype="f32",
)
CFG = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                  sample_textures=False, sample_stickers=False)
SECOND_LIGHT = (np.array([-0.5, -0.3, -0.9], np.float32) / np.linalg.norm([-0.5, -0.3, -0.9]),
                np.array([1.5, 1.5, 1.6], np.float32))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    rng = np.random.default_rng(7)
    mr = [(float(rng.random()), float(rng.random())) for _ in meshes]
    tpl = jax_template(meshes, metallic_roughness=mr)
    poses, cam, light = settled_scene(tpl)
    return tpl, template_from_numpy(to_numpy(tpl), "cpu"), poses, cam, light


def _inputs(scene):
    """Both packages' inputs with a second active light (slot 1) and an
    inactive third, so the light loop and an inactive light's map show."""
    tpl, ptpl, poses, cam, light = scene
    jin = frame_inputs(tpl, poses, cam, light)
    jin = jin._replace(light_directions=jin.light_directions.at[1].set(SECOND_LIGHT[0]),
                       light_colors=jin.light_colors.at[1].set(SECOND_LIGHT[1]))
    pin = ptpl.base_inputs._replace(
        **{f: torch.from_numpy(np.array(getattr(jin, f)))
           for f in ("obj_to_world", "cam_pose", "light_directions", "light_colors")})
    return jin, pin


def test_pcf_maps_match_jax(scene):
    tpl, ptpl, *_ = scene
    jin, pin = _inputs(scene)
    jcfg = JAX_CFG._replace(shadow_mode="pcf", max_lights=3)
    maps_j, mats_j = to_numpy(jsh.render_shadow_maps(
        tpl.render_atlas, jin, jax_geometry_stage(tpl.render_atlas, jin, W, H), jcfg))
    maps_p, mats_p = sh.render_shadow_maps(ptpl.render_atlas, pin, SHADOW_SIZE, 3, mode="pcf")
    assert maps_p.shape == maps_j.shape == (3, SHADOW_SIZE, SHADOW_SIZE)
    for i in (0, 1):
        assert (maps_j[i] < 0.999).mean() > 0.02, f"light {i}'s map unexpectedly empty"
    assert (maps_j[2] == 1).all() and (maps_p[2] == 1).all().item()  # the inactive light
    np.testing.assert_allclose(mats_p.numpy(), mats_j, rtol=1e-5, atol=1e-5)
    # 1e-5 but at pixels where float32 leaves the depth ill-conditioned (a
    # sliver's or an edge's pixel; measured: 1 of 12,288 at 1.4e-5), at
    # most 0.1% of the covered pixels, and there within 1e-4
    err = np.abs(maps_p.numpy() - maps_j)
    covered = maps_j < 1
    assert (err > 1e-5).sum() <= 1e-3 * covered.sum(), f"{(err > 1e-5).sum()} pixels beyond 1e-5"
    assert err.max() <= 1e-4
    with pytest.raises(ValueError, match="mode"):
        sh.render_shadow_maps(ptpl.render_atlas, pin, SHADOW_SIZE, 3, mode="off")


def _lookup_points(seed=0, n=96):
    """(3, n, n) world points over the scene's casters and the floor, at
    heights from the floor to above the pile."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.35, 0.35, (2, n, n))
    z = rng.uniform(0.0, 0.5, (1, n, n))
    return np.concatenate([xy, z]).astype(np.float32)


def _near_boundary(coords, boundary):
    """Float64 coordinates within 1e-4 of the rounding or truncation
    boundary (``boundary``: 0.5 for round, 0 for trunc/floor)."""
    c = np.asarray(coords, np.float64)
    return np.abs((c - boundary) - np.round(c - boundary)) < 1e-4


def _uvz(mats, light, world):
    A = mats[light].astype(np.float64)
    w = world.astype(np.float64)
    return [A[r, 0] * w[0] + A[r, 1] * w[1] + A[r, 2] * w[2] + A[r, 3] for r in range(3)]


@pytest.mark.parametrize("light", [0, 1])
def test_shadow_factor_planar_matches_jax(scene, light):
    tpl, *_ = scene
    jin, _ = _inputs(scene)
    jcfg = JAX_CFG._replace(shadow_mode="pcf", max_lights=3)
    maps, mats = (np.array(x) for x in jsh.render_shadow_maps(
        tpl.render_atlas, jin, jax_geometry_stage(tpl.render_atlas, jin, W, H), jcfg))
    world = _lookup_points(light)
    fj = np.asarray(jsh.shadow_factor_planar(jnp.asarray(maps), jnp.asarray(mats), light,
                                             jnp.asarray(world)))
    fp = sh.shadow_factor_planar(torch.from_numpy(maps), torch.from_numpy(mats), light,
                                 torch.from_numpy(world)).numpy()
    assert 0.05 < (fj < 1).mean() < 0.95, "the lookups are all lit or all shadowed"
    u, v, z = _uvz(mats, light, world)
    S = maps.shape[1]
    near = np.zeros(u.shape, bool)
    for dy in (-1.5, -0.5, 0.5, 1.5):
        for dx in (-1.5, -0.5, 0.5, 1.5):
            ui = np.clip(np.trunc(u + dx), 0, S - 1).astype(np.int64)
            vi = np.clip(np.trunc(v + dy), 0, S - 1).astype(np.int64)
            near |= np.abs(z - sh.SHADOW_BIAS - maps[light][vi, ui]) <= 1e-6
            near |= _near_boundary(u + dx, 0.0) | _near_boundary(v + dy, 0.0)
    differ = fp != fj
    assert not (differ & ~near).any(), "PCF differs at a pixel away from every compare"
    assert differ.mean() <= 0.005, f"PCF flips on {differ.mean():.4f} of the lookups"


def test_vsm_one_tap_matches_jax(scene, monkeypatch):
    tpl, *_ = scene
    jin, _ = _inputs(scene)
    jcfg = JAX_CFG._replace(max_lights=3)
    maps, mats = (np.array(x) for x in jsh.render_shadow_maps(
        tpl.render_atlas, jin, jax_geometry_stage(tpl.render_atlas, jin, W, H), jcfg))
    world = _lookup_points(2)
    monkeypatch.setenv("SL_VSM_TAPS", "1")  # read at call time: this call is not jitted
    fj = np.asarray(jsh.shadow_factor_vsm_planar(jnp.asarray(maps), jnp.asarray(mats), 0,
                                                 jnp.asarray(world)))
    fp = sh.shadow_factor_vsm_planar(torch.from_numpy(maps), torch.from_numpy(mats), 0,
                                     torch.from_numpy(world), taps=1).numpy()
    four = sh.shadow_factor_vsm_planar(torch.from_numpy(maps), torch.from_numpy(mats), 0,
                                       torch.from_numpy(world), taps=4).numpy()
    assert (four != fp).mean() > 0.01, "the point tap changed nothing"
    u, v, _ = _uvz(mats, 0, world)
    near = _near_boundary(u - 0.5, 0.5) | _near_boundary(v - 0.5, 0.5)
    far = np.abs(fp - fj) > 1e-5
    assert not (far & ~near).any(), f"1-tap VSM off by {np.abs(fp - fj)[~near].max()}"
    assert far.mean() <= 0.005, f"the point tap flips on {far.mean():.4f} of the lookups"


@pytest.mark.parametrize("shading,shadow_mode,ssao", [
    ("pbr", "off", False),
    ("flat", "vsm", True),  # flat has neither shadow maps nor SSAO
    ("phong", "vsm", False),
])
def test_frame_mode_matches_jax(scene, shading, shadow_mode, ssao):
    tpl, ptpl, poses, cam, light = scene
    jcfg = JAX_CFG._replace(shading=shading, shadow_mode=shadow_mode, ssao=ssao)
    cfg = CFG._replace(shading=shading, shadow_mode=shadow_mode, ssao=ssao)
    fj, fp, tri_j, tri_p, v = render_pair(tpl, ptpl, poses, cam, light, jcfg, cfg)
    calm = None
    if shadow_mode == "vsm" and shading != "flat":
        calm = ~vsm_penumbra(fj, tpl, poses, cam, light, jcfg)
    check_frame_pair(fj, fp, tri_j, tri_p, v, calm)
    if shading == "flat":  # the base colour, clipped: no light reaches it
        hit = fj.valid
        np.testing.assert_array_equal(fp.rgb[..., :3][hit], np.round(
            np.clip(fp.hdr[..., :3][hit], 0, 1) * 255).astype(np.uint8))
    if shading == "phong":  # the same shader as pbr, by definition
        args = (torch.from_numpy(np.array(poses)), torch.from_numpy(np.array(cam)), cfg,
                torch.from_numpy(np.array(light)))
        a = render_with_poses(ptpl, *args)
        b = render_with_poses(ptpl, *args[:2], cfg._replace(shading="pbr"), args[3])
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_frame_without_shadow_maps_is_lit(scene):
    """shadow_mode="off" lights every surface: at no object pixel is the
    frame darker than with VSM shadows, and somewhere it is brighter."""
    tpl, ptpl, poses, cam, light = scene
    args = (torch.from_numpy(np.array(poses)), torch.from_numpy(np.array(cam)))
    off = render_with_poses(ptpl, *args, CFG._replace(shadow_mode="off"),
                            torch.from_numpy(np.array(light)))
    vsm = render_with_poses(ptpl, *args, CFG, torch.from_numpy(np.array(light)))
    obj = vsm.valid
    assert (off.hdr[..., :3][obj] >= vsm.hdr[..., :3][obj] - 1e-6).all()
    assert (off.hdr[..., :3][obj] > vsm.hdr[..., :3][obj] + 1e-3).any()
