"""The image-based light of the port against the JAX package.

The precompute (``equirect_to_cube``, ``irradiance_convolution``,
``_prefilter_mip``, ``brdf_lut``, ``project_irradiance_sh``) runs in both
packages on the same seeded panorama, at small sizes and sample counts and
once in full through ``LightMap.from_equirect``: rtol 1e-4 (plus 1e-6
absolute), the loops accumulate sample by sample in the same order (the BRDF
table has its own, looser bound, stated at its test). The
per-pixel terms (``sample_cubemap`` with directions on face edges and
corners, ``sample_cubemap_packed``, ``ibl_term``, ``sample_skybox``) take
the JAX precompute through ``convert.light_map_from_numpy``, so only their
own arithmetic differs: 1e-5 relative to the map's largest value. The BRDF
table lookup truncates to a texel, so ``ibl_term`` bounds the share of
pixels beyond the tolerance instead (at most 1%)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import ibl as jibl
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets.procedural import sky_equirect
from stillleben_tpu_torch.convert import light_map_from_numpy
from stillleben_tpu_torch.render import ibl as pibl
from stillleben_tpu_torch.render import light_map as plm
from stillleben_tpu_torch.render.atlas import RenderInputs
from stillleben_tpu_torch.render.camera import DEFAULT_HFOV_DEG, projection_from_fov
from torch_port_scene import jax_light_map, to_numpy

PRE = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def panorama():
    rng = np.random.default_rng(41)
    return (sky_equirect(32, 64) + rng.random((32, 64, 3)).astype(np.float32) * 0.2)


@pytest.fixture(scope="module")
def jax_data():
    """The JAX package's full precompute of the benchmark's sky, as numpy."""
    return to_numpy(jax_light_map().data)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    edges = np.array(
        [[1, 1, 0], [1, -1, 0], [1, 0, 1], [-1, 0, 1], [0, 1, 1], [0, -1, 1], [1, 1, 1],
         [-1, -1, -1], [1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, -1], [0.5, 0.5, 0.25]], np.float32)
    return np.concatenate([d, edges])  # face edges, corners and axes, unnormalized too


def test_face_directions_and_equirect_to_cube(panorama):
    np.testing.assert_allclose(plm.face_directions(16, "cpu").numpy(),
                               np.asarray(jlm.face_directions(16)), rtol=0, atol=1e-6)
    ref = np.asarray(jlm.equirect_to_cube(jnp.asarray(panorama), size=32))
    got = plm.equirect_to_cube(torch.from_numpy(panorama), size=32).numpy()
    assert got.shape == (6, 32, 32, 3)
    # atan2 and asin differ in the last bits between the libraries, and the
    # sun's edge is steep: 1e-4 of the panorama's peak
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * panorama.max())


def test_sample_cubemap_matches_jax(jax_data):
    rng = np.random.default_rng(42)
    dirs = _dirs(rng, 500)
    for cube in (jax_data.cubemap, jax_data.irradiance, jax_data.prefilter4):
        ref = np.asarray(jlm.sample_cubemap(jnp.asarray(cube), jnp.asarray(dirs)))
        got = plm.sample_cubemap(torch.from_numpy(cube), torch.from_numpy(dirs)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(cube).max())


def test_sample_cubemap_packed_matches_jax(jax_data):
    rng = np.random.default_rng(43)
    dirs = _dirs(rng, 500)
    mips = [jax_data.prefilter_mip(i) for i in range(5)]
    flat = np.concatenate([p.reshape(-1, 3) for p in mips])
    counts = [p.shape[0] * p.shape[1] * p.shape[2] for p in mips]
    offsets = np.array([sum(counts[:i]) for i in range(5)], np.int32)
    sizes = np.array([p.shape[1] for p in mips], np.int32)
    level = rng.integers(0, 5, size=len(dirs)).astype(np.int32)
    ref = np.asarray(jlm.sample_cubemap_packed(
        *(jnp.asarray(x) for x in (flat, offsets, sizes, dirs, level))))
    got = plm.sample_cubemap_packed(
        *(torch.from_numpy(x) for x in (flat, offsets, sizes, dirs, level))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(flat).max())


def test_irradiance_convolution_and_sh_match_jax(panorama):
    cube = np.asarray(jlm.equirect_to_cube(jnp.asarray(panorama), size=32))
    ref = np.asarray(jlm.irradiance_convolution(jnp.asarray(cube), size=8, n_phi=16, n_theta=4))
    got = plm.irradiance_convolution(torch.from_numpy(cube), size=8, n_phi=16, n_theta=4)
    np.testing.assert_allclose(got.numpy(), ref, **PRE)
    sh_ref = np.asarray(jlm.project_irradiance_sh(jnp.asarray(ref)))
    sh_got = plm.project_irradiance_sh(torch.from_numpy(ref)).numpy()
    assert sh_got.shape == (9, 3)
    np.testing.assert_allclose(sh_got, sh_ref, rtol=1e-4, atol=1e-5 * np.abs(sh_ref).max())
    n = _dirs(np.random.default_rng(44), 50)[:50]
    np.testing.assert_allclose(
        plm.eval_irradiance_sh(torch.from_numpy(sh_ref), torch.from_numpy(n)).numpy(),
        np.asarray(jlm.eval_irradiance_sh(jnp.asarray(sh_ref), jnp.asarray(n))),
        rtol=1e-5, atol=1e-5 * np.abs(sh_ref).max())


@pytest.mark.parametrize("roughness", [0.0, 0.5, 1.0])
def test_prefilter_mip_matches_jax(panorama, roughness):
    cube = np.asarray(jlm.equirect_to_cube(jnp.asarray(panorama), size=32))
    ref = np.asarray(jlm._prefilter_mip(jnp.asarray(cube), roughness, 8, n_samples=32))
    got = plm._prefilter_mip(torch.from_numpy(cube), roughness, 8, n_samples=32).numpy()
    np.testing.assert_allclose(got, ref, **PRE)
    np.testing.assert_array_equal(plm._ggx_importance_dirs(roughness, 32),
                                  np.asarray(jlm._ggx_importance_dirs(None, roughness, 32)))


def test_brdf_lut_matches_jax():
    """At its real size (256^2, 512 samples). The half vector's sine is
    sqrt(1 - cos^2) with cos near 1 at low roughness: it cancels in
    float32, and XLA's contracted multiply-adds round it differently. So:
    at most 0.5% of the entries beyond rtol 1e-4, none beyond 5e-3."""
    ref = np.asarray(jlm.get_brdf_lut())
    got = plm.brdf_lut(device="cpu").numpy()
    assert got.shape == ref.shape == (256, 256, 2)
    d = np.abs(got - ref)
    assert (d > 1e-4 * np.abs(ref) + 1e-6).mean() <= 0.005
    assert d.max() <= 5e-3
    assert plm.get_brdf_lut("cpu") is plm.get_brdf_lut("cpu")  # cached per device


def test_from_equirect_matches_jax(jax_data):
    """The whole precompute at its real sizes (512^2 cube, 32^2 irradiance
    of 64 x 16 samples, 5 prefiltered levels of 256 samples)."""
    lm = plm.LightMap.from_equirect(sky_equirect(), lights=[(np.ones(3), np.ones(3))],
                                    device="cpu")
    assert lm.light_directions.shape == (1, 3) and lm.path == "<equirect>"
    peak = float(np.abs(jax_data.cubemap).max())
    for name in plm.LightMapData._fields:
        got, ref = getattr(lm.data, name).numpy(), getattr(jax_data, name)
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * peak, err_msg=name)
    with pytest.raises(FileNotFoundError):  # LightMap(path) loads since the loaders' port
        plm.LightMap("no_such_sky.ibl", device="cpu")


def test_ibl_term_matches_jax(jax_data):
    rng = np.random.default_rng(45)
    H, W = 20, 30

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    normal = unit(rng.normal(size=(H, W, 3)))
    V = unit(normal + 0.8 * rng.normal(size=(H, W, 3)))
    NoV = np.clip((normal * V).sum(-1), 1e-5, 1.0).astype(np.float32)
    roughness = rng.uniform(0.045, 1.0, size=(H, W)).astype(np.float32)
    roughness[0, :3] = [0.045, 0.25, 1.0]
    F0 = rng.uniform(0.04, 1.0, size=(H, W, 3)).astype(np.float32)
    k_S = (F0 + (1 - F0) * 0.3).astype(np.float32)
    c_diff = rng.random((H, W, 3)).astype(np.float32)
    args = (normal, V, NoV, roughness, F0, k_S, c_diff)
    ref = np.asarray(jibl.ibl_term(type(jax_data)(*(jnp.asarray(x) for x in jax_data)),
                                   *(jnp.asarray(x) for x in args)))
    got = pibl.ibl_term(light_map_from_numpy(jax_data, "cpu"),
                        *(torch.from_numpy(x) for x in args)).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    # the BRDF tables are each package's own (1e-4 apart), and its lookup
    # truncates to a texel: a pixel on a texel's edge may read the neighbour
    tol = 2e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    far = (np.abs(got - ref) > tol).any(-1)
    assert far.mean() <= 0.01, far.mean()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05 * np.abs(ref).max())


def test_ibl_term_given_the_same_table(jax_data, monkeypatch):
    """With the JAX package's BRDF table in the port's cache the per-pixel
    arithmetic alone differs: 1e-5."""
    rng = np.random.default_rng(46)
    H, W = 16, 16
    normal = rng.normal(size=(H, W, 3))
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    V = normal + 0.5 * rng.normal(size=(H, W, 3))
    V = (V / np.linalg.norm(V, axis=-1, keepdims=True)).astype(np.float32)
    NoV = np.clip((normal * V).sum(-1), 1e-5, 1.0).astype(np.float32)
    # texel centres of the table, so the truncating lookup cannot flip
    NoV_c = ((np.floor(NoV * 256) + 0.75) / 256).astype(np.float32)
    roughness = ((rng.integers(12, 256, size=(H, W)) + 0.75) / 256).astype(np.float32)
    F0 = rng.uniform(0.04, 1.0, size=(H, W, 3)).astype(np.float32)
    k_S, c_diff = F0, rng.random((H, W, 3)).astype(np.float32)
    lut = np.asarray(jlm.get_brdf_lut())
    monkeypatch.setitem(plm._BRDF_LUT_CACHE, "cpu", torch.from_numpy(lut))
    args = (normal, V, NoV_c, roughness, F0, k_S, c_diff)
    ref = np.asarray(jibl.ibl_term(type(jax_data)(*(jnp.asarray(x) for x in jax_data)),
                                   *(jnp.asarray(x) for x in args)))
    got = pibl.ibl_term(light_map_from_numpy(jax_data, "cpu"),
                        *(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_sample_skybox_matches_jax(jax_data):
    W, H = 40, 30
    proj = projection_from_fov(np.deg2rad(DEFAULT_HFOV_DEG), W, H, device="cpu").numpy()
    c, s = np.cos(0.7), np.sin(0.7)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.array(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]])

    class Inputs:  # what sample_skybox reads
        projection = jnp.asarray(proj)
        cam_pose = jnp.asarray(cam)

    ref = np.asarray(jibl.sample_skybox(
        type(jax_data)(*(jnp.asarray(x) for x in jax_data)), Inputs, W, H))
    blank = {f: torch.zeros(1) for f in RenderInputs._fields}
    pin = RenderInputs(**dict(blank, projection=torch.from_numpy(proj),
                              cam_pose=torch.from_numpy(cam)))
    got = pibl.sample_skybox(light_map_from_numpy(jax_data, "cpu"), pin, W, H).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
