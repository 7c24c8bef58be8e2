"""SSAO of the port against the JAX package on a seeded G-buffer: both
modes, the bilateral blur and ``ssao_apply``.

The occlusion test compares depths (``<=``, ``> BIAS``) and the reference
mode truncates a projected coordinate to an integer pixel, so a last-bit
difference can flip a sample. The tests bound the share of pixels beyond
1e-5 (at most 0.5%) and how far they are: one flipped sample of the
reference mode moves the occlusion by at most 1/64, one flipped tap of the
fast mode by at most the largest tap weight over the weight sum (< 0.04).
The blur is continuous: 1e-5 everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import ssao as jssao
from stillleben_tpu_torch.render import ssao as pssao
from stillleben_tpu_torch.render.camera import DEFAULT_HFOV_DEG, projection_from_fov
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

H, W = 60, 80


@pytest.fixture(scope="module")
def gbuffer():
    """A bumpy surface 1-2 m in front of the camera with a hole and a step,
    its camera-space positions and unit normals."""
    rng = np.random.default_rng(31)
    proj = projection_from_fov(np.deg2rad(DEFAULT_HFOV_DEG), W, H, device="cpu").numpy()
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
    z = 1.5 + 0.05 * np.sin(xs / 5.0) * np.cos(ys / 7.0) + 0.01 * rng.random((H, W))
    z[:, W // 2:] -= 0.3  # a step edge
    fx, fy = proj[0, 0] * W / 2, proj[1, 1] * H / 2
    cx, cy = (proj[0, 2] + 1) * W / 2, (proj[1, 2] + 1) * H / 2
    cam = np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z, np.ones_like(z)], -1)
    n = rng.normal(size=(H, W, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normals = np.concatenate([n, np.ones((H, W, 1))], -1)
    valid = np.ones((H, W), bool)
    valid[10:20, 15:30] = False  # a hole
    cam[~valid] = 3000.0
    return cam.astype(np.float32), normals.astype(np.float32), valid, proj.astype(np.float32)


def _both(name, gbuffer):
    cam, normals, valid, proj = gbuffer
    ref = np.asarray(getattr(jssao, name)(
        jnp.asarray(cam), jnp.asarray(normals), jnp.asarray(valid), jnp.asarray(proj), W, H))
    got = getattr(pssao, name)(
        *(torch.from_numpy(x) for x in (cam, normals, valid, proj))).numpy()
    return got, ref


@pytest.mark.parametrize("name,step", [("compute_ssao", 1 / 64 + 1e-5),
                                       ("compute_ssao_fast", 0.04)])
def test_occlusion_matches_jax(gbuffer, name, step):
    got, ref = _both(name, gbuffer)
    assert got.shape == ref.shape == (H, W)
    assert ref.min() < 0.9 and (ref[~gbuffer[2]] == 1).all(), "the test surface occludes nothing"
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() <= 0.005, f"{(d > 1e-5).mean():.4f} of pixels differ"
    assert d.max() <= 2 * step, d.max()


def test_bilateral_blur_matches_jax(gbuffer):
    cam, _, valid, _ = gbuffer
    rng = np.random.default_rng(32)
    ao = rng.random((H, W)).astype(np.float32)
    depth = np.where(valid, cam[..., 2], 0.0).astype(np.float32)
    ref = np.asarray(jssao.bilateral_blur(jnp.asarray(ao), jnp.asarray(depth)))
    got = pssao.bilateral_blur(torch.from_numpy(ao), torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["fast", "reference"])
def test_ssao_apply_matches_jax(gbuffer, mode):
    cam, normals, valid, proj = gbuffer
    rng = np.random.default_rng(33)
    hdr = rng.random((H, W, 4)).astype(np.float32)
    ref = np.asarray(jssao.ssao_apply(*(jnp.asarray(x) for x in (hdr, cam, normals, valid, proj)),
                                      mode=mode))
    got = pssao.ssao_apply(*(torch.from_numpy(x) for x in (hdr, cam, normals, valid, proj)),
                           mode=mode).numpy()
    np.testing.assert_array_equal(got[..., 3], hdr[..., 3])
    d = np.abs(got - ref).max(-1)
    # a flipped sample is spread over the blur's 25 taps
    assert (d > 1e-5).mean() <= 0.05 and d.max() <= 0.04
    assert (got[..., :3] <= hdr[..., :3] + 1e-6).all() and (got[..., :3] < hdr[..., :3]).any()
