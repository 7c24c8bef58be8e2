"""The port's texture samplers against the JAX package's on the same seeded
inputs: ``sample_combo_mip_planar`` (the packed-tap order, the JAX default)
for the trilinear and bilinear filters and at the taps the anisotropic
filter takes, and ``sample_sticker_planar``. uv runs outside [0, 1]
(repeat wrapping; the sticker's transparent border) and the lod below 0, at
integers and beyond the last level. Tolerance 1e-6 absolute on values in
[0, 1]: the same taps and weights, summed in the same order; XLA may
contract a multiply-add where PyTorch does not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import shading as jshading
from stillleben_tpu.render.atlas import _mip_chain_packed as jax_mip_chain
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.render import shading as pshading
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

H, W = 24, 40


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    base = rng.random((3, patlas.TEXTURE_SIZE, patlas.TEXTURE_SIZE, 16)).astype(np.float32)
    stack = patlas._mip_chain_packed(base)
    np.testing.assert_array_equal(stack, jax_mip_chain(base))
    tex_id = rng.integers(-1, 3, size=(H, W)).astype(np.int32)
    u = rng.uniform(-1.5, 2.5, size=(H, W)).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, size=(H, W)).astype(np.float32)
    lod = rng.uniform(-1.0, 10.0, size=(H, W)).astype(np.float32)
    lod[0, :12] = np.arange(12) - 1.0  # integers, below 0 and beyond the last level (8)
    u[1, :4] = [0.0, 1.0, -1.0, 0.5 / 256]  # texel edges and the wrap seam
    v[1, :4] = [1.0, 0.0, 2.0, -0.5 / 256]
    return stack, tex_id, u, v, lod


@pytest.mark.parametrize("trilinear", [True, False])
def test_sample_combo_mip_planar_matches_jax(inputs, trilinear):
    stack, tex_id, u, v, lod = inputs
    ref = np.asarray(jshading._sample_combo_mip_packed(
        *(jnp.asarray(x) for x in (stack, tex_id, u, v, lod)), trilinear=trilinear))
    got = pshading.sample_combo_mip_planar(
        *(torch.from_numpy(x) for x in (stack, tex_id, u, v, lod)), trilinear=trilinear).numpy()
    assert got.shape == ref.shape == (16, H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.isfinite(got).all() and got.std() > 0.01


def test_aniso_taps_match_jax(inputs):
    """The four taps of the anisotropic filter: trilinear samples at uv
    shifted along a per-pixel major axis, averaged."""
    stack, tex_id, u, v, lod = inputs
    rng = np.random.default_rng(22)
    dua = rng.normal(0, 0.05, size=(H, W)).astype(np.float32)
    dva = rng.normal(0, 0.05, size=(H, W)).astype(np.float32)
    ref, got = 0.0, 0.0
    for k in range(4):
        t = (k + 0.5) / 4 - 0.5
        ref = ref + np.asarray(jshading._sample_combo_mip_packed(
            jnp.asarray(stack), jnp.asarray(tex_id), jnp.asarray(u + t * dua),
            jnp.asarray(v + t * dva), jnp.asarray(lod)))
        got = got + pshading.sample_combo_mip_planar(
            torch.from_numpy(stack), torch.from_numpy(tex_id), torch.from_numpy(u + t * dua),
            torch.from_numpy(v + t * dva), torch.from_numpy(lod)).numpy()
    np.testing.assert_allclose(got / 4, ref / 4, rtol=0, atol=1e-6)


def test_sample_sticker_planar_matches_jax():
    rng = np.random.default_rng(23)
    stack = np.zeros((3, 26, 30, 4), np.float32)
    sizes = np.array([[30, 20], [22, 26], [8, 8]], np.float32)  # native (w, h)
    for i, (w, h) in enumerate(sizes.astype(int)):
        stack[i, :h, :w] = rng.random((h, w, 4))
    tex_id = rng.integers(-1, 3, size=(H, W)).astype(np.int32)
    u = rng.uniform(-0.3, 1.3, size=(H, W)).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, size=(H, W)).astype(np.float32)
    u[0, :4] = [0.0, 1.0, 0.5 / 30, 1.0 - 0.5 / 30]  # the border taps
    v[0, :4] = [0.0, 1.0, 0.5 / 20, 1.0 - 0.5 / 20]
    ref = np.asarray(jshading.sample_sticker_planar(
        *(jnp.asarray(x) for x in (stack, sizes, tex_id, u, v))))
    got = pshading.sample_sticker_planar(
        *(torch.from_numpy(x) for x in (stack, sizes, tex_id, u, v))).numpy()
    assert got.shape == ref.shape == (4, H, W)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    outside = (u < -0.1) | (v < -0.1)
    assert (got[:, outside] == 0).all()  # the transparent border
