"""``sl.camera_model`` of the port against the JAX package's on the CPU, on
the same seeded 3x40x56 image: every deterministic function within 1e-5
(1e-4 after the exposure's division and the hue jitter's branches), the
random ones with the same injected draws (the Poisson and normal samples,
and the numpy generator ``process_image`` draws its parameters from)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu import camera_model as jcm
from stillleben_tpu_torch import camera_model as pcm
import torch_port_scene  # noqa: F401  (one torch thread per test worker)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(5)
    img = rng.random((3, 40, 56), dtype=np.float32)
    img[:, 10:20, 10:30] = img[:, 10:11, 10:11]  # a flat patch: C == 0 in the jitter
    return img


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def test_chromatic_aberration(image):
    t = np.array([[0.002, -0.001], [0.0, 0.0015], [-0.002, 0.002]], np.float32)
    s = np.array([1.002, 0.998, 1.0], np.float32)
    out = pcm.chromatic_aberration(torch.from_numpy(image), torch.from_numpy(t),
                                   torch.from_numpy(s))
    assert out.shape == image.shape and out.dtype == torch.float32
    _close(out, jcm.chromatic_aberration(image, t, s))
    # far-out samples reflect at the borders
    t_far = np.full((3, 2), 0.6, np.float32)
    _close(pcm.chromatic_aberration(torch.from_numpy(image), torch.from_numpy(t_far),
                                    torch.from_numpy(s)),
           jcm.chromatic_aberration(image, t_far, s))


@pytest.mark.parametrize("sigma", [0.4, 1.7])
def test_blur(image, sigma):
    _close(pcm.blur(torch.from_numpy(image), sigma), jcm.blur(image, sigma))


@pytest.mark.parametrize("delta_s", [-2.0, 0.7])
def test_exposure(image, delta_s):
    _close(pcm.exposure(torch.from_numpy(image), delta_s), jcm.exposure(image, delta_s), 1e-4)


@pytest.mark.parametrize("hue", [-0.05, 0.03, 0.6])
def test_color_jitter(image, hue):
    _close(pcm.color_jitter(torch.from_numpy(image), hue), jcm.color_jitter(image, hue), 1e-4)


def _inject(monkeypatch, image):
    """The same Poisson and normal draws for both packages."""
    rng = np.random.default_rng(11)
    pois = rng.poisson(25.0 * image).astype(np.float32)
    norm = rng.standard_normal(image.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "poisson", lambda key, lam: jnp.asarray(pois))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(norm))
    monkeypatch.setattr(torch, "poisson", lambda x, generator=None: torch.from_numpy(pois))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, device=None:
                        torch.from_numpy(norm))


def test_noise_with_injected_draws(image, monkeypatch):
    _inject(monkeypatch, image)
    out = pcm.noise(torch.from_numpy(image), 0.04, 0.02, torch.Generator())
    _close(out, jcm.noise(image, 0.04, 0.02, jax.random.PRNGKey(0)))
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_noise_draws_from_the_generator(image):
    """Seeded generators give the same noise; the image stays in [0, 1]."""
    a = pcm.noise(torch.from_numpy(image), 0.04, 0.02, torch.Generator().manual_seed(3))
    b = pcm.noise(torch.from_numpy(image), 0.04, 0.02, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, torch.from_numpy(image))
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_process_deterministic(image, monkeypatch):
    _inject(monkeypatch, image)
    args = (np.array([[0.001, 0.0], [0.0, -0.001], [0.0015, 0.001]], np.float32),
            np.array([1.001, 0.999, 1.0], np.float32), 1.2, -0.5, True, 0.04, 0.02, 0.02)
    out = pcm.process_deterministic(torch.from_numpy(image), *args)
    _close(out, jcm.process_deterministic(image, *args), 1e-4)


def test_process_image_with_injected_draws(image, monkeypatch):
    _inject(monkeypatch, image)
    real = np.random.default_rng
    for seed in (1, 2, 3):
        monkeypatch.setattr(np.random, "default_rng", lambda s=None, seed=seed: real(seed))
        out = pcm.process_image(torch.from_numpy(image))
        assert out.shape == image.shape
        _close(out, jcm.process_image(image), 1e-4)
