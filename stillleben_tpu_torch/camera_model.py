"""Camera sensor-noise model (Carlson et al. 2018) for rendered RGB.

Counterpart of ``stillleben_tpu/camera_model.py`` (reference
python/stillleben/camera_model.py): chromatic aberration (a per-channel
affine resample, :46-72), a 5x5 Gaussian blur (:75-119), logistic
re-exposure (:121-130), Poissonian-Gaussian noise (Foi et al. 2008,
:132-159), an RGB -> HSV hue jitter (:161-220), and the deterministic and
randomized pipelines (:222-286, the same parameter ranges).

Images are 3xHxW float tensors in [0, 1] (numpy arrays are taken too and
go to the context's device: the card unless ``init(device="cpu")``); the
result lies on the input's device. Where the JAX package takes a random
``key``, the port takes a ``torch.Generator`` (drawing on the generator's
device); without one it draws from torch's default generator of the
image's device. ``process_image`` draws its parameters from numpy, as the
JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KERNEL_SIZE = 5


def _as_t(x, device=None) -> torch.Tensor:
    """A float32 tensor on ``device``; None: a tensor stays where it is,
    an array goes to the context's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
        if device is None:
            from .context import context

            device = context().device
    return x.to(device=device, dtype=torch.float32)


def _gaussian_kernel(sigma: float, device) -> torch.Tensor:
    ax = np.arange(KERNEL_SIZE, dtype=np.float32)
    xx, yy = np.meshgrid(ax, ax)
    mean = (KERNEL_SIZE - 1) / 2.0
    var = max(float(sigma), 1e-6) ** 2
    k = np.exp(-((xx - mean) ** 2 + (yy - mean) ** 2) / (2 * var))
    return torch.from_numpy((k / k.sum()).astype(np.float32)).to(device)


def _sample_bilinear_reflect(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """Bilinear sample of an (H, W) image at pixel coordinates, with the
    indices reflected at the borders (torch's "reflection" padding)."""
    H, W = img.shape

    def reflect(i, n):
        i = torch.remainder(i.abs(), 2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)

    x0, y0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - x0, gy - y0

    def fetch(xi, yi):
        return img[reflect(yi.to(torch.int64), H), reflect(xi.to(torch.int64), W)]

    c00, c10 = fetch(x0, y0), fetch(x0 + 1, y0)
    c01, c11 = fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def chromatic_aberration(rgb, translations, scaling):
    """Per-channel affine resample (reference :46-72).

    :param rgb: 3xHxW image
    :param translations: (3, 2) per-channel (tx, ty) in normalized coordinates
    :param scaling: (3,) per-channel scale
    """
    rgb = _as_t(rgb)
    translations = _as_t(translations, rgb.device)
    scaling = _as_t(scaling, rgb.device)
    assert rgb.dim() == 3 and rgb.shape[0] == 3
    H, W = rgb.shape[1:]
    # the normalized grid of affine_grid(align_corners=False)
    xs = (torch.arange(W, dtype=torch.float32, device=rgb.device) + 0.5) / W * 2 - 1
    ys = (torch.arange(H, dtype=torch.float32, device=rgb.device) + 0.5) / H * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for c in range(3):
        sx = gx * scaling[c] + translations[c, 0]
        sy = gy * scaling[c] + translations[c, 1]
        out.append(_sample_bilinear_reflect(rgb[c], (sx + 1) * W / 2 - 0.5, (sy + 1) * H / 2 - 0.5))
    return torch.stack(out)


def blur(rgb, sigma):
    """5x5 Gaussian blur with zero padding (reference :75-119): the
    convolution, i.e. the correlation with the flipped kernel."""
    rgb = _as_t(rgb)
    k = torch.flip(_gaussian_kernel(float(sigma), rgb.device), (0, 1))
    return F.conv2d(rgb[:, None], k[None, None], padding=KERNEL_SIZE // 2)[:, 0]


def exposure(rgb, deltaS):
    """Logistic re-exposure (reference :121-130)."""
    rgb = _as_t(rgb)
    return 1.0 / (1.0 + float(np.exp(np.float32(deltaS))) * (1.0 / (rgb + 1e-4) - 1.0))


def noise(rgb, a, b, generator: torch.Generator | None = None):
    """Poissonian-Gaussian noise (Foi et al. 2008; reference :132-159)."""
    rgb = _as_t(rgb)
    dev = rgb.device if generator is None else generator.device
    if a > 0.0:
        chi = 1.0 / a
        poisson_part = torch.poisson((chi * rgb).to(dev), generator=generator).to(rgb.device) / chi
    else:
        poisson_part = rgb
    if b > 0.0:
        gaussian_part = b * torch.randn(rgb.shape, generator=generator, device=dev).to(rgb.device)
    else:
        gaussian_part = torch.zeros_like(rgb)
    return torch.clamp(poisson_part + gaussian_part, 0.0, 1.0)


def color_jitter(tensor_img, hue_shift):
    """RGB -> HSV, hue shifted, -> RGB, per pixel (reference :161-220)."""
    img = _as_t(tensor_img)
    assert img.shape[0] == 3
    R, G, B = img[0], img[1], img[2]
    M, Mi = img.max(dim=0)
    m = img.min(dim=0).values
    C = M - m
    safe_C = torch.where(C == 0, torch.ones_like(C), C)
    H1 = (G - B) / safe_C
    H2 = (B - R) / safe_C + 2.0
    H3 = (R - G) / safe_C + 4.0
    case = torch.where(C == 0, 0, Mi + 1)
    Hsel = torch.stack([torch.zeros_like(H1), H1, H2, H3]).gather(0, case[None])[0]
    Hdeg = 60.0 * Hsel
    Hdeg = torch.where(Hdeg < 0, Hdeg + 360.0, Hdeg)
    Hdeg = Hdeg + hue_shift * 360.0
    Hdeg = torch.where(Hdeg < 0, Hdeg + 360.0, Hdeg)
    Hdeg = torch.where(Hdeg > 360.0, Hdeg - 360.0, Hdeg)
    Hp = Hdeg / 60.0
    X = C * (1.0 - (torch.remainder(Hp, 2.0) - 1.0).abs())
    order_case = torch.clamp(Hp.to(torch.int64), 0, 5)
    order = torch.tensor([[0, 1, 2], [1, 0, 2], [2, 0, 1], [2, 1, 0], [1, 2, 0], [0, 2, 1]],
                         device=img.device)
    CX0 = torch.stack([C, X, torch.zeros_like(C)], dim=-1)  # (H, W, 3)
    RGB = CX0.gather(-1, order[order_case])  # which of (C, X, 0) goes to R, G, B
    return RGB.permute(2, 0, 1) + m[None]


def process_deterministic(
    rgb,
    chromatic_translation,
    chromatic_scaling,
    blur_sigma,
    exposure_deltaS,
    do_noise,
    noise_a,
    noise_b,
    hue_shift,
    generator: torch.Generator | None = None,
):
    """The pipeline with fixed parameters (reference :222-258): aberration
    -> blur -> exposure -> noise -> jitter -> a 0.4-sigma post-blur."""
    rgb = _as_t(rgb)
    assert rgb.dim() == 3 and rgb.shape[0] == 3
    rgb = chromatic_aberration(rgb, chromatic_translation, chromatic_scaling)
    if blur_sigma > 0.0:
        rgb = blur(rgb, blur_sigma)
    rgb = exposure(rgb, exposure_deltaS)
    if do_noise:
        rgb = noise(rgb, noise_a, noise_b, generator)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    rgb = color_jitter(rgb, hue_shift)
    # the sensor noise has an effect on more than one pixel: post-blur
    rgb = blur(rgb, 0.4)
    return torch.clamp(rgb, 0.0, 1.0)


def process_image(rgb, generator: torch.Generator | None = None):
    """The pipeline with the reference's random parameter ranges
    (:260-286), drawn from numpy."""
    rng = np.random.default_rng(None)
    hue_jitter = 0.05
    return process_deterministic(
        rgb,
        chromatic_translation=rng.uniform(-0.002, 0.002, size=(3, 2)),
        chromatic_scaling=rng.uniform(0.998, 1.002, size=3),
        blur_sigma=rng.uniform(0.0, 3.0) if rng.random() > 0.3 else 0.0,
        exposure_deltaS=rng.uniform(-2, 1.2),
        do_noise=rng.random() > 0.3,
        noise_a=rng.random() * 0.04,
        noise_b=rng.random() * 0.02,
        hue_shift=rng.uniform(-hue_jitter, hue_jitter),
        generator=generator,
    )
