"""Image-based lighting: the full precompute from an in-memory panorama.

Counterpart of ``stillleben_tpu/render/light_map.py`` (reference
src/light_map.cpp): an equirectangular HDR image becomes a 512^2 cubemap
(:394-453), a 32^2 cosine irradiance map (:455-514) with its order-2
spherical-harmonic projection, a 128^2 five-level GGX-prefiltered specular
chain (:516-572), and a split-sum BRDF table (:574-602). Plain torch ops on
an explicit device; the loops accumulate sample by sample, in the order of
the JAX package's scans.

Cube faces follow the GL convention (+X, -X, +Y, -Y, +Z, -Z); the
equirect mapping is uv = (atan2(y, x) * 0.1591 + 0.5, asin(z) * 0.3183 + 0.5).

``LightMap(path)`` loads an sIBL ``.ibl`` descriptor or a bare image
(``_load_source``, a copy of JAX ``light_map.py:462-584``): the panorama
is read as the JAX package reads it through OpenCV, by the port's own
codec (``assets/image.py::read_image_cv2``: Radiance ``.hdr``, PNG, PPM,
JPEG, BMP, GIF, TIFF, WebP frame 0; a TGA through the JAX package's
Pillow fallback). Not ported: the quad-packed cubemap rows
(``SL_IBL_QUAD``), a TPU layout.
"""

from __future__ import annotations

import configparser
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..assets.image import read_image, read_image_cv2
from ..assets.pillow_open import NoRGBA
from ..core import math as m

CUBE_SIZE = 512
IRRADIANCE_SIZE = 32
PREFILTER_SIZE = 128
PREFILTER_MIPS = 5
BRDF_LUT_SIZE = 256


class LightMapData(NamedTuple):
    """What shading reads."""

    cubemap: torch.Tensor  # (6, S, S, 3)
    irradiance: torch.Tensor  # (6, 32, 32, 3)
    prefilter0: torch.Tensor  # (6, 128, 128, 3) roughness 0
    prefilter1: torch.Tensor  # (6, 64, 64, 3)
    prefilter2: torch.Tensor  # (6, 32, 32, 3)
    prefilter3: torch.Tensor  # (6, 16, 16, 3)
    prefilter4: torch.Tensor  # (6, 8, 8, 3)
    # order-2 spherical-harmonic projection of the irradiance map: the
    # cosine convolution leaves almost no energy above band 2, so the
    # per-pixel irradiance is 9 multiply-adds instead of 4 cubemap gathers
    irradiance_sh: torch.Tensor | None = None  # (9, 3)

    def prefilter_mip(self, i: int) -> torch.Tensor:
        return (self.prefilter0, self.prefilter1, self.prefilter2,
                self.prefilter3, self.prefilter4)[i]


def face_directions(size: int, device="cuda") -> torch.Tensor:
    """(6, S, S, 3) unit direction of each cubemap texel."""
    t = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size * 2.0 - 1.0
    tv, tu = torch.meshgrid(t, t, indexing="ij")  # tv = row (t), tu = column (s)
    one = torch.ones_like(tu)
    faces = [
        torch.stack([one, -tv, -tu], -1),  # +X
        torch.stack([-one, -tv, tu], -1),  # -X
        torch.stack([tu, one, tv], -1),  # +Y
        torch.stack([tu, -one, -tv], -1),  # -Y
        torch.stack([tu, -tv, one], -1),  # +Z
        torch.stack([-tu, -tv, -one], -1),  # -Z
    ]
    d = torch.stack(faces, 0)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _cube_face_uv(dirs: torch.Tensor):
    """(face, u, v) of each direction, u and v in [-1, 1] on the face,
    matching ``face_directions``."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    def pick(pos, a, b):  # an integer face id by the sign of pos
        return torch.where(pos > 0, a, b)

    face = torch.where(is_x, pick(x, 0, 1), torch.where(is_y, pick(y, 2, 3), pick(z, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    u = torch.where(
        is_x, torch.where(x > 0, -z, z), torch.where(is_y, x, torch.where(z > 0, x, -x))
    )
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    return face, u / ma, v / ma


def _bilinear(fetch, uu, vv):
    u0 = torch.floor(uu)
    v0 = torch.floor(vv)
    fu = (uu - u0)[..., None]
    fv = (vv - v0)[..., None]
    c00 = fetch(u0, v0)
    c10 = fetch(u0 + 1, v0)
    c01 = fetch(u0, v0 + 1)
    c11 = fetch(u0 + 1, v0 + 1)
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv


def sample_cubemap(cube: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap sample, clamped at the face's edge. cube
    (6, S, S, 3); dirs (..., 3)."""
    S = cube.shape[1]
    face, u, v = _cube_face_uv(dirs)
    uu = (u + 1.0) * 0.5 * S - 0.5
    vv = (v + 1.0) * 0.5 * S - 0.5
    flat = cube.reshape(6 * S * S, cube.shape[-1])
    base = face * (S * S)

    def fetch(ui, vi):
        ui = torch.clamp(ui.to(torch.int32), 0, S - 1)
        vi = torch.clamp(vi.to(torch.int32), 0, S - 1)
        return flat[(base + vi * S + ui).long()]

    return _bilinear(fetch, uu, vv)


def sample_cubemap_packed(
    flat: torch.Tensor,  # (sum 6 * S_l^2, 3) all mip levels, face-major per level
    offsets: torch.Tensor,  # (L,) i32 texel offset of each level
    sizes: torch.Tensor,  # (L,) i32 face edge of each level
    dirs: torch.Tensor,  # (..., 3)
    level: torch.Tensor,  # (...) i32 per-pixel mip level
) -> torch.Tensor:
    """Bilinear sample of one mip level per pixel from the packed chain."""
    S = sizes[level.long()]
    off = offsets[level.long()]
    Sf = S.to(torch.float32)
    face, u, v = _cube_face_uv(dirs)
    uu = (u + 1.0) * 0.5 * Sf - 0.5
    vv = (v + 1.0) * 0.5 * Sf - 0.5
    base = off + face * S * S

    def fetch(ui, vi):
        ui = torch.minimum(torch.clamp(ui.to(torch.int32), min=0), S - 1)
        vi = torch.minimum(torch.clamp(vi.to(torch.int32), min=0), S - 1)
        return flat[(base + vi * S + ui).long()]

    return _bilinear(fetch, uu, vv)


def _sample_equirect(img: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The reference's mapping (cubemap_shader_equirectangular.frag)."""
    Hs, Ws = img.shape[:2]
    u = torch.atan2(dirs[..., 1], dirs[..., 0]) * 0.1591 + 0.5
    v = torch.asin(torch.clamp(dirs[..., 2], -1, 1)) * 0.3183 + 0.5
    uu = u * Ws - 0.5
    vv = (1.0 - v) * Hs - 0.5  # image row 0 = top = +z

    def fetch(ui, vi):
        ui = torch.remainder(ui.to(torch.int32), Ws)
        vi = torch.clamp(vi.to(torch.int32), 0, Hs - 1)
        return img[vi.long(), ui.long()]

    return _bilinear(fetch, uu, vv)


def equirect_to_cube(img: torch.Tensor, size: int = CUBE_SIZE) -> torch.Tensor:
    return _sample_equirect(img, face_directions(size, img.device))


def _tangent_frame(N: torch.Tensor):
    z_up = torch.tensor([0.0, 0.0, 1.0], device=N.device).expand(N.shape)
    x_up = torch.tensor([1.0, 0.0, 0.0], device=N.device).expand(N.shape)
    up = torch.where(N[..., 2:3].abs() < 0.999, z_up, x_up)
    T = m.cross(up, N)
    T = T / torch.clamp(torch.linalg.vector_norm(T, dim=-1, keepdim=True), min=1e-9)
    B = m.cross(N, T)
    return T, B


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to order 2 of unit directions d (..., 3)
    -> (..., 9) (the constants of Ramamoorthi & Hanrahan 2001)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    one = torch.ones_like(x)
    return torch.stack(
        [
            0.282095 * one,
            0.488603 * y,
            0.488603 * z,
            0.488603 * x,
            1.092548 * x * y,
            1.092548 * y * z,
            0.315392 * (3.0 * z * z - 1.0),
            1.092548 * x * z,
            0.546274 * (x * x - y * y),
        ],
        dim=-1,
    )


def project_irradiance_sh(irr: torch.Tensor) -> torch.Tensor:
    """Project a (6, S, S, 3) irradiance cubemap onto order-2 SH -> (9, 3),
    with texel solid angles from the face-grid coordinates."""
    S = irr.shape[1]
    t = (torch.arange(S, dtype=torch.float32, device=irr.device) + 0.5) / S * 2.0 - 1.0
    tv, tu = torch.meshgrid(t, t, indexing="ij")
    # d_omega = du dv / (u^2 + v^2 + 1)^(3/2), du = dv = 2 / S (sums to 4 pi)
    dw = (2.0 / S) ** 2 / ((tu * tu + tv * tv + 1.0) ** 1.5)
    Y = sh_basis(face_directions(S, irr.device))  # (6, S, S, 9)
    return torch.einsum("fuvk,fuvc->kc", Y * dw[None, :, :, None], irr)


def eval_irradiance_sh(coeffs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """coeffs (9, 3), unit normals n (..., 3) -> irradiance (..., 3)."""
    return torch.einsum("...k,kc->...c", sh_basis(n), coeffs)


def irradiance_convolution(
    cube: torch.Tensor, size: int = IRRADIANCE_SIZE, n_phi: int = 64, n_theta: int = 16
) -> torch.Tensor:
    """Cosine-weighted hemisphere convolution (light_map.cpp:455-514), one
    sample direction after the other, theta outermost."""
    N = face_directions(size, cube.device)
    T, B = _tangent_frame(N)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False).astype(np.float32)
    thetas = ((np.arange(n_theta, dtype=np.float32) + 0.5)
              * np.float32(0.5 * np.pi / n_theta)).astype(np.float32)
    acc = torch.zeros_like(N)
    for theta in thetas:
        st, ct = np.sin(theta), np.cos(theta)
        for phi in phis:
            d = T * float(st * np.cos(phi)) + B * float(st * np.sin(phi)) + N * float(ct)
            acc = acc + sample_cubemap(cube, d) * float(ct * st)
    return acc * (math.pi / (n_phi * n_theta))


def _radical_inverse(n_samples: int) -> np.ndarray:
    """The van der Corput sequence in float64."""
    bits = np.arange(n_samples).astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits.astype(np.float64) * 2.3283064365386963e-10


def _ggx_importance_dirs(roughness: float, n_samples: int) -> np.ndarray:
    """Hammersley GGX half-vector importance samples in tangent space,
    (n, 3) float32, computed in float64."""
    xi2 = _radical_inverse(n_samples)
    xi1 = np.arange(n_samples) / n_samples
    a = roughness * roughness
    phi = 2 * np.pi * xi1
    cos_t = np.sqrt((1.0 - xi2) / (1.0 + (a * a - 1.0) * xi2))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
    hx = (np.cos(phi) * sin_t).astype(np.float32)
    hy = (np.sin(phi) * sin_t).astype(np.float32)
    return np.stack([hx, hy, cos_t.astype(np.float32)], -1)


def _prefilter_mip(cube: torch.Tensor, roughness: float, size: int, n_samples: int = 256):
    N = face_directions(size, cube.device)
    T, B = _tangent_frame(N)
    acc = torch.zeros_like(N)
    wacc = torch.zeros_like(N[..., :1])
    for h in _ggx_importance_dirs(float(roughness), n_samples):
        Hv = T * float(h[0]) + B * float(h[1]) + N * float(h[2])
        # V = N assumed: L = reflect(-N, H) = 2 (N.H) H - N
        ndh = (N * Hv).sum(-1, keepdim=True)
        L = 2.0 * ndh * Hv - N
        ndl = torch.clamp((N * L).sum(-1, keepdim=True), min=0.0)
        acc = acc + sample_cubemap(cube, L) * ndl
        wacc = wacc + ndl
    return acc / torch.clamp(wacc, min=1e-6)


def brdf_lut(size: int = BRDF_LUT_SIZE, n_samples: int = 512, device="cuda") -> torch.Tensor:
    """Split-sum BRDF integration table (row = roughness, column = NoV)
    -> (size, size, 2) of (A, B)."""
    ax = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    Rg, NoVm = torch.meshgrid(ax, ax, indexing="ij")
    V = torch.stack([torch.sqrt(1 - NoVm**2), torch.zeros_like(NoVm), NoVm], -1)
    xi2 = _radical_inverse(n_samples).astype(np.float32)
    xi1 = (np.arange(n_samples) / n_samples).astype(np.float32)
    a = Rg * Rg
    k = (Rg * Rg) / 2.0  # the IBL k
    A = torch.zeros_like(NoVm)
    Bv = torch.zeros_like(NoVm)
    for x1, x2 in zip(xi1, xi2):
        phi = np.float32(2 * np.pi) * x1
        x2 = float(x2)
        cos_t = torch.sqrt((1.0 - x2) / (1.0 + (a * a - 1.0) * x2))
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
        Hv = torch.stack([float(np.cos(phi)) * sin_t, float(np.sin(phi)) * sin_t, cos_t], -1)
        vdh = (V * Hv).sum(-1)
        L = 2.0 * vdh[..., None] * Hv - V
        NoL = torch.clamp(L[..., 2], min=0.0)
        NoH = torch.clamp(Hv[..., 2], min=0.0)
        VoH = torch.clamp(vdh, min=0.0)
        G = (NoL / torch.clamp(NoL * (1 - k) + k, min=1e-6)) * (
            NoVm / torch.clamp(NoVm * (1 - k) + k, min=1e-6)
        )
        G_vis = torch.where(NoL > 0, G * VoH / torch.clamp(NoH * NoVm, min=1e-6),
                            torch.zeros_like(G))
        Fc = (1.0 - VoH) ** 5
        A = A + (1 - Fc) * G_vis
        Bv = Bv + Fc * G_vis
    return torch.stack([A, Bv], -1) / n_samples


_BRDF_LUT_CACHE: dict[str, torch.Tensor] = {}


def get_brdf_lut(device="cuda") -> torch.Tensor:
    """The BRDF table on ``device``, computed once per device."""
    key = str(torch.device(device))
    if key not in _BRDF_LUT_CACHE:
        _BRDF_LUT_CACHE[key] = brdf_lut(device=device)
    return _BRDF_LUT_CACHE[key]


def precompute(equirect: torch.Tensor) -> LightMapData:
    """All passes from an (H, W, 3) float32 panorama on its device."""
    cube = equirect_to_cube(equirect)
    irr = irradiance_convolution(cube)
    mips = [
        _prefilter_mip(cube, i / (PREFILTER_MIPS - 1), PREFILTER_SIZE >> i)
        for i in range(PREFILTER_MIPS)
    ]
    return LightMapData(cube, irr, *mips, irradiance_sh=project_irradiance_sh(irr))


def _load_hdr_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear, as JAX ``light_map.py::_load_hdr_image``:
    the image as OpenCV reads it (BGR flipped to RGB, grey stacked to three
    channels), and ``(x / 255) ** 2.2`` only where its maximum exceeds 10
    and the name ends in .png / .jpg / .jpeg (so a dark 8-bit PNG stays
    unscaled, a 16-bit one is divided by 255, and a BMP or TIFF keeps its
    0-255 values). What OpenCV does not read (a TGA) takes the JAX
    package's Pillow fallback: ``convert("RGB") / 255`` to the power 2.2."""
    img = read_image_cv2(path)
    if img is None:
        try:
            rgb = read_image(path)[..., :3]
        except NoRGBA as e:  # convert("RGB") reads what convert("RGBA") refuses
            rgb = e.rgb
        return np.ascontiguousarray((rgb.astype(np.float32) / 255.0) ** 2.2)
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., ::-1]  # BGR -> RGB
    if img.max() > 10.0 and path.lower().endswith((".png", ".jpg", ".jpeg")):
        img = (img / 255.0) ** 2.2
    return np.ascontiguousarray(img)


def _load_source(path: str):
    """(equirect, lights) from an sIBL ``.ibl`` descriptor or a bare image.
    Real descriptors are hand-written ini files with quirks (a UTF-8 BOM,
    ``%`` in values, duplicate keys, CRLF, mixed-case keys): parsed
    leniently. The panorama is ``REFmulti * img ** REFgamma``; each of
    ``[Sun]``, ``[Light1]``, ``[Light2]`` is an analytic light from the
    direction theta = (u + 0.5) 2 pi, phi = v pi (reference
    light_map.cpp:314-326)."""
    lights = []
    if path.endswith(".ibl"):
        cp = configparser.ConfigParser(interpolation=None, strict=False)
        with open(path, "r", errors="replace") as f:
            text = f.read().lstrip("\ufeff")
        cp.read_string(text)
        if "Reflection" not in cp:
            raise ValueError(f"{path}: no [Reflection] section — not an sIBL descriptor")
        base = os.path.dirname(os.path.abspath(path))
        sec = cp["Reflection"]
        file = sec.get("REFfile", "").strip('"')
        gamma = float(sec.get("REFgamma", 1.0))
        multi = float(sec.get("REFmulti", 1.0))
        img = _load_hdr_image(os.path.join(base, file))
        img = multi * (img**gamma)

        def parse_light(section, prefix):
            if section not in cp:
                return None
            g = cp[section]
            multi = float(g.get(prefix + "multi", 1.0))
            color = np.ones(3, np.float32)
            if prefix + "color" in g:
                parts = g.get(prefix + "color").split(",")
                color = np.array([float(p) for p in parts], np.float32) / 255.0
            theta = (float(g.get(prefix + "u", 0.0)) + 0.5) * 2 * np.pi
            phi = float(g.get(prefix + "v", 0.0)) * np.pi
            pos = np.array(
                [np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta), np.cos(theta)],
                np.float32,
            )
            return -pos, multi * color

        for section, prefix in [("Sun", "SUN"), ("Light1", "LIGHT"), ("Light2", "LIGHT")]:
            res = parse_light(section, prefix)
            if res is not None:
                lights.append(res)
    else:
        img = _load_hdr_image(path)
    return img.astype(np.float32), lights


class LightMap:
    """Host object: the panorama's analytic lights and the precomputed data.
    ``LightMap(path)`` loads a descriptor or image and precomputes on
    ``device``."""

    def __init__(self, path: str | None = None, device="cuda"):
        self.path = ""
        self.device = torch.device(device)
        self.light_directions = np.zeros((0, 3), np.float32)
        self.light_colors = np.zeros((0, 3), np.float32)
        self.data: LightMapData | None = None
        if path:
            self.load(path)

    @classmethod
    def from_equirect(cls, equirect, lights=(), device="cuda") -> "LightMap":
        """From an in-memory (H, W, 3) float panorama. ``lights``: (direction,
        colour) pairs, the analytic lights an .ibl descriptor would carry."""
        lm = cls(device=device)
        lm.path = "<equirect>"
        lm._precompute(np.asarray(equirect, np.float32), lights)
        return lm

    def load(self, path: str) -> bool:
        """Load ``path`` (.ibl or an image) and precompute on this map's device."""
        equirect, lights = _load_source(path)
        self.path = path
        self._precompute(equirect, lights)
        return True

    def _precompute(self, equirect: np.ndarray, lights) -> None:
        for d, c in lights:
            self.light_directions = np.concatenate([self.light_directions, np.asarray(d)[None]])
            self.light_colors = np.concatenate([self.light_colors, np.asarray(c)[None]])
        self.data = precompute(torch.from_numpy(equirect).to(self.device))
