"""The image-based light's two modes against the JAX package: the
nearest-level prefilter (``FrameConfig.ibl_prefilter="nearest"``, the JAX
package's ``SL_IBL_PREFILTER=nearest``) and the irradiance cubemap in place
of the spherical harmonics (``ibl_sh=False``, ``SL_IBL_SH=0``).

``ibl_term`` takes the JAX package's precompute and BRDF table, so only the
per-pixel arithmetic differs: within 1e-4 relative, except where the
nearest level's ``round`` (half to even in both packages) lands on the
other level: lookups with ``roughness * 4`` within 1e-5 of a half, at most
0.5% of them. The whole 48x48 frame with the light map, textures and plane
(SSAO off), both modes on, holds its hdr to 1e-4 relative at the
well-conditioned pixels outside the VSM penumbra on >= 99% of them, the
share that may flip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.render import ibl as jibl
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu_torch.convert import light_map_from_numpy, template_from_numpy
from stillleben_tpu_torch.render import ibl as pibl
from stillleben_tpu_torch.render import light_map as plm
from stillleben_tpu_torch.render.frame import FrameConfig
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_full_meshes, check_id_agreement, jax_full_template, jax_light_map,
    render_pair, settled_scene, to_numpy, vsm_penumbra, well_conditioned,
)

MODES = {  # (port keywords, JAX environment)
    "nearest": (dict(prefilter="nearest"), {"SL_IBL_PREFILTER": "nearest"}),
    "cubemap irradiance": (dict(sh=False), {"SL_IBL_SH": "0"}),
    "both": (dict(prefilter="nearest", sh=False),
             {"SL_IBL_PREFILTER": "nearest", "SL_IBL_SH": "0"}),
}


@pytest.fixture(scope="module")
def light_map():
    return jax_light_map()


def _surface(seed, H=24, W=32):
    """Normals, view vectors and materials of an (H, W) image; roughness
    over the whole range, texel centres of the BRDF table for NoV and
    roughness so its truncating lookup cannot flip."""
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(H, W, 3))
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    V = normal + 0.5 * rng.normal(size=(H, W, 3))
    V = (V / np.linalg.norm(V, axis=-1, keepdims=True)).astype(np.float32)
    NoV = np.clip((normal * V).sum(-1), 1e-5, 1.0)
    NoV = ((np.floor(NoV * 256) + 0.75) / 256).astype(np.float32)
    roughness = ((rng.integers(12, 256, size=(H, W)) + 0.75) / 256).astype(np.float32)
    F0 = rng.uniform(0.04, 1.0, size=(H, W, 3)).astype(np.float32)
    return normal, V, NoV, roughness, F0, F0, rng.random((H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_ibl_term_mode_matches_jax(light_map, monkeypatch, mode):
    kw, env = MODES[mode]
    data = to_numpy(light_map.data)
    lut = np.asarray(jlm.get_brdf_lut())
    monkeypatch.setitem(plm._BRDF_LUT_CACHE, "cpu", torch.tensor(lut))
    args = _surface(7)
    for k, v in env.items():  # read at call time: ibl_term is not jitted here
        monkeypatch.setenv(k, v)
    ref = np.asarray(jibl.ibl_term(type(data)(*(jnp.asarray(x) for x in data)),
                                   *(jnp.asarray(x) for x in args)))
    lm = light_map_from_numpy(data, "cpu")
    got = pibl.ibl_term(lm, *(torch.from_numpy(x) for x in args), **kw).numpy()
    default = pibl.ibl_term(lm, *(torch.from_numpy(x) for x in args)).numpy()
    assert (np.abs(got - default) > 1e-3 * np.abs(default)).any(-1).mean() > 0.05, \
        "the mode changed next to nothing"
    lod = args[3].astype(np.float64) * 4.0
    half = np.abs(lod - np.floor(lod) - 0.5) < 1e-5
    far = (np.abs(got - ref) > 1e-4 * np.abs(ref) + 1e-6 * np.abs(ref).max()).any(-1)
    assert not (far & ~half).any(), f"{mode}: off by {np.abs(got - ref)[~half].max()}"
    assert far.mean() <= 0.005


def test_frame_ibl_modes_match_jax(tmp_path_factory, light_map, monkeypatch):
    kw, env = MODES["both"]
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")),
                                              native_decomp=False)
    tpl = jax_full_template((blob, cube, sphere), light_map)
    poses, cam, light = settled_scene(tpl)
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    common = dict(width=W, height=H, shading="pbr", ssao=False, max_lights=1,
                  shadow_size=SHADOW_SIZE, shadow_mode="vsm", sample_textures=True,
                  sample_stickers=False)
    jcfg = JaxFrameConfig(shading_dtype="f32", **common)
    cfg = FrameConfig(ibl_prefilter=kw.get("prefilter", "trilinear"), ibl_sh=kw.get("sh", True),
                      **common)
    for k, v in env.items():  # the JAX frame runs eagerly: read now
        monkeypatch.setenv(k, v)
    fj, fp, tri_j, tri_p, v = render_pair(tpl, ptpl, poses, cam, light, jcfg, cfg)
    agree = check_id_agreement(tri_p, tri_j, v, v[..., 2])
    well = well_conditioned(fj.barycentric_coeffs, fp.barycentric_coeffs, tri_j, v)
    calm = agree & well & ~vsm_penumbra(fj, tpl, poses, cam, light, jcfg)
    assert calm.sum() > 200, "too few calm pixels"
    far = (np.abs(fp.hdr - fj.hdr) > 1e-4 * np.abs(fj.hdr) + 1e-6).any(-1)
    assert far[calm].mean() <= 0.01, f"{far[calm].mean():.4f} of the pixels flip"
