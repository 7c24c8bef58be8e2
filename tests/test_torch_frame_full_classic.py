"""The full frame (textures, background plane, image-based light, skybox,
SSAO: the "bench" case of ``test_torch_frame_full.py``) through the classic
span-class raster, ``FrameConfig(raster="classic")``, against the JAX
package's classic path (``SL_RASTER=classic``, its Pallas kernel in
interpret mode), at that file's tolerances. Then the peel through the
classic raster and through the brute-force oracle, each against the port's
own cell raster: the depth-peel floor reaches all three."""

import pytest
import torch

import test_torch_frame_full as full
from stillleben_tpu_torch.parallel.batch import settle_scene
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig, render_frame_core
from torch_port_scene import build_full_meshes, port_full_template


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SL_RASTER", "classic")
        mp.setenv("SL_FINE_TPG", "1")
        return full.make_full_frames(tmp_path_factory, full.jax_light_map(), "bench", "classic")


def test_classic_full_frame_ids_match_jax(frames):
    full.test_full_frame_ids_match_jax(frames)


def test_classic_full_frame_geometry_buffers_match_jax(frames):
    full.test_full_frame_geometry_buffers_match_jax(frames)


def test_classic_full_frame_colour_matches_jax(frames):
    full.test_full_frame_colour_matches_jax(frames)


def test_peel_through_every_raster(tmp_path_factory):
    """The alpha peel of the port's own template at 160x120 through the cell
    raster, the classic raster and the oracle: the instance maps of the
    peeled frames agree on >= 97% of the pixels (the classic raster's own
    bound against the oracle), and every raster peels."""
    cube, sphere, blob, cutout = build_full_meshes(
        str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)
    tpl = port_full_template((cutout, sphere, blob), None, size=(160, 120))  # no light map
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, tpl,
                                       default_config(), 10)
    inputs = tpl.base_inputs
    otw = inputs.obj_to_world.clone()
    otw[:3] = poses[0]
    inputs = inputs._replace(obj_to_world=otw, cam_pose=cams[0])
    cfg = FrameConfig(width=160, height=120, max_lights=1, shadow_size=64, ssao=False,
                      alpha_peel=True)
    out = {}
    for name, c in (("cells", cfg), ("classic", cfg._replace(raster="classic")),
                    ("oracle", cfg._replace(tiled=False))):
        peeled = render_frame_core(tpl.render_atlas, inputs, c, light_map=tpl.light_map)
        first = render_frame_core(tpl.render_atlas, inputs, c._replace(alpha_peel=False),
                                  light_map=tpl.light_map)
        gained = peeled.valid & ~first.valid
        assert gained.sum() >= 10, f"{name}: the peel showed nothing behind the cutout"
        assert (peeled.valid | ~first.valid).all()
        out[name] = peeled
    for name in ("classic", "oracle"):
        same = (out[name].instance_index == out["cells"].instance_index).float().mean()
        assert same >= 0.97, (name, float(same))
