"""A whole PBR frame through the classic span-class raster
(``FrameConfig(raster="classic")``, K2 on the card) against the JAX
package's classic path (``SL_RASTER=classic``, its Pallas kernel in
interpret mode), at the tolerances of the cell-raster frame test
(``test_torch_frame.py``): ids by the tie/edge rule, float ground truth 1e-5
at well-conditioned pixels, hdr 1e-4 relative, rgb 1 LSB, VSM moments 1e-5.
Also the port's classic frame against its brute-force oracle: the instance
maps differ on under 3% of the pixels, the JAX package's own bound for its
classic path (tests/test_pallas.py)."""

import pytest
import torch

import test_torch_frame as cells_frame
from stillleben_tpu_torch.parallel.batch import render_with_poses, settle_scene, template_from_scene
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.scene.scene import Object, Scene
from torch_port_scene import build_meshes


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SL_RASTER", "classic")
        mp.setenv("SL_FINE_TPG", "1")
        return cells_frame.make_frames(tmp_path_factory, "classic")


def test_classic_frame_ids_match_jax(frames):
    cells_frame.test_frame_ids_match_jax(frames)


def test_classic_frame_geometry_buffers_match_jax(frames):
    cells_frame.test_frame_geometry_buffers_match_jax(frames)


def test_classic_frame_colour_matches_jax(frames):
    cells_frame.test_frame_colour_matches_jax(frames)


def test_classic_shadow_moments_match_jax(frames):
    cells_frame.test_shadow_moments_match_jax(frames)


def test_classic_frame_against_oracle(tmp_path_factory):
    """At 160x120, where the tile lists hold the small scene (at 48x48 the
    dense mesh crowds a few tiles past their 256 slots, and the farthest
    triangles drop by design)."""
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)
    scene = Scene((160, 120))
    for mesh in meshes:
        scene.add_object(Object(mesh))
    tpl = template_from_scene(scene, "cpu")
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(2), 1, tpl,
                                       default_config(), 10)
    cfg = cells_frame.CFG._replace(width=160, height=120, raster="classic")
    fk = render_with_poses(tpl, poses[0], cams[0], cfg, lights[0])
    fb = render_with_poses(tpl, poses[0], cams[0], cfg._replace(tiled=False), lights[0])
    assert fb.valid.sum() > 500, "scene unexpectedly empty"
    mismatch = (fk.instance_index != fb.instance_index).float().mean()
    assert mismatch < 0.03, float(mismatch)
