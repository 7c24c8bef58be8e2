"""The port on a CUDA device against the port on the CPU (GPU-marked; they
skip without a card). This file imports no jax: the card's machine has
none, and runs it with ``--noconftest`` (README.md).

The CPU path is held to the JAX package by the other ``test_torch_*``
files; these tests close the chain on the card with the same rules: the
cell lists identical, triangle ids by the tie/edge rule, coordinates and
normals within 1e-5 where the ids agree and the barycentrics are
well-conditioned (where they are not: coordinates 1e-4, normals 1e-3),
rgb within 1 LSB, one physics substep within 1e-5.
"""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.parallel.batch import render_with_poses, settle_scene
from stillleben_tpu_torch.physics.engine import step_fn
from stillleben_tpu_torch.physics.tabletop import FRAME_TIME, SUBSTEPS, settle, stack_objects
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.rasterize import geometry_stage
from stillleben_tpu_torch.render.rasterize_tiled import BIG_CAPACITY, build_cells, rasterize_tiled
from torch_port_scene import (
    H, W, build_meshes, check_id_agreement, port_template, well_conditioned,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these tests compare the port on the card with the CPU")
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True)
    cpu, gpu = port_template(meshes, "cpu"), port_template(meshes, "cuda")
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, cpu, default_config(), 10)
    return cpu, gpu, poses[0], cams[0], lights[0]


def _inputs(tpl, poses, cam, dev):
    return tpl.base_inputs._replace(obj_to_world=poses.to(dev), cam_pose=cam.to(dev))


def test_cells_on_cuda_match_cpu(scene):
    cpu, gpu, poses, cam, _ = scene
    geom = geometry_stage(cpu.render_atlas, _inputs(cpu, poses, cam, "cpu"), W, H)
    v = geom.pix_hom[cpu.render_atlas.faces.long()]
    act = torch.ones(v.shape[0], dtype=torch.bool)
    c = build_cells(v, v[..., 2], act, W, H, 0.1, 10.0, BIG_CAPACITY)
    g = build_cells(v.cuda(), v[..., 2].cuda(), act.cuda(), W, H, 0.1, 10.0, BIG_CAPACITY)
    for a, b in zip(c[:3], g[:3]):  # G, ids, cell_tile
        assert torch.equal(a, b.cpu())


def test_frame_on_cuda_matches_cpu(scene):
    cpu, gpu, poses, cam, light = scene
    cfg = FrameConfig(width=W, height=H, max_lights=1, shadow_size=64)
    fc = render_with_poses(cpu, poses, cam, cfg, light)
    fg = render_with_poses(gpu, poses.cuda(), cam.cuda(), cfg, light.cuda())
    tris = []
    for tpl, dev in ((cpu, "cpu"), (gpu, "cuda")):
        inp = _inputs(tpl, poses, cam, dev)
        geom = geometry_stage(tpl.render_atlas, inp, W, H)
        tris.append(rasterize_tiled(geom, tpl.render_atlas, inp, W, H).tri_id.cpu().numpy())
    geom = geometry_stage(cpu.render_atlas, _inputs(cpu, poses, cam, "cpu"), W, H)
    v = geom.pix_hom[cpu.render_atlas.faces.long()].numpy()
    assert (tris[0] >= 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tris[1], tris[0], v, v[..., 2])
    hit = agree & (tris[0] >= 0)
    well = well_conditioned(fc.barycentric_coeffs.numpy(), fg.barycentric_coeffs.cpu().numpy(),
                            tris[0], v)
    assert (hit & well).sum() >= 0.4 * hit.sum(), "too few well-conditioned pixels"
    # coordinates and normals interpolate with the barycentrics: 1e-5 where
    # those are well-conditioned on both devices; where they are not, the
    # barycentrics themselves differ by up to ~1e-3, which moves
    # coordinates (a few mm across a triangle) by < 1e-4 and unit normals
    # (which turn across a triangle) by < 1e-3
    calm = agree & (well | (tris[0] < 0))
    for name, ill_tol in (("object_coordinates", 1e-4), ("cam_coordinates", 1e-4),
                          ("normals", 1e-3)):
        a, b = getattr(fg, name).cpu().numpy(), getattr(fc, name).numpy()
        np.testing.assert_allclose(a[calm], b[calm], rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[hit & ~well], b[hit & ~well], rtol=0, atol=ill_tol,
                                   err_msg=name)
    d = (fg.rgb.cpu().to(torch.int32) - fc.rgb.to(torch.int32)).abs().numpy()
    assert d[agree].max() <= 1


def test_substep_on_cuda_matches_cpu(scene):
    cpu, gpu, *_ = scene
    cfg = default_config()
    nb = cpu.tabletop_geom.diameter.shape[0]
    q = torch.nn.functional.normalize(
        torch.randn(2, nb, 4, generator=torch.Generator().manual_seed(6)), dim=-1
    )
    s0 = settle(cpu.hull_atlas, cpu.body_params, stack_objects(cpu.tabletop_geom, cpu.base_z, q),
                cpu.floor, cpu.pairs, cpu.tabletop_geom, cfg, iterations=6)  # a pile in contact
    dt = FRAME_TIME / SUBSTEPS
    sc, rep, _ = step_fn(cpu.hull_atlas, cpu.body_params, s0, cpu.floor, cpu.pairs, dt, cfg)
    assert torch.isfinite(rep.min_separation).any(), "no contacts in the test state"
    s0g = type(s0)(*(x.cuda() for x in s0))
    sg, _, _ = step_fn(gpu.hull_atlas, gpu.body_params, s0g, gpu.floor, gpu.pairs, dt, cfg)
    for a, b, name in zip(sg, sc, s0._fields):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-5, err_msg=name)
