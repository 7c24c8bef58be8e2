"""The port on a CUDA device against the port on the CPU (GPU-marked; they
skip without a card). This file imports no jax: the card's machine has
none, and runs it with ``--noconftest`` (README.md).

The CPU path is held to the JAX package by the other ``test_torch_*``
files; these tests close the chain on the card with the same rules: the
cell lists identical, triangle ids by the tie/edge rule, coordinates and
normals within 1e-5 where the ids agree and the barycentrics are
well-conditioned (where they are not: coordinates 1e-4, normals 1e-3),
rgb within 1 LSB, one physics substep within 1e-5. The full frame
(textures, plane, light map, SSAO) adds: hdr within 2e-4 relative on >= 99%
of the well-conditioned pixels outside the plane (which lies in the VSM
penumbra: 1e-2 on >= 99.9% of its pixels, 5e-2 on all), rgb within 1 LSB on
>= 99.5% of the agreeing pixels.
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
from stillleben_tpu_torch.assets.procedural import sky_equirect
from stillleben_tpu_torch.render.light_map import LightMap
from torch_port_scene import (
    H, SUN, W, build_full_meshes, build_meshes, check_id_agreement, port_full_template,
    port_template, well_conditioned,
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
    for a, b in zip(c[:3], g[:3]):  # LT, ids, cell_tile
        assert torch.equal(a, b.cpu())


def test_frame_on_cuda_matches_cpu(scene):
    cpu, gpu, poses, cam, light = scene
    cfg = FrameConfig(width=W, height=H, max_lights=1, shadow_size=64, ssao=False,
                      sample_textures=False, sample_stickers=False)
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


def test_full_frame_on_cuda_matches_cpu(tmp_path_factory):
    """160x120, the small bench-full configuration, ``device`` passed
    explicitly to both templates: a comparison, not a fallback."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True)
    size = (160, 120)
    lm = LightMap.from_equirect(sky_equirect(), lights=[SUN], device="cpu")
    cpu = port_full_template((blob, cube, sphere), lm, "cpu", size=size)
    gpu = port_full_template((blob, cube, sphere), lm, "cuda", size=size)
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, cpu, default_config(), 10)
    compare_full_frames(cpu, gpu, poses[0], cams[0], lights[0], size)


def compare_full_frames(cpu, gpu, poses, cam, light, size):
    """The checks of the card-against-CPU full frame; returns a summary."""
    w, h = size
    cfg = FrameConfig(width=w, height=h, max_lights=1, shadow_size=256, ssao=True,
                      sample_textures=True, sample_stickers=False, tile_capacity=128)
    fc = render_with_poses(cpu, poses, cam, cfg, light)
    gdev = gpu.base_z.device
    fg = render_with_poses(gpu, poses.to(gdev), cam.to(gdev), cfg, light.to(gdev))
    tris = []
    for tpl in (cpu, gpu):
        dev = tpl.base_z.device
        n = poses.shape[0]
        otw = tpl.base_inputs.obj_to_world.clone()
        otw[:n] = poses.to(dev)
        inp = tpl.base_inputs._replace(obj_to_world=otw, cam_pose=cam.to(dev))
        geom = geometry_stage(tpl.render_atlas, inp, w, h)
        tris.append(rasterize_tiled(geom, tpl.render_atlas, inp, w, h).tri_id.cpu().numpy())
        if tpl is cpu:
            v = geom.pix_hom[tpl.render_atlas.faces.long()].numpy()
    agree = check_id_agreement(tris[1], tris[0], v, v[..., 2])
    hit = agree & (tris[0] >= 0)
    assert hit.sum() > 1000, "scene unexpectedly empty"
    for name in ("instance_index", "class_index", "vertex_indices", "valid"):
        a, b = getattr(fg, name).cpu().to(torch.int32), getattr(fc, name).to(torch.int32)
        diff = (a != b).reshape(h, w, -1).any(-1).numpy()
        assert not (diff & agree).any(), f"{name} differs where the triangle ids agree"
    well = well_conditioned(fc.barycentric_coeffs.numpy(), fg.barycentric_coeffs.cpu().numpy(),
                            tris[0], v)
    calm = agree & (well | (tris[0] < 0))
    for name, ill_tol in (("object_coordinates", 1e-4), ("cam_coordinates", 1e-4),
                          ("normals", 1e-3)):
        a, b = getattr(fg, name).cpu().numpy(), getattr(fc, name).numpy()
        np.testing.assert_allclose(a[calm], b[calm], rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(a[hit & ~well], b[hit & ~well], rtol=0, atol=ill_tol,
                                   err_msg=name)
    hg, hc = fg.hdr.cpu().numpy(), fc.hdr.numpy()
    err = np.abs(hg - hc)
    plane = (fc.instance_index.to(torch.int32) == 0).numpy() & fc.valid.numpy()
    objs = hit & well & ~plane
    far = (err > 2e-4 * np.abs(hc) + 1e-5).any(-1)
    assert far[objs].mean() <= 0.01, far[objs].mean()
    on_plane = hit & plane
    assert (err[on_plane] <= 1e-2 * np.abs(hc[on_plane]) + 1e-4).all(-1).mean() >= 0.999
    np.testing.assert_allclose(hg[on_plane], hc[on_plane], rtol=5e-2, atol=1e-4)
    back = agree & ~fc.valid.numpy()
    np.testing.assert_allclose(hg[back], hc[back], rtol=1e-5, atol=1e-6)
    d = (fg.rgb.cpu().to(torch.int32) - fc.rgb.to(torch.int32)).abs().numpy().max(-1)
    assert (d[agree] <= 1).mean() >= 0.995 and d[agree].max() <= 3
    return dict(ids_agree=float(agree.mean()), object_px=int(hit.sum()),
                hdr_far_share=float(far[objs].mean()), rgb_max=int(d[agree].max()))
