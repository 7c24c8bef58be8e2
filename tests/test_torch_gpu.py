"""The port on a CUDA device against the port on the CPU (GPU-marked; they
skip without a card). This file imports no jax: the card's machine has
none, and runs it with ``--noconftest`` (README.md).

The CPU path is held to the JAX package by the other ``test_torch_*``
files; these tests close the chain on the card with the same rules: the
cell lists identical, triangle ids by the tie/edge rule, coordinates and
normals within 1e-5 where the ids agree and the barycentrics are
well-conditioned (where they are not: coordinates 1e-4, normals 1e-3),
rgb within 1 LSB, one physics substep within 1e-5. The pose gradient of the
refinement loss (``__graft_entry__.py::make_train_step``'s, with the pixels
where the two devices' instance maps disagree masked out) within 2e-2 of
each object's largest component, the tolerance of the CPU parity tests
with VSM on (``test_torch_grad.py``), and one refinement step that
descends. The full frame
(textures, plane, light map, SSAO) adds: hdr within 2e-4 relative on >= 99%
of the well-conditioned pixels outside the plane (which lies in the VSM
penumbra: 1e-2 on >= 99.9% of its pixels, 5e-2 on all), rgb within 1 LSB on
>= 99.5% of the agreeing pixels. The same rules hold the frame
configurations of the tuned and the reference-quality rungs, but for three
discontinuities: with the 1-tap VSM the object pixels are held outside its
penumbra too, with PCF the pixels next to a compare (at most 5% of them)
are not held at all, and with the reference SSAO a pixel's rgb may move
by 16 LSB (flipped samples of 1/64 each), 99.5% still within 1.
"""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.parallel.batch import (
    apply_pose_delta_matrix, render_with_poses, settle_scene,
)
from stillleben_tpu_torch.physics.engine import step_fn
from stillleben_tpu_torch.physics.tabletop import FRAME_TIME, SUBSTEPS, settle, stack_objects
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.rasterize import geometry_stage
from stillleben_tpu_torch.render.rasterize_tiled import BIG_CAPACITY, build_cells, rasterize_tiled
from stillleben_tpu_torch.render.shadow import (
    SHADOW_BIAS, render_shadow_maps, shadow_factor_vsm_planar,
)
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
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)
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
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                              native_decomp=False)
    size = (160, 120)
    lm = LightMap.from_equirect(sky_equirect(), lights=[SUN], device="cpu")
    cpu = port_full_template((blob, cube, sphere), lm, "cpu", size=size)
    gpu = port_full_template((blob, cube, sphere), lm, "cuda", size=size)
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, cpu, default_config(), 10)
    compare_full_frames(cpu, gpu, poses[0], cams[0], lights[0], size)


def full_config(size, rung=None):
    """The small bench-full frame configuration at ``size`` (W, H), or the
    one of a benchmark rung: "tuned" (TUNED.json's back-face cull, 1-tap
    VSM, nearest prefiltered level) or "refmode" (bench.py's reference
    quality: PCF, the reference SSAO, 3 shadowed light slots)."""
    cfg = FrameConfig(width=size[0], height=size[1], max_lights=1, shadow_size=256, ssao=True,
                      sample_textures=True, sample_stickers=False, tile_capacity=128)
    if rung == "tuned":
        return cfg._replace(backface_cull=True, vsm_taps=1, ibl_prefilter="nearest")
    if rung == "refmode":
        return cfg._replace(shadow_mode="pcf", ssao_mode="reference", max_lights=3)
    assert rung is None, rung
    return cfg


@pytest.mark.parametrize("rung", ["tuned", "refmode"])
def test_rung_frame_on_cuda_matches_cpu(tmp_path_factory, rung):
    """The small full scene in the frame configuration of each rung."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                              native_decomp=False)
    size = (160, 120)
    lm = LightMap.from_equirect(sky_equirect(), lights=[SUN], device="cpu")
    cpu = port_full_template((blob, cube, sphere), lm, "cpu", size=size)
    gpu = port_full_template((blob, cube, sphere), lm, "cuda", size=size)
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, cpu, default_config(), 10)
    compare_full_frames(cpu, gpu, poses[0], cams[0], lights[0], size, full_config(size, rung))


def _frame_inputs(tpl, poses, cam, light):
    n = poses.shape[0]
    otw = tpl.base_inputs.obj_to_world.clone()
    otw[:n] = poses
    dirs = tpl.base_inputs.light_directions.clone()
    dirs[0] = light
    return tpl.base_inputs._replace(obj_to_world=otw, cam_pose=cam, light_directions=dirs)


def _world(frame, cam):
    """(3, H, W) world positions of a frame's pixels, from its camera
    coordinates."""
    h, w = frame.valid.shape
    cc = frame.cam_coordinates[..., :3].reshape(-1, 3).T
    return (cam[:3, :3] @ cc + cam[:3, 3:4]).reshape(3, h, w)


def _point_tap_penumbra(tpl, poses, cam, light, cfg, frame):
    """(H, W) pixels of ``frame`` (rendered from ``tpl`` on the CPU) whose
    1-tap VSM shadow factor lies strictly between 0 and 1."""
    maps, mats = render_shadow_maps(tpl.render_atlas, _frame_inputs(tpl, poses, cam, light),
                                    cfg.shadow_size, cfg.max_lights, cfg.raster,
                                    cfg.fine_tiles_per_cell, "vsm", cfg.shadow_cull)
    sf = shadow_factor_vsm_planar(maps, mats, 0, _world(frame, cam), taps=1)
    return ((sf > 1e-3) & (sf < 1 - 1e-3)).numpy()


def _pcf_near_compare(tpl, poses, cam, light, cfg, frame):
    """(H, W) pixels of ``frame`` (rendered from ``tpl`` on the CPU) with a
    PCF tap of a shadowed light within 1e-5 of its compare ``z - bias <=
    stored``, or with a tap coordinate within 1e-4 of a texel's edge, in
    float64 from the frame's own positions."""
    inp = _frame_inputs(tpl, poses, cam, light)
    maps, mats = render_shadow_maps(tpl.render_atlas, inp, cfg.shadow_size, cfg.max_lights,
                                    cfg.raster, cfg.fine_tiles_per_cell, "pcf", cfg.shadow_cull)
    world = _world(frame, cam).double()
    S = maps.shape[1]
    near = torch.zeros(frame.valid.shape, dtype=torch.bool)
    for i in range(maps.shape[0]):
        A = mats[i].double()
        u, v, z = (A[r, 0] * world[0] + A[r, 1] * world[1] + A[r, 2] * world[2] + A[r, 3]
                   for r in range(3))
        flat = maps[i].reshape(-1).double()
        for dy in (-1.5, -0.5, 0.5, 1.5):
            for dx in (-1.5, -0.5, 0.5, 1.5):
                uu, vv = u + dx, v + dy
                ui = torch.clamp(uu.trunc(), 0, S - 1).long()
                vi = torch.clamp(vv.trunc(), 0, S - 1).long()
                near |= (z - SHADOW_BIAS - flat[vi * S + ui]).abs() <= 1e-5
                near |= ((uu - uu.round()).abs() < 1e-4) | ((vv - vv.round()).abs() < 1e-4)
    return near.numpy()


def compare_full_frames(cpu, gpu, poses, cam, light, size, cfg=None):
    """The checks of the card-against-CPU full frame (``cfg``: the small
    bench-full configuration by default); returns a summary."""
    w, h = size
    cfg = full_config(size) if cfg is None else cfg
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
        tris.append(rasterize_tiled(geom, tpl.render_atlas, inp, w, h,
                                    backface_cull=cfg.backface_cull).tri_id.cpu().numpy())
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
    if cfg.shadow_mode == "vsm" and cfg.vsm_taps == 1:
        # the point tap reads one texel's moments: a sloped surface lies up
        # to half a texel's slope behind its own stored depth, and under the
        # minimal variance the Chebyshev bound turns last bits of position
        # into 1e-3 of colour (on the CPU a 3e-7 change of the poses moved
        # 5.4% of the object pixels beyond 2e-4, 0.4% outside this penumbra)
        objs &= ~_point_tap_penumbra(cpu, poses, cam, light, cfg, fc)
    on_plane = hit & plane
    if cfg.shadow_mode == "pcf":
        # PCF's 16 hard compares flip on last-bit differences of the depths:
        # the pixels with a tap within 1e-5 of its compare, or on a texel's
        # edge, are not held (on the CPU, 2.2% of the hit pixels; a 3e-7
        # change of the poses moved them by up to 54 LSB and the rest by 1)
        near = _pcf_near_compare(cpu, poses, cam, light, cfg, fc) & fc.valid.numpy()
        assert near[hit].mean() <= 0.05, near[hit].mean()
        objs, on_plane, held = objs & ~near, on_plane & ~near, agree & ~near
    else:
        held = agree
    far = (err > 2e-4 * np.abs(hc) + 1e-5).any(-1)
    assert far[objs].mean() <= 0.01, far[objs].mean()
    assert (err[on_plane] <= 1e-2 * np.abs(hc[on_plane]) + 1e-4).all(-1).mean() >= 0.999
    np.testing.assert_allclose(hg[on_plane], hc[on_plane], rtol=5e-2, atol=1e-4)
    back = agree & ~fc.valid.numpy()
    np.testing.assert_allclose(hg[back], hc[back], rtol=1e-5, atol=1e-6)
    d = (fg.rgb.cpu().to(torch.int32) - fc.rgb.to(torch.int32)).abs().numpy().max(-1)
    # a flipped sample of the reference SSAO moves a pixel's occlusion by up
    # to 1/64 (tests/test_torch_ssao.py), 4 LSB of a bright colour; the
    # refmode frame had one pixel 8 LSB apart on an H100, 99.98% within 1
    rgb_max = 16 if cfg.ssao and cfg.ssao_mode == "reference" else 3
    assert (d[held] <= 1).mean() >= 0.995 and d[held].max() <= rgb_max, d[held].max()
    return dict(ids_agree=float(agree.mean()), object_px=int(hit.sum()),
                hdr_far_share=float(far[objs].mean()), rgb_max=int(d[held].max()))


def refine_loss(tpl, poses, cam, light, cfg, target, delta, mask=None):
    """The loss of the pose-refinement train step
    (``__graft_entry__.py::make_train_step``): mean((hdr - target)^2) over
    the rgb channels, ``mask`` (H, W) zeroing pixels, plus 1e-6 |delta|^2.
    Returns (loss, frame)."""
    f = render_with_poses(tpl, apply_pose_delta_matrix(poses, delta), cam, cfg, light)
    d = f.hdr[..., :3] - target[..., :3]
    if mask is not None:
        d = d * mask[..., None]
    return (d * d).mean() + 1e-6 * (delta * delta).sum(), f


def compare_gradients(cpu, gpu, poses, cam, light, size, cfg=None, tol=2e-2):
    """d loss / d delta of ``refine_loss`` at delta = 0.02 on the card
    against the CPU, the target being the CPU frame at ``poses``; the
    pixels where the two perturbed instance maps differ are masked out of
    both losses. Every object the CPU frame shows gets a gradient, and on
    the card each is within ``tol`` of that object's largest CPU
    component. Returns a summary."""
    cfg = full_config(size) if cfg is None else cfg
    gdev = gpu.base_z.device
    with torch.no_grad():
        target = render_with_poses(cpu, poses, cam, cfg, light).hdr
    delta0 = torch.full((poses.shape[0], 6), 0.02)
    grads, insts = [], []
    for tpl, dev in ((cpu, "cpu"), (gpu, gdev)):
        with torch.no_grad():
            _, f = refine_loss(tpl, poses.to(dev), cam.to(dev), light.to(dev), cfg,
                               target.to(dev), delta0.to(dev))
        insts.append(f.instance_index.to(torch.int32).cpu())
    mask = (insts[0] == insts[1]).to(torch.float32)
    for tpl, dev in ((cpu, "cpu"), (gpu, gdev)):
        delta = delta0.to(dev).requires_grad_(True)
        loss, _ = refine_loss(tpl, poses.to(dev), cam.to(dev), light.to(dev), cfg,
                              target.to(dev), delta, mask.to(dev))
        (g,) = torch.autograd.grad(loss, delta)
        grads.append(g.cpu())
    gc, gg = grads
    assert torch.isfinite(gg).all(), gg
    shown = [i for i in range(poses.shape[0]) if (insts[0] == i + 1).any()]
    assert shown, "no object in view"
    scale = gc.abs().amax(1)
    assert (scale[shown] > 0).all(), f"an object in view without a gradient: {scale}"
    err = (gg - gc).abs().amax(1) / torch.clamp(scale, min=1e-30)
    assert (err[shown] <= tol).all(), f"per-object relative errors {err.tolist()} > {tol}"
    return dict(masked_share=float(1.0 - mask.mean()), objects_in_view=len(shown),
                max_rel_err=float(err[shown].max()), rel_err=[float(e) for e in err[shown]])


def small_full_templates(tmp_path_factory):
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                              native_decomp=False)
    size = (160, 120)
    lm = LightMap.from_equirect(sky_equirect(), lights=[SUN], device="cpu")
    cpu = port_full_template((blob, cube, sphere), lm, "cpu", size=size)
    gpu = port_full_template((blob, cube, sphere), lm, "cuda", size=size)
    poses, cams, lights = settle_scene(torch.Generator().manual_seed(4), 1, cpu, default_config(), 10)
    return cpu, gpu, poses[0], cams[0], lights[0], size


def test_pose_gradient_on_cuda_matches_cpu(tmp_path_factory):
    """The refinement loss's pose gradient, the card (K1 in the forward)
    against the CPU (the plain z-buffer), the small bench-full scene."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cpu, gpu, poses, cam, light, size = small_full_templates(tmp_path_factory)
    print(compare_gradients(cpu, gpu, poses, cam, light, size))


def test_refine_step_on_cuda(tmp_path_factory):
    """One step of the train step on the card from delta = 0.02: finite, a
    gradient for every object in view, and a step of 1e-3 along -grad (unit
    norm) lowers the loss."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _, gpu, poses, cam, light, size = small_full_templates(tmp_path_factory)
    cfg = full_config(size)
    poses, cam, light = poses.cuda(), cam.cuda(), light.cuda()
    with torch.no_grad():
        target = render_with_poses(gpu, poses, cam, cfg, light).hdr
    delta = torch.full((poses.shape[0], 6), 0.02, device="cuda", requires_grad=True)
    loss, f = refine_loss(gpu, poses, cam, light, cfg, target, delta)
    loss.backward()
    g = delta.grad
    assert torch.isfinite(g).all()
    inst = f.instance_index.to(torch.int32)
    for i in range(poses.shape[0]):
        if (inst == i + 1).any():
            assert g[i].abs().max() > 0, f"object {i} is in view and has no gradient"
    with torch.no_grad():
        step = delta - 1e-3 * g / g.norm()
        lower, _ = refine_loss(gpu, poses, cam, light, cfg, target, step)
    assert float(lower) < float(loss), (float(lower), float(loss))


def test_ibl_light_map_on_cuda_matches_cpu(tmp_path_factory):
    """``LightMap("sky.ibl")`` (the loaders' fixture: the run-length sky
    ``.hdr`` and the bench's sun) precomputed on the card and on the CPU:
    the same lights, and the data within the CPU parity tolerance of
    ``test_torch_light_map.py`` (1e-4 relative, 1e-4 of the cubemap's peak)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from stillleben_tpu_torch.assets.procedural import write_loader_fixtures

    ibl = write_loader_fixtures(str(tmp_path_factory.mktemp("fixtures")), subdiv=1)["ibl"]
    cpu, gpu = LightMap(ibl, device="cpu"), LightMap(ibl, device="cuda")
    np.testing.assert_array_equal(gpu.light_directions, cpu.light_directions)
    np.testing.assert_array_equal(gpu.light_colors, cpu.light_colors)
    peak = float(cpu.data.cubemap.abs().max())
    for name in type(cpu.data)._fields:
        g, c = getattr(gpu.data, name), getattr(cpu.data, name)
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4, atol=1e-4 * peak,
                                   err_msg=name)


def test_loaded_glb_scene_renders_with_k1(tmp_path_factory, monkeypatch):
    """A scene of loaded meshes (the textured blob from its GLB, the cube
    from FBX, ``primitive://sphere``) through the public API on the card:
    every K1 call of the render (camera and shadow) equals its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import write_loader_fixtures
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    d = tmp_path_factory.mktemp("fixtures")
    fx = write_loader_fixtures(str(d), subdiv=3)
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(d / "mesh_cache"))
    sl.init()
    blob, cube, sphere = sl.Mesh.load_threaded([fx["glb"], fx["fbx"], "primitive://sphere"])
    blob.center_bbox()
    for i, (mesh, diag) in enumerate(((blob, 0.25), (cube, 0.2), (sphere, 0.15))):
        mesh.scale_to_bbox_diagonal(diag)
        mesh.class_index = i + 1
    scene = sl.Scene((160, 120))
    scene.seed(2)
    for mesh in (blob, cube, sphere, blob):
        scene.add_object(sl.Object(mesh))
    scene.simulate_tabletop_scene()
    calls = []
    original = rt.cell_raster

    def record(*args):
        calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return original(*args)

    monkeypatch.setattr(rt, "cell_raster", record)
    result = sl.RenderPass().render(scene)
    assert (result.instance_index().to(torch.int32) > 0).any()
    assert sorted({a[7] for a in calls}) == [16, 32], "no camera or shadow raster"
    for args in calls:
        kernel, plain = cr.cell_raster(*args), cr.cell_raster_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(kernel, plain)), f"tile {args[7]}"


def test_decoded_texture_scene_on_cuda(tmp_path_factory, monkeypatch):
    """Phase 18's scene check, small: the blob textured from a JPEG (.mtl), a
    GLB with an embedded JPEG, the plane from a TGA and ``LightMap(.ibl)``
    whose ``REFfile`` is a JPEG, settled and rendered on the card; every K1
    call equals its plain version, and the frame equals that of the same
    scene whose images are their decoded pixels (PNG twins, the plane's
    array)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import write_image_fixtures
    from stillleben_tpu_torch.assets.tga import decode_tga
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    d = tmp_path_factory.mktemp("images")
    fx = write_image_fixtures(str(d), subdiv=3)
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(d / "mesh_cache"))
    sl.init()

    def compose(names, light, plane, physics):
        blob, glb, cube = sl.Mesh.load_threaded([fx[names[0]], fx[names[1]], "primitive://cube"],
                                                physics=physics)
        for i, (mesh, diag) in enumerate(((blob, 0.25), (glb, 0.25), (cube, 0.2))):
            mesh.center_bbox()
            mesh.scale_to_bbox_diagonal(diag)
            mesh.class_index = i + 1
        scene = sl.Scene((160, 120))
        scene.seed(3)
        for mesh in (blob, glb, cube, blob):
            scene.add_object(sl.Object(mesh))
        scene.light_map = sl.LightMap(fx[light])
        scene.background_plane_size = np.array([3.0, 3.0], np.float32)
        scene.background_plane_texture = plane
        return scene

    scene = compose(("obj_jpg", "glb_jpeg"), "ibl_jpg", sl.Texture2D(fx["plane_tga"]), True)
    with open(fx["plane_tga"], "rb") as f:
        twin = compose(("obj_png", "glb_png"), "ibl_png", sl.Texture2D(decode_tga(f.read())),
                       False)
    scene.simulate_tabletop_scene()
    for a, b in zip(scene.objects, twin.objects):
        b.set_pose(a.pose())
    twin.set_camera_pose(scene.camera_pose())
    twin.background_plane_pose = scene.background_plane_pose
    calls = []
    original = rt.cell_raster

    def record(*args):
        calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return original(*args)

    monkeypatch.setattr(rt, "cell_raster", record)
    result = sl.RenderPass().render(scene)
    monkeypatch.setattr(rt, "cell_raster", original)
    ref = sl.RenderPass().render(twin)
    assert (result.instance_index().to(torch.int32) > 0).any()
    assert sorted({a[7] for a in calls}) == [16, 32], "no camera or shadow raster"
    for args in calls:
        kernel, plain = cr.cell_raster(*args), cr.cell_raster_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(kernel, plain)), f"tile {args[7]}"
    for field in ("rgb", "depth", "instance_index", "normals"):
        assert torch.equal(getattr(result, field)(), getattr(ref, field)()), field


def test_webp_texture_scene_on_cuda(tmp_path_factory, monkeypatch):
    """Phase 19's scene check, small: the blob textured from a lossy WebP
    (.mtl), a GLB with an embedded WebP, the plane from a lossless WebP and
    ``LightMap(.ibl)`` whose ``REFfile`` is a WebP, settled and rendered on
    the card; every K1 call equals its plain version, and the frame equals
    that of the same scene whose images are their decoded pixels (PNG twins
    of the textures, a BMP twin of the panorama, the plane's array)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import stillleben_tpu_torch as sl
    from stillleben_tpu_torch.assets.procedural import write_webp_fixtures
    from stillleben_tpu_torch.assets.webp import decode_webp
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    d = tmp_path_factory.mktemp("webp")
    fx = write_webp_fixtures(str(d), subdiv=3)
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(d / "mesh_cache"))
    sl.init()

    def compose(names, light, plane, physics):
        blob, glb, cube = sl.Mesh.load_threaded([fx[names[0]], fx[names[1]], "primitive://cube"],
                                                physics=physics)
        for i, (mesh, diag) in enumerate(((blob, 0.25), (glb, 0.25), (cube, 0.2))):
            mesh.center_bbox()
            mesh.scale_to_bbox_diagonal(diag)
            mesh.class_index = i + 1
        scene = sl.Scene((160, 120))
        scene.seed(3)
        for mesh in (blob, glb, cube, blob):
            scene.add_object(sl.Object(mesh))
        scene.light_map = sl.LightMap(fx[light])
        scene.background_plane_size = np.array([3.0, 3.0], np.float32)
        scene.background_plane_texture = plane
        return scene

    scene = compose(("obj_webp", "glb_webp"), "ibl_webp", sl.Texture2D(fx["plane_webp"]), True)
    with open(fx["plane_webp"], "rb") as f:
        twin = compose(("obj_png", "glb_png"), "ibl_bmp", sl.Texture2D(decode_webp(f.read())),
                       False)
    scene.simulate_tabletop_scene()
    for a, b in zip(scene.objects, twin.objects):
        b.set_pose(a.pose())
    twin.set_camera_pose(scene.camera_pose())
    twin.background_plane_pose = scene.background_plane_pose
    calls = []
    original = rt.cell_raster

    def record(*args):
        calls.append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
        return original(*args)

    monkeypatch.setattr(rt, "cell_raster", record)
    result = sl.RenderPass().render(scene)
    monkeypatch.setattr(rt, "cell_raster", original)
    ref = sl.RenderPass().render(twin)
    assert (result.instance_index().to(torch.int32) > 0).any()
    assert sorted({a[7] for a in calls}) == [16, 32], "no camera or shadow raster"
    for args in calls:
        kernel, plain = cr.cell_raster(*args), cr.cell_raster_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(kernel, plain)), f"tile {args[7]}"
    for field in ("rgb", "depth", "class_index", "instance_index", "normals", "cam_coordinates"):
        assert torch.equal(getattr(result, field)(), getattr(ref, field)()), field


def compare_dashboards(cpu, gpu, H, W) -> dict:
    """A viewer dashboard (2H, 2W, 3) rendered on the card against the same
    on the CPU, by the frame rules above: the instance quadrant equal on
    >= 99.9% of its pixels (ids by the tie/edge rule), the RGB, normal and
    coordinate quadrants within 1 LSB on >= 99% of theirs. Returns the
    shares."""
    out = {"instances": float((gpu[H:, :W] == cpu[H:, :W]).all(-1).mean())}
    for name, q in (("rgb", np.s_[:H, :W]), ("normals", np.s_[:H, W:]), ("coords", np.s_[H:, W:])):
        d = np.abs(gpu[q].astype(np.int32) - cpu[q].astype(np.int32)).max(-1)
        out[name] = float((d <= 1).mean())
    assert out["instances"] >= 0.999 and min(out[k] for k in ("rgb", "normals", "coords")) >= 0.99, out
    return out


def test_dashboard_on_cuda_matches_cpu(tmp_path_factory):
    """``Viewer.dashboard`` of one scene (the small scene's three meshes,
    placed by hand, at 160x120) on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import stillleben_tpu_torch as sl

    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)
    sl.init(device="cpu")
    scene = sl.Scene((160, 120))
    for i, mesh in enumerate(meshes):
        o = sl.Object(mesh)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (0.25 * (i - 1), 0.05 * i, 0.1)
        o.set_pose(T)
        scene.add_object(o)
    scene.set_camera_look_at([0.6, -0.5, 0.5], [0.0, 0.0, 0.1])
    try:
        cpu = sl.Viewer(scene).dashboard()
        sl.init(device="cuda")
        gpu = sl.Viewer(scene).dashboard()
    finally:
        sl.init(device="cpu")
    compare_dashboards(cpu, gpu, 120, 160)


def test_checked_on_cuda():
    """``checked`` refuses an out-of-range gather and an integer division by
    zero on the card before the op runs (no device assert: the context
    works after), and passes clean calls through."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from stillleben_tpu_torch.utils import sanitize

    x = torch.arange(6, device="cuda")
    gather = sanitize.checked(lambda a, i: a[i], oob=True)
    with pytest.raises(sanitize.CheckError, match="out-of-bounds"):
        gather(x, torch.tensor([1, 6], device="cuda"))
    with pytest.raises(sanitize.CheckError, match="out-of-bounds"):
        sanitize.checked(lambda a: torch.gather(a, 0, torch.tensor([9], device="cuda")), oob=True)(x)
    with pytest.raises(sanitize.CheckError, match="division by zero"):
        sanitize.checked(lambda a: a // torch.zeros_like(a))(x)
    torch.cuda.synchronize()
    assert gather(x, torch.tensor([5, -6], device="cuda")).tolist() == [5, 0]
    assert int(x.sum()) == 15


def edge_rounding(v, tri, ys, xs, slack=4.0):
    """(E (n, 3), err (n, 3)) in float64: the edge functions of triangles
    ``tri`` at the pixel centres (xs + .5, ys + .5), and how far float32
    may leave them there. Each line coefficient is a difference of two
    products of the float32 vertices, known to ``eps`` of the products'
    magnitudes; E sums three such terms, so it is known to ``slack`` *
    eps * the sum of its terms' magnitudes."""
    eps = float(np.finfo(np.float32).eps)
    t = v[tri].astype(np.float64)
    nxt, prv = t[:, [1, 2, 0]], t[:, [2, 0, 1]]  # edge k is opposite vertex k
    L = np.cross(nxt, prv)
    mag = np.stack([np.abs(nxt[..., 1] * prv[..., 2]) + np.abs(nxt[..., 2] * prv[..., 1]),
                    np.abs(nxt[..., 2] * prv[..., 0]) + np.abs(nxt[..., 0] * prv[..., 2]),
                    np.abs(nxt[..., 0] * prv[..., 1]) + np.abs(nxt[..., 1] * prv[..., 0])], -1)
    X, Y = (xs + 0.5)[:, None], (ys + 0.5)[:, None]
    E = L[..., 0] * X + L[..., 1] * Y + L[..., 2]
    err = slack * eps * (mag[..., 0] * X + mag[..., 1] * Y + mag[..., 2])
    return E, err


def scan_rule_split(tri_kernel, tri_scan, v, depth_attr, rel=1e-6):
    """The pixels where the classic raster's two fine rules (the kernel's
    and the JAX package's XLA scan, C-7) pick different triangles, split
    in two: (a) where the two winners' depths (float64, from the float32
    vertices) lie within ``rel`` of each other, or where an edge function
    of either winner is within float32's rounding of 0 at the pixel centre
    (``edge_rounding``): the tie rules and C-5's rounding; (b) every other
    disagreement. Returns the (H, W) masks (a, b)."""
    ys, xs = np.nonzero(tri_kernel != tri_scan)
    tie = np.zeros(len(ys), bool)
    edge = np.zeros(len(ys), bool)
    depth = []
    for tri in (tri_kernel, tri_scan):
        t = tri[ys, xs]
        E, err = edge_rounding(v, np.maximum(t, 0), ys, xs)
        edge |= (t >= 0) & (np.abs(E) <= err).any(1)
        Es = E.sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            depth.append(np.where(t >= 0, (E * depth_attr[np.maximum(t, 0)]).sum(1) / Es, np.nan))
    both = np.isfinite(depth[0]) & np.isfinite(depth[1])
    tie[both] = (np.abs(depth[0] - depth[1])[both]
                 <= rel * np.maximum(np.abs(depth[0]), np.abs(depth[1]))[both])
    a = np.zeros(tri_kernel.shape, bool)
    b = np.zeros(tri_kernel.shape, bool)
    a[ys[tie | edge], xs[tie | edge]] = True
    b[ys[~(tie | edge)], xs[~(tie | edge)]] = True
    return a, b


def test_kernels_launch_on_the_tensors_device():
    """K1-K4 on ``cuda:1`` while ``cuda:0`` is current (the launch guard,
    C-16): each equal to its plain version. Needs two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.ops import fine_raster as fr
    from stillleben_tpu_torch.ops import smoke

    rng = np.random.default_rng(0)
    n, size = 300, 64
    p = rng.uniform(0, size, (n, 3, 2)).astype(np.float32)
    v = torch.from_numpy(np.concatenate([p, np.ones((n, 3, 1), np.float32)], -1))
    z = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32))
    act = torch.ones(n, dtype=torch.bool)
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    k1_in, k2_in = [], []
    orig1, orig2 = rt.cell_raster, rt.fine_raster
    rt.cell_raster = lambda *a: k1_in.append(a) or orig1(*a)
    rt.fine_raster = lambda *a, **kw: k2_in.append((a, kw)) or orig2(*a, **kw)
    try:
        rt.rasterize_vertices_cells(v, z, act, size, size, -1e-3, 1.0, 16)
        rt.rasterize_vertices(v, z, act, size, size, -1e-3, 1.0, 128, 16, 128, False)
    finally:
        rt.cell_raster, rt.fine_raster = orig1, orig2
    dev1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        for args in k1_in:
            a1 = [x.to(dev1) if isinstance(x, torch.Tensor) else x for x in args]
            got = cr.cell_raster(*a1)
            want = cr.cell_raster_plain(*args)
            assert got[0].device == dev1
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        for args, kw in k2_in:
            a1 = [x.to(dev1) if isinstance(x, torch.Tensor) else x for x in args]
            for tpg in (1, 4):
                got = fr.fine_raster(*a1, **dict(kw, tiles_per_cell=tpg))
                want = fr.fine_raster_plain(*args, **dict(kw, tiles_per_cell=tpg))
                assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        x = torch.randn(8, 128, device=dev1)
        assert torch.equal(smoke.double(x), smoke.double_reference(x))
        smoke.empty_launch(dev1)
        torch.cuda.synchronize(dev1)
        assert torch.cuda.current_device() == 0


def test_one_card_sharded_batch_equals_generate_batch(tmp_path_factory):
    """``generate_batch_sharded`` over a one-card mesh: every field equal to
    ``generate_batch`` of the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from stillleben_tpu_torch.parallel.batch import generate_batch, generate_batch_sharded
    from stillleben_tpu_torch.parallel.distributed import make_hybrid_mesh

    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True, native_decomp=False)
    tpl = port_template(meshes, "cuda")
    cfg = FrameConfig(width=W, height=H, max_lights=1, shadow_size=64, ssao=False,
                      sample_textures=False, sample_stickers=False)
    want = generate_batch(torch.Generator().manual_seed(2), 3, tpl, cfg, default_config(), 5)
    mesh = make_hybrid_mesh(devices=["cuda:0"])
    shards = generate_batch_sharded(torch.Generator().manual_seed(2), 3, tpl, cfg,
                                    default_config(), mesh, 5, render_sub_batch=2)
    assert len(shards) == 1 and shards[0].rows == slice(0, 3)
    for name in want._fields:
        assert torch.equal(getattr(shards[0].frames, name), getattr(want, name)), name
