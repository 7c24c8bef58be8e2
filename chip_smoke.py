#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the datagen main path at
the benchmark's size, through every hand-written kernel, on both rasters.

    python3 chip_smoke.py

Phases (one line each or more; any failure exits non-zero):

1. device: the card's name, count and power limit; TF32 off.
2. build: one nvcc per ``stillleben_tpu_torch/csrc/*.cu`` source, all at
   once, for sm_90a (ptxas reports printed).
3. toolchain: the ``o = 2x`` kernel (K4) on an (8, 128) tensor, exact.
4. scene, settle: the bench scene; one settle of B = 8 scenes, whose poses
   serve the kernel captures and the per-render breakdown.
5. kernels: each raster kernel against its plain PyTorch version on the
   inputs one render of the bench scene really produces: the cell kernel
   (K1) at the camera (tile 16) and 2048^2 shadow (tile 32) shapes, the
   classic fine kernel (K2) at the camera (tile 16) and shadow (tile 64)
   shapes, and K3 (4 and 8 tiles per block) against K2; all bitwise; each
   timed warm with CUDA events beside its bound.
6. main path, cells: ``generate_batch`` B = 8 at 640x480 (10 objects,
   100 x 4 settle, 2048^2 VSM shadow, PBR, full ground truth); content
   checks; K1's launch counts; scenes/s of a second, warm call.
7. main path, classic: ``generate_batch`` B = 8 with ``raster="classic"``;
   the same checks; K2's launch counts at both shapes; scenes/s.
8. breakdown: the 8 settled poses rendered with both rasters (ms per
   render; per scene the classic-vs-cells instance agreement, split into
   the classic raster's holes, where its pixel stage dropped triangles
   beyond a static capacity, and every other disagreement, which must stay
   under 3%), then with K3 (``fine_tiles_per_cell`` 4 and 8), bitwise
   equal to K2's frames.
9. reference: on the CPU tests' small scene at 160x120, the instance map
   of each raster against the brute-force oracle's (cells >= 99.9%,
   classic >= 97%, the JAX package's own bound for its classic path).

The second-to-last line is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 640, 480
BATCH = 8
SHADOW_SIZE = 2048
SEED = 0
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# operations of one (triangle slot, pixel) evaluation of K1/K2: 5 edge
# lines x (2 mul + 2 add), 1 division, 6 inside compares, |Esum| and its
# compare, near/far/floor compares, the 2 compares of the running minimum
OPS_PER_EVAL = 20 + 1 + 6 + 2 + 3 + 2
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's 1.98 GHz boost clock


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def load_meshes(subdiv: int):
    """(dense, cube, sphere) from the procedural OBJ files, classes 1..3."""
    from stillleben_tpu_torch.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import write_meshes

    build = os.path.join(ROOT, "stillleben_tpu_torch", "_build")
    os.environ["STILLLEBEN_TPU_MESH_CACHE"] = os.path.join(build, "mesh_cache")
    paths = write_meshes(os.path.join(build, "meshes"), subdiv=subdiv, seed=0)
    dense = Mesh(paths["blob"], flags=Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL)
    dense.center_bbox()
    cube = Mesh(paths["cube"])
    sphere = Mesh(paths["sphere"])
    for i, mesh in enumerate((dense, cube, sphere)):
        mesh.class_index = i + 1
    return dense, cube, sphere


def build_scene(order, width: int, height: int):
    from stillleben_tpu_torch.scene.scene import Object, Scene

    import numpy as np

    rng = np.random.default_rng(7)
    scene = Scene((width, height))
    for mesh in order:
        scene.add_object(
            Object(mesh, metallic=float(rng.random()), roughness=float(rng.random()))
        )
    return scene


def bench_scene():
    """The bench workload (bench.py:97-119) with a procedural dense mesh
    (81,920 faces) in place of the scanned bunny: [dense, cube, sphere] x 3
    + [cube]."""
    dense, cube, sphere = load_meshes(subdiv=6)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.2)
    sphere.scale_to_bbox_diagonal(0.15)
    return build_scene([dense, cube, sphere] * 3 + [cube], WIDTH, HEIGHT)


def small_scene():
    """The CPU tests' scene (a 1,280-face dense mesh, a cube, a sphere) at
    160x120, where the raster's per-tile capacity holds every triangle."""
    dense, cube, sphere = load_meshes(subdiv=3)
    dense.scale_to_bbox_diagonal(0.25)
    cube.scale_to_bbox_diagonal(0.25)
    sphere.scale_to_bbox_diagonal(0.3)
    return build_scene([cube, sphere, dense], 160, 120)


def cuda_time(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` warm runs (CUDA events).
    A spin kernel of ~20 ms runs first, so the host has queued every run
    before the start event: the time is the device's, not the host's
    launch overhead (about 0.03 ms per wrapper call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of bytes over
    the memory rate and float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, kernel_out, plain_out) -> tuple[bool, float]:
    """(bitwise equal, max |w| difference over pixels finite in both; inf
    where only one is finite)."""
    (wk, tk), (wp, tp) = kernel_out, plain_out
    bitwise = torch.equal(wk, wp) and torch.equal(tk, tp)
    both = torch.isfinite(wk) & torch.isfinite(wp)
    err = float((wk[both] - wp[both]).abs().max()) if both.any() else 0.0
    if not torch.equal(torch.isfinite(wk), torch.isfinite(wp)):
        err = float("inf")
    return bitwise, err


def capture(module, attr: str, key, run) -> dict:
    """Run ``run()`` with ``module.attr`` wrapped so that each call's
    arguments are kept (cloned), keyed by ``key(args, kwargs)``."""
    captured = {}
    original = getattr(module, attr)

    def recorder(*args, **kwargs):
        captured[key(args, kwargs)] = (
            tuple(a.clone() if hasattr(a, "clone") else a for a in args), dict(kwargs)
        )
        return original(*args, **kwargs)

    setattr(module, attr, recorder)
    try:
        run()
    finally:
        setattr(module, attr, original)
    return captured


def check_frames(torch, frames, what: str) -> str:
    for f in ("hdr", "object_coordinates", "cam_coordinates", "normals",
              "barycentric_coeffs", "depth"):
        if not torch.isfinite(getattr(frames, f)).all():
            fail(f"{what}: non-finite values in {f}")
    inst_px = frames.valid.flatten(1).sum(1)
    rgb_std = float(frames.rgb.float().std())
    if not (inst_px > 0).all():
        fail(f"{what}: a scene without object pixels: {inst_px.tolist()}")
    if rgb_std <= 1.0:
        fail(f"{what}: rgb std {rgb_std} <= 1: blank frames")
    classes = sorted(int(c) for c in torch.unique(frames.class_index.to(torch.int32)).tolist())
    return f"object pixels per scene {inst_px.tolist()}, classes {classes}, rgb std {rgb_std:.2f}"


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "stillleben_tpu_torch")):
        fail("the stillleben_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    phase("device", f"{name}; count {torch.cuda.device_count()}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")

    # 2. build: every source at once
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.ops import fine_raster as fr
    from stillleben_tpu_torch.ops import nvcc, smoke
    from stillleben_tpu_torch.render import rasterize_tiled as rt

    t0 = time.perf_counter()
    built = nvcc.build_all()
    phase("build", f"{', '.join(sorted(built))} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for source, (lib_path, log) in built.items():
        print(f"--- {source} -> {os.path.relpath(lib_path, ROOT)}\n{log.strip()}", flush=True)

    kernels = []  # the JSON line's entries

    # 3. toolchain: K4
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(SEED)).to(dev)
    smoke.double.launches = 0
    o = smoke.double(x)
    torch.cuda.synchronize()
    k4_launches = smoke.double.launches
    exact = torch.equal(o, smoke.double_reference(x))
    err = float((o - smoke.double_reference(x)).abs().max())
    ms = cuda_time(torch, lambda: smoke.double(x), 100)
    plain_ms = cuda_time(torch, lambda: smoke.double_reference(x), 100)
    library_ms = cuda_time(torch, lambda: torch.mul(x, 2.0), 100)
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
    phase("toolchain", f"o = 2x on (8, 128) f32: exact {exact}; kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms, torch.mul {library_ms:.4f} ms, bound {b_ms:.6f} ms "
                       f"({b_by}) ({name}; {card})")
    if not exact or k4_launches != 1:
        fail(f"the toolchain kernel is wrong (exact {exact}, launches {k4_launches})")
    kernels.append(dict(
        name="smoke[o = 2x, (8, 128)]", route="cuda", source="stillleben_tpu_torch/csrc/smoke.cu",
        replaces="tools/tpu_smoke.py:73", launches=k4_launches, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    ))

    # 4. scene and one settle of B scenes
    from stillleben_tpu_torch.parallel.batch import (
        generate_batch, render_with_poses, settle_scene, template_from_scene,
    )
    from stillleben_tpu_torch.physics.types import default_config
    from stillleben_tpu_torch.render.frame import FrameConfig

    t0 = time.perf_counter()
    scene = bench_scene()
    tpl = template_from_scene(scene)  # on the card by default
    atlas = tpl.render_atlas
    if atlas.faces.device.type != "cuda":
        fail(f"template_from_scene put the template on {atlas.faces.device}")
    phase("scene", f"{len(scene.objects)} objects, {atlas.faces.shape[0]} faces, "
                   f"{atlas.shadow_faces.shape[0]} shadow-proxy faces, "
                   f"{tpl.hull_atlas.verts.shape[0]} hulls, built in {time.perf_counter() - t0:.1f} s")
    cfg = FrameConfig(width=WIDTH, height=HEIGHT, shading="pbr", max_lights=1,
                      shadow_mode="vsm", shadow_size=SHADOW_SIZE)
    ccfg = cfg._replace(raster="classic", tile_capacity=256, big_capacity=64, fine_chunk=128,
                        pixel_stage=None, fine_tiles_per_cell=1)
    solver_cfg = default_config()
    gen = torch.Generator().manual_seed(SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses8, cams8, lights8 = settle_scene(gen, BATCH, tpl, solver_cfg)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    phase("settle", f"settle_scene of {BATCH} scenes: {settle_s:.3f} s ({name}; {card})")

    def render(c, b=0):
        return render_with_poses(tpl, poses8[b], cams8[b], c, lights8[b])

    # 5. kernels against their plain versions, on one render's real inputs
    k1_in = capture(rt, "cell_raster", lambda a, kw: a[7], lambda: render(cfg))
    if set(k1_in) != {16, 32}:
        fail(f"expected a tile-16 camera and a tile-32 shadow cell pass, got {sorted(k1_in)}")
    k2_in = capture(rt, "fine_raster", lambda a, kw: kw["tile"], lambda: render(ccfg))
    if set(k2_in) != {16, 64}:
        fail(f"expected a tile-16 camera and a tile-64 shadow fine pass, got {sorted(k2_in)}")
    k1, k2, k3 = {}, {}, {}
    for tile, (args, _) in sorted(k1_in.items()):
        G, ids, cell_tile, md, near, far, tw, _, n_tiles = args
        out_k = cr.cell_raster(*args)
        bitwise, err = compare(torch, out_k, cr.cell_raster_reference(*args))
        ms = cuda_time(torch, lambda: cr.cell_raster(*args), 50)
        plain_ms = cuda_time(torch, lambda: cr.cell_raster_reference(*args), 3)
        valid = cell_tile < n_tiles
        slots = int(((ids >= 0) & valid[:, None]).sum())
        n_bytes = (slots * G.shape[2] * 4 + (ids.numel() + cell_tile.numel() + md.numel()) * 4
                   + 2 * out_k[0].numel() * 4)
        b_ms, b_by = bound(n_bytes, slots * tile * tile * OPS_PER_EVAL)
        use = "camera" if tile == 16 else "shadow"
        phase("kernel", f"K1 {use}: tile {tile}, {ids.shape[0]} cells x C {ids.shape[1]}, "
                        f"{int(valid.sum())} valid, {slots} unmasked slots in valid cells; bitwise "
                        f"equal: {bitwise}; max_abs_err {err}; kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                        f"{slots * tile * tile * OPS_PER_EVAL} ops) ({name}; {card})")
        if not bitwise:
            fail(f"K1 tile {tile}: kernel and plain version differ")
        k1[tile] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    for tile, (args, kw) in sorted(k2_in.items()):
        G, ids, md = args[:3]
        out_k = fr.fine_raster(*args, **kw)
        bitwise, err = compare(torch, out_k, fr.fine_raster_reference(*args, **kw))
        ms = cuda_time(torch, lambda: fr.fine_raster(*args, **kw), 50)
        plain_ms = cuda_time(torch, lambda: fr.fine_raster_reference(*args, **kw), 3)
        slots = int((ids >= 0).sum())
        n_bytes = (slots * G.shape[2] * 4 + (ids.numel() + md.numel()) * 4
                   + 2 * out_k[0].numel() * 4)
        b_ms, b_by = bound(n_bytes, slots * tile * tile * OPS_PER_EVAL)
        occupied = int((ids >= 0).any(-1).sum())
        use = "camera" if tile == 16 else "shadow"
        phase("kernel", f"K2 {use}: tile {tile}, {ids.shape[0]} tiles x {ids.shape[1]} chunks x "
                        f"C {ids.shape[2]}, {occupied} occupied chunks, {slots} unmasked slots; "
                        f"bitwise equal: {bitwise}; max_abs_err {err}; kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                        f"{slots * tile * tile * OPS_PER_EVAL} ops) ({name}; {card})")
        if not bitwise:
            fail(f"K2 tile {tile}: kernel and plain version differ")
        k2[tile] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        for tpg in (4, 8):
            kw3 = dict(kw, tiles_per_cell=tpg)
            bitwise3, err3 = compare(torch, fr.fine_raster(*args, **kw3), out_k)
            ms3 = cuda_time(torch, lambda: fr.fine_raster(*args, **kw3), 50)
            phase("kernel", f"K3 {use}: tile {tile}, {tpg} tiles per block; bitwise equal to K2: "
                            f"{bitwise3}; kernel {ms3:.4f} ms ({name}; {card})")
            if not bitwise3:
                fail(f"K3 tile {tile} tpg {tpg}: differs from K2")
            k3[(tile, tpg)] = dict(max_abs_err=err3, ms=ms3, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)

    # 6. the main path through the cell raster
    gen = torch.Generator().manual_seed(SEED)
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = generate_batch(gen, BATCH, tpl, cfg, solver_cfg)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    k1_launches = dict(cr.cell_raster.launches_by_tile)
    phase("main", f"cells: generate_batch B={BATCH} {WIDTH}x{HEIGHT}: first call {cold_s:.3f} s; "
                  f"K1 launches by tile {k1_launches}, K2/K3 launches {fr.fine_raster.launches}")
    phase("main", f"cells: content: {check_frames(torch, frames, 'cells')}")
    if k1_launches.get(16, 0) <= 0 or k1_launches.get(32, 0) <= 0:
        fail(f"the cells path did not launch K1 for both passes: {k1_launches}")
    del frames
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_batch(gen, BATCH, tpl, cfg, solver_cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    phase("main", f"cells: warm call {warm_s:.3f} s: {BATCH / warm_s:.4f} scenes/s "
                  f"({name}; {card})")

    # 7. the main path through the classic raster
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = generate_batch(gen, BATCH, tpl, ccfg, solver_cfg)
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    k2_launches = dict(fr.fine_raster.launches_by_shape)
    phase("main", f"classic: generate_batch B={BATCH} {WIDTH}x{HEIGHT}: {classic_s:.3f} s, "
                  f"{BATCH / classic_s:.4f} scenes/s ({name}; {card}); K2 launches by (tile, "
                  f"tiles per block) {k2_launches}, K1 launches {cr.cell_raster.launches}")
    phase("main", f"classic: content: {check_frames(torch, frames, 'classic')}")
    if k2_launches.get((16, 1), 0) <= 0 or k2_launches.get((64, 1), 0) <= 0:
        fail(f"the classic path did not launch K2 for both passes: {k2_launches}")
    del frames

    # 8. where the time goes: the settle above, then 8 renders per raster
    def render_all(c):
        render(c)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [render(c, b) for b in range(BATCH)]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / BATCH * 1e3

    cells_frames, cells_ms = render_all(cfg)
    classic_frames, classic_ms = render_all(ccfg)
    phase("breakdown", f"settle of {BATCH} scenes {settle_s:.3f} s; render {cells_ms:.2f} ms "
                       f"(cells), {classic_ms:.2f} ms (classic) per scene ({name}; {card})")
    # The classic pixel stage keeps the first max(4096, F/16) triangles of
    # its 2-4-px class (rasterize_tiled.py:780 in the JAX package) and
    # drops the rest: a dropped triangle in view leaves a hole, a pixel the
    # cell raster covers and the classic one does not. Every other
    # disagreement must stay under 3% of the image.
    for b, (fc, fk) in enumerate(zip(cells_frames, classic_frames)):
        stage = capture(rt, "_run_pixel_stages", lambda a, kw: 0, lambda: render(ccfg, b))
        Lf, _, tiny, span_x, span_y = stage[0][0][:5]
        n_tiny4 = int((tiny & ~((span_x <= 2) & (span_y <= 2))).sum())
        cap4 = min(Lf.shape[0], max(4096, Lf.shape[0] // 16))
        differ = fc.instance_index != fk.instance_index
        holes = int((differ & fc.valid & ~fk.valid).sum())
        other = int(differ.sum()) - holes
        agree = 1.0 - int(differ.sum()) / differ.numel()
        phase("breakdown", f"scene {b}: classic vs cells instance agreement {agree:.6f}; "
                           f"classic holes {holes} px, other disagreement {other} px; pixel "
                           f"stage 2-4-px class {n_tiny4} triangles, {max(0, n_tiny4 - cap4)} "
                           f"beyond its {cap4} slots")
        if other > 0.03 * differ.numel() or (holes > 0.03 * differ.numel() and n_tiny4 <= cap4):
            fail(f"scene {b}: the classic raster disagrees with the cell raster")
    del cells_frames
    k3_launches = {}
    for tpg in (4, 8):
        cr.reset_launch_counts()
        fr.reset_launch_counts()
        tcfg = ccfg._replace(fine_tiles_per_cell=tpg)
        tpg_frames, tpg_ms = render_all(tcfg)
        k3_launches.update(fr.fine_raster.launches_by_shape)
        same = all(
            torch.equal(getattr(a, f), getattr(b, f))
            for a, b in zip(tpg_frames, classic_frames) for f in a._fields
        )
        phase("breakdown", f"classic with {tpg} tiles per block (K3): {tpg_ms:.2f} ms per scene; "
                           f"launches {dict(fr.fine_raster.launches_by_shape)}; frames bitwise "
                           f"equal to K2's: {same}")
        if not same:
            fail(f"K3 ({tpg} tiles per block) frames differ from K2's")
    del classic_frames, tpg_frames

    # 9. both rasters against the brute-force oracle on a small input
    small = small_scene()
    stpl = template_from_scene(small)
    scfg = cfg._replace(width=160, height=120, shadow_size=512)
    sp, sc, sl = settle_scene(torch.Generator().manual_seed(SEED + 2), 1, stpl, solver_cfg, 20)
    fb = render_with_poses(stpl, sp[0], sc[0], scfg._replace(tiled=False), sl[0])
    n_obj = int(fb.valid.sum())
    for raster, need in (("cells", 0.999), ("classic", 0.97)):
        fk = render_with_poses(stpl, sp[0], sc[0], scfg._replace(raster=raster), sl[0])
        same = float((fk.instance_index == fb.instance_index).float().mean())
        both = fk.valid & fb.valid
        depth_err = float((fk.depth - fb.depth)[both].abs().max()) if both.any() else 0.0
        phase("reference", f"small scene 160x120, {raster} raster vs brute-force oracle: "
                           f"instance map agrees on {same:.6f} of pixels ({n_obj} object pixels), "
                           f"max depth difference {depth_err:.3g}")
        if same < need or n_obj == 0:
            fail(f"the {raster} raster disagrees with the brute-force oracle")

    uses = {16: "camera", 32: "shadow", 64: "shadow"}
    for tile in (16, 32):
        kernels.append(dict(
            name=f"cell_raster[{uses[tile]}, tile {tile}]", route="cuda",
            source="stillleben_tpu_torch/csrc/cell_raster.cu",
            replaces="stillleben_tpu/ops/cell_raster.py:43", launches=k1_launches[tile],
            library_ms=None, **k1[tile],
        ))
    for tile in (16, 64):
        kernels.append(dict(
            name=f"fine_raster[{uses[tile]}, tile {tile}]", route="cuda",
            source="stillleben_tpu_torch/csrc/fine_raster.cu",
            replaces="stillleben_tpu/ops/fine_raster.py:98", launches=k2_launches[(tile, 1)],
            library_ms=None, **k2[tile],
        ))
    for (tile, tpg), entry in sorted(k3.items()):
        kernels.append(dict(
            name=f"fine_raster_grouped[{uses[tile]}, tile {tile}, {tpg} tiles per block]",
            route="cuda", source="stillleben_tpu_torch/csrc/fine_raster.cu",
            replaces="stillleben_tpu/ops/fine_raster.py:130",
            launches=k3_launches.get((tile, tpg), 0), library_ms=None, **entry,
        ))
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was not launched on its path: {[k['name'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
