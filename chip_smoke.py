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
   (K1, cells to tiles, the merge included) at the camera (tile 16) and
   2048^2 shadow (tile 32) shapes, the classic fine kernel (K2) at the
   camera (tile 16) and shadow (tile 64) shapes, and K3 (4 and 8 tiles per
   block) against K2; all ``torch.equal``; each timed warm with CUDA
   events beside its bound (bytes, or the operations this input needs:
   ``needed_ops``), on inputs that leave only its fixed costs (K1 with no
   valid cell; K2 with every slot masked, beside a fill of its outputs)
   and with only its heaviest cell or tile. Then,
   on the same inputs, the torch stages that the kernels' row gathers and
   merge replace: ``G = LT[ids]`` and the per-cell floor of the cells
   path, its cells -> tiles merge, and the classic path's gather and
   transpose.
6. main path, cells: ``generate_batch`` B = 8 at 640x480 (10 objects,
   100 x 4 settle, 2048^2 VSM shadow, PBR, full ground truth); content
   checks; K1's launch counts, and no call of its plain version; scenes/s
   of a second, warm call.
7. main path, classic: ``generate_batch`` B = 8 with ``raster="classic"``;
   the same checks; K2's launch counts at both shapes, and no call of its
   plain version; scenes/s.
8. breakdown: the 8 settled poses rendered with both rasters (ms per
   render; per scene the classic-vs-cells instance agreement, split into
   the classic raster's holes, where its pixel stage dropped triangles
   beyond a static capacity, and every other disagreement, which must stay
   under 3%), then with K3 (``fine_tiles_per_cell`` 4 and 8), bitwise
   equal to K2's frames.
9. reference: on the CPU tests' small scene at 160x120, the instance map
   of each raster against the brute-force oracle's (cells >= 99.9%,
   classic >= 97%, the JAX package's own bound for its classic path).

The last three lines are a JSON object of the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
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
# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_BYTES = 3.35e12  # HBM3
# float32 instructions that are not fused multiply-adds: the data sheet's
# 67 TFLOP/s counts an FMA as two operations; one instruction per lane and
# clock is 132 SMs x 128 lanes x 1.98 GHz. The raster kernels are built
# with --fmad=false and explicit _rn intrinsics, so each counted operation
# is one instruction.
PEAK_F32_OPS = 132 * 128 * 1.98e9  # 33.5e12 per second
# The operations that z-buffering K1's and K2's inputs needs, counted
# from this run's data. Per (live slot, 8x4-pixel patch of its tile) a
# cull, whether the triangle can touch the patch: per edge its value at the
# patch's middle (2 mul + 2 add), its half-range over the patch (2 abs + 2
# mul + 1 add) and two range tests (2 add + 2 compares), and 2 to combine
# the edges. Per pixel of a patch that the cull keeps, the inside test: E0,
# E1, E2 (2 mul + 2 add each) and 6 sign compares. Per pixel inside, the
# depth path: Esum and Ez (2 mul + 2 add each), the division, |Esum| and its
# compare, the near/far/floor compares and the 2 compares of the running
# minimum.
CULL_OPS = 3 * 13 + 2
INSIDE_OPS = 3 * 4 + 6
DEPTH_OPS = 2 * 4 + 1 + 2 + 3 + 2
ROW_BYTES = 16 * 4  # one packed line row LT[id]
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
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_ops(torch, rows, ox, oy, tile: int) -> tuple[int, int, int, int]:
    """The operations that z-buffering the line rows ``rows`` (S, 16) of
    live slots needs, each slot over its tile at pixel origin (ox, oy)
    (S,): CULL_OPS per (slot, patch), INSIDE_OPS per pixel of each (slot,
    patch) pair whose patch the triangle can touch, DEPTH_OPS per (slot,
    pixel) inside. The cull is exact (float64, no margin). Returns
    (operations, slot-patch pairs, kept pairs, inside pairs)."""
    dev = rows.device
    f64 = torch.float64
    pxo = torch.arange(0, tile, 8, device=dev, dtype=f64).repeat(tile // 4)
    pyo = torch.arange(0, tile, 4, device=dev, dtype=f64).repeat_interleave(tile // 8)
    lane = torch.arange(32, device=dev)
    dx, dy = (lane % 8).to(f64) + 0.5, (lane // 8).to(f64) + 0.5
    pairs = rows.shape[0] * pxo.numel()
    kept = inside = 0
    for s0 in range(0, rows.shape[0], 4096):
        g = rows[s0:s0 + 4096].to(f64)
        xo, yo = ox[s0:s0 + 4096].to(f64)[:, None], oy[s0:s0 + 4096].to(f64)[:, None]
        xc, yc = xo + pxo + 4.0, yo + pyo + 2.0  # (s, P) patch middles
        below = torch.zeros(xc.shape, dtype=torch.bool, device=dev)
        above = torch.zeros_like(below)
        for e in range(3):
            lx, ly, lc = g[:, 3 * e, None], g[:, 3 * e + 1, None], g[:, 3 * e + 2, None]
            c = lx * xc + ly * yc + lc
            r = lx.abs() * 3.5 + ly.abs() * 1.5
            below |= c + r < 0
            above |= c - r > 0
        s_i, p_i = torch.nonzero(~(below & above), as_tuple=True)
        kept += int(s_i.numel())
        X = (xo[s_i] + pxo[p_i, None]) + dx  # (k, 32) pixel centres
        Y = (yo[s_i] + pyo[p_i, None]) + dy
        gk = g[s_i]
        E = [gk[:, 3 * e, None] * X + gk[:, 3 * e + 1, None] * Y + gk[:, 3 * e + 2, None]
             for e in range(3)]
        ins = ((E[0] >= 0) & (E[1] >= 0) & (E[2] >= 0)) | ((E[0] <= 0) & (E[1] <= 0) & (E[2] <= 0))
        inside += int(ins.sum())
    n_ops = pairs * CULL_OPS + kept * 32 * INSIDE_OPS + inside * DEPTH_OPS
    return n_ops, pairs, kept, inside


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


def count_calls(module, attrs, run):
    """Run ``run()`` with each ``module.attr`` wrapped to count its calls;
    returns (its result, {attr: calls})."""
    counts = dict.fromkeys(attrs, 0)
    originals = {a: getattr(module, a) for a in attrs}

    def counter(attr):
        def wrapped(*args, **kwargs):
            counts[attr] += 1
            return originals[attr](*args, **kwargs)
        return wrapped

    for a in attrs:
        setattr(module, a, counter(a))
    try:
        return run(), counts
    finally:
        for a, f in originals.items():
            setattr(module, a, f)


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
    uses = {16: "camera", 32: "shadow", 64: "shadow"}
    for tile, (args, _) in sorted(k1_in.items()):
        LT, ids, cell_tile, md, near, far, tw, _, n_tiles = args
        out_k = cr.cell_raster(*args)
        bitwise, err = compare(torch, out_k, cr.cell_raster_plain(*args))
        ms = cuda_time(torch, lambda: cr.cell_raster(*args), 50)
        plain_ms = cuda_time(torch, lambda: cr.cell_raster_plain(*args), 3)
        # what the merge alone costs: the key buffer's fill and unpack, no
        # valid cell; and what the cell with the most live slots costs alone
        valid = cell_tile < n_tiles
        no_cells = torch.full_like(cell_tile, n_tiles)
        keys_ms = cuda_time(
            torch, lambda: cr.cell_raster(LT, ids, no_cells, md, near, far, tw, tile, n_tiles), 50)
        heavy = no_cells.clone()
        top = int(((ids >= 0).sum(1) * valid).argmax())
        heavy[top] = cell_tile[top]
        heavy_ms = cuda_time(
            torch, lambda: cr.cell_raster(LT, ids, heavy, md, near, far, tw, tile, n_tiles), 50)
        live = (ids >= 0) & valid[:, None]
        slots = int(live.sum())
        slot_tile = cell_tile[:, None].expand_as(ids)[live]
        n_ops, pairs, kept, inside = needed_ops(
            torch, LT[ids[live].long()], tile * (slot_tile % tw), tile * (slot_tile // tw), tile)
        n_bytes = (slots * ROW_BYTES + (ids.numel() + cell_tile.numel()) * 4
                   + (0 if md is None else n_tiles * tile * tile * 4) + 2 * out_k[0].numel() * 4)
        b_ms, b_by = bound(n_bytes, n_ops)
        phase("kernel", f"K1 {uses[tile]}: tile {tile}, {ids.shape[0]} cells x C {ids.shape[1]}, "
                        f"{int(valid.sum())} valid, {slots} live slots in valid cells, "
                        f"{n_tiles} tiles; equal: {bitwise}; max_abs_err {err}; kernel {ms:.4f} ms "
                        f"(with no valid cell {keys_ms:.4f} ms, the heaviest cell "
                        f"({int((ids[top] >= 0).sum())} live slots) alone {heavy_ms:.4f} ms), "
                        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                        f"{n_ops} ops: {pairs} slot-patch pairs, {kept} kept, {inside} slot-pixel "
                        f"pairs inside) ({name}; {card})")
        if not bitwise:
            fail(f"K1 tile {tile}: kernel and plain version differ")
        k1[tile] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    for tile, (args, kw) in sorted(k2_in.items()):
        LT, ids, md = args[:3]
        tw, tile_offset = args[6], kw.get("tile_offset", 0)
        out_k = fr.fine_raster(*args, **kw)
        bitwise, err = compare(torch, out_k, fr.fine_raster_plain(*args, **kw))
        ms = cuda_time(torch, lambda: fr.fine_raster(*args, **kw), 50)
        plain_ms = cuda_time(torch, lambda: fr.fine_raster_plain(*args, **kw), 3)
        # what empty tiles alone cost (every slot masked), against a fill of
        # the outputs; and what the heaviest tile costs alone
        no_slots = torch.full_like(ids, -1)
        empty_ms = cuda_time(torch, lambda: fr.fine_raster(LT, no_slots, *args[2:], **kw), 50)
        fill_ms = cuda_time(torch, lambda: (torch.full_like(out_k[0], float("inf")),
                                            torch.full_like(out_k[1], -1)), 50)
        heavy = no_slots.clone()
        top = int((ids >= 0).flatten(1).sum(1).argmax())
        heavy[top] = ids[top]
        heavy_ms = cuda_time(torch, lambda: fr.fine_raster(LT, heavy, *args[2:], **kw), 50)
        live = ids >= 0
        slots = int(live.sum())
        gi = tile_offset + torch.arange(ids.shape[0], device=dev)[:, None, None].expand_as(ids)[live]
        n_ops, pairs, kept, inside = needed_ops(
            torch, LT[ids[live].long()], tile * (gi % tw), tile * (gi // tw), tile)
        n_bytes = (slots * ROW_BYTES + (ids.numel() + md.numel()) * 4
                   + 2 * out_k[0].numel() * 4)
        b_ms, b_by = bound(n_bytes, n_ops)
        occupied = int(live.any(-1).sum())
        per_tile = live.flatten(1).sum(1)
        phase("kernel", f"K2 {uses[tile]}: tile {tile}, {ids.shape[0]} tiles x {ids.shape[1]} "
                        f"chunks x C {ids.shape[2]}, {occupied} occupied chunks, {slots} live "
                        f"slots, {int((per_tile > 0).sum())} occupied tiles, at most "
                        f"{int(per_tile.max())} slots in a tile; equal: {bitwise}; max_abs_err "
                        f"{err}; kernel {ms:.4f} ms (every slot masked {empty_ms:.4f} ms, a fill of "
                        f"the outputs {fill_ms:.4f} ms, the heaviest tile alone {heavy_ms:.4f} ms), "
                        f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {n_bytes} B, "
                        f"{n_ops} ops: {pairs} slot-patch pairs, {kept} kept, {inside} slot-pixel "
                        f"pairs inside) ({name}; {card})")
        if not bitwise:
            fail(f"K2 tile {tile}: kernel and plain version differ")
        k2[tile] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        for tpg in (4, 8):
            kw3 = dict(kw, tiles_per_cell=tpg)
            bitwise3, err3 = compare(torch, fr.fine_raster(*args, **kw3), out_k)
            ms3 = cuda_time(torch, lambda: fr.fine_raster(*args, **kw3), 50)
            phase("kernel", f"K3 {uses[tile]}: tile {tile}, {tpg} tiles per block; equal to K2: "
                            f"{bitwise3}; kernel {ms3:.4f} ms ({name}; {card})")
            if not bitwise3:
                fail(f"K3 tile {tile} tpg {tpg}: differs from K2")
            k3[(tile, tpg)] = dict(max_abs_err=err3, ms=ms3, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)

    # the torch stages of the earlier design that the kernels now do: the
    # row gather G = LT[ids] and the per-cell floor before K1 and the
    # cells -> tiles merge after it; the gather and transpose before K2
    for tile, (args, _) in sorted(k1_in.items()):
        LT, ids, cell_tile, _, near, far, tw, _, n_tiles = args
        n, C = ids.shape

        def gather():
            return LT[torch.clamp(ids, min=0).long().reshape(-1)].reshape(n, C, cr.FIELDS)

        G = gather()
        mdc = torch.zeros((n, tile * tile), device=dev)
        w_c, t_c = cr.cell_raster_reference(G, ids, cell_tile, mdc, near, far, tw, tile, n_tiles)
        g_ms = cuda_time(torch, gather, 50)
        z_ms = cuda_time(torch, lambda: torch.zeros((n, tile * tile), device=dev), 50)
        m_ms = cuda_time(torch, lambda: cr.merge_cells(w_c, t_c, cell_tile, n_tiles), 50)
        phase("stages", f"cells {uses[tile]}, tile {tile}: gather G = LT[ids] {g_ms:.4f} ms, "
                        f"per-cell floor zeros {z_ms:.4f} ms, merge_cells {m_ms:.4f} ms "
                        f"({name}; {card})")
        del G, mdc, w_c, t_c
    for tile, (args, kw) in sorted(k2_in.items()):
        LT, ids = args[:2]
        n_tiles, n_chunks, C = ids.shape

        def gather_t():
            g = LT[torch.clamp(ids, min=0).reshape(-1).long()]
            return g.reshape(n_tiles, n_chunks, C, fr.FIELDS).transpose(2, 3).contiguous()

        f_ms = cuda_time(torch, gather_t, 50)
        phase("stages", f"classic {uses[tile]}, tile {tile}: gather + transpose {f_ms:.4f} ms "
                        f"({name}; {card})")

    # 6. the main path through the cell raster
    gen = torch.Generator().manual_seed(SEED)
    cr.reset_launch_counts()
    fr.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, plain_calls = count_calls(
        cr, ("cell_raster_plain", "merge_cells", "cell_raster_reference"),
        lambda: generate_batch(gen, BATCH, tpl, cfg, solver_cfg))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    k1_launches = dict(cr.cell_raster.launches_by_tile)
    phase("main", f"cells: generate_batch B={BATCH} {WIDTH}x{HEIGHT}: first call {cold_s:.3f} s; "
                  f"K1 launches by tile {k1_launches}, K2/K3 launches {fr.fine_raster.launches}; "
                  f"calls of K1's plain pieces {plain_calls}")
    phase("main", f"cells: content: {check_frames(torch, frames, 'cells')}")
    if k1_launches.get(16, 0) <= 0 or k1_launches.get(32, 0) <= 0:
        fail(f"the cells path did not launch K1 for both passes: {k1_launches}")
    if any(plain_calls.values()):
        fail(f"the cells path on the card called K1's plain pieces: {plain_calls}")
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
    frames, plain_calls = count_calls(
        fr, ("fine_raster_plain", "fine_raster_reference"),
        lambda: generate_batch(gen, BATCH, tpl, ccfg, solver_cfg))
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    k2_launches = dict(fr.fine_raster.launches_by_shape)
    phase("main", f"classic: generate_batch B={BATCH} {WIDTH}x{HEIGHT}: {classic_s:.3f} s, "
                  f"{BATCH / classic_s:.4f} scenes/s ({name}; {card}); K2 launches by (tile, "
                  f"tiles per block) {k2_launches}, K1 launches {cr.cell_raster.launches}; calls "
                  f"of K2's plain pieces {plain_calls}")
    phase("main", f"classic: content: {check_frames(torch, frames, 'classic')}")
    if k2_launches.get((16, 1), 0) <= 0 or k2_launches.get((64, 1), 0) <= 0:
        fail(f"the classic path did not launch K2 for both passes: {k2_launches}")
    if any(plain_calls.values()):
        fail(f"the classic path on the card called K2's plain pieces: {plain_calls}")
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
