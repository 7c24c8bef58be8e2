"""Classic-raster fine stage: the Hopper kernel and its plain PyTorch version.

Replaces ``stillleben_tpu/ops/fine_raster.py::_kernel`` and
``::_kernel_grouped`` (reached through ``fine_raster_pallas``), together
with the row gather before them (``rasterize_tiled.py:627-659``). Each
screen tile has ``n_chunks`` chunks of C triangle ids (-1 = masked). Per
tile and pixel centre the five homogeneous edge lines ``[L0|L1|L2|Lsum|Lz]``
are evaluated, the inside test for either winding applied, and
``wp = Ez / Esum`` kept where ``|Esum| > 1e-20`` and ``near < wp <= far``
and ``wp > md + 1e-5`` and ``id >= 0``. Within a chunk the minimum ``wp``
wins, the lowest id at equal depth; across chunks a chunk wins only with a
strictly smaller depth, so an equal-depth tie keeps the earlier chunk's
id. A single running compare over all slots of a tile is NOT the same
function: it would give such a tie to the lower id.

- ``fine_raster_reference`` is the function of the JAX kernel on the
  gathered rows, in the JAX package's layout: ``G (n_tiles, n_chunks,
  FIELDS, C)`` f32 triangle-minor, ``ids (n_tiles, n_chunks, C)`` i32,
  ``md (n_tiles, tile^2)`` f32 and ``tile_offset``, the global id of tile
  row 0 (the caller slabs big maps).
- ``fine_raster_plain`` gathers ``G`` from the line table ``LT (F,
  FIELDS)`` and calls it.
- ``fine_raster`` takes ``LT`` and ``ids``: the plain version for tensors
  on the CPU, the CUDA kernels (``csrc/fine_raster.cu``) for CUDA tensors,
  which gather the live rows themselves. ``tiles_per_cell`` 1 is K2, 4 or 8
  is K3; the result does not depend on it. A failed build or launch
  raises.

What bounds it on the card: the bytes of ``md`` and the outputs, for most
tiles are empty. See the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

FIELDS = 16  # 15 line coefficients [L0|L1|L2|Lsum|Lz] x (x, y, c) + 1 pad row
TILES_PER_CELL = (1, 4, 8)  # the kernel's instantiations (TPG)
TILES = (16, 32, 64)
# triangles per chunk, at most: the kernel stages a chunk's rows (68 B a
# slot) in a block's shared memory (227 KB on the H100)
MAX_CHUNK = 2048
SOURCE = "fine_raster.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]
_STEP_ELEMS = 1 << 22  # plain version: (tiles x C x tile^2) per step


def fine_raster_reference(
    G: torch.Tensor,  # (n_tiles, n_chunks, FIELDS, C) f32, triangle-minor
    ids: torch.Tensor,  # (n_tiles, n_chunks, C) i32, -1 = masked
    md: torch.Tensor,  # (n_tiles, tile^2) f32 depth-peel floor
    near: float,
    far: float,
    chunk: int,
    tw: int,
    tile_offset: int = 0,
    tile: int = 16,
    tiles_per_cell: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: per chunk a (tiles, C, tile^2)
    evaluation, its minimum and lowest-id winner, merged into the running
    tile result with a strict ``<``. ``tiles_per_cell`` does not change
    the result. Returns per-tile (w, t)."""
    n_tiles, n_chunks = ids.shape[0], ids.shape[1]
    pix_n = tile * tile
    dev = G.device
    pix = torch.arange(pix_n, dtype=torch.int32, device=dev)
    px = torch.remainder(pix, tile).to(torch.float32)
    py = torch.div(pix, tile, rounding_mode="floor").to(torch.float32)
    w_out = torch.empty((n_tiles, pix_n), dtype=torch.float32, device=dev)
    t_out = torch.empty((n_tiles, pix_n), dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    big_id = torch.tensor(2**30, dtype=torch.int32, device=dev)
    step = max(1, _STEP_ELEMS // (chunk * pix_n))
    for t0 in range(0, n_tiles, step):
        sl = slice(t0, min(t0 + step, n_tiles))
        gi = tile_offset + torch.arange(sl.start, sl.stop, dtype=torch.int32, device=dev)
        tile_ox = float(tile) * torch.remainder(gi, tw).to(torch.float32)
        tile_oy = float(tile) * torch.div(gi, tw, rounding_mode="floor").to(torch.float32)
        X = (tile_ox[:, None] + px[None, :] + 0.5)[:, None, :]  # (n, 1, PIX)
        Y = (tile_oy[:, None] + py[None, :] + 0.5)[:, None, :]
        floor_z = (md[sl] + 1e-5)[:, None, :]
        bw = torch.full((X.shape[0], pix_n), float("inf"), device=dev)
        bt = torch.full((X.shape[0], pix_n), -1, dtype=torch.int32, device=dev)
        for j in range(n_chunks):
            g = G[sl, j]  # (n, FIELDS, C)

            def edge(e):  # (n, C, PIX) = (lx * X + ly * Y) + lc
                return (
                    g[:, 3 * e, :, None] * X + g[:, 3 * e + 1, :, None] * Y
                ) + g[:, 3 * e + 2, :, None]

            E0, E1, E2, Esum, Ez = (edge(e) for e in range(5))
            inside = ((E0 >= 0) & (E1 >= 0) & (E2 >= 0)) | (
                (E0 <= 0) & (E1 <= 0) & (E2 <= 0)
            )
            del E0, E1, E2
            small = Esum.abs() < 1e-20
            wp = Ez / torch.where(small, torch.ones_like(Esum), Esum)
            idc = ids[sl, j][:, :, None]
            ok = (
                inside
                & (Esum.abs() > 1e-20)
                & (wp > near)
                & (wp <= far)
                & (wp > floor_z)
                & (idc >= 0)
            )
            score = torch.where(ok, wp, inf)
            cw = score.amin(dim=1)  # (n, PIX)
            ct = torch.where((score == cw[:, None, :]) & ok, idc, big_id).amin(dim=1)
            better = cw < bw  # strict: the earlier chunk keeps a tie
            bt = torch.where(better, ct, bt)
            bw = torch.where(better, cw, bw)
        w_out[sl] = bw
        t_out[sl] = bt
    return w_out, t_out


def fine_raster_plain(
    LT: torch.Tensor,  # (F, FIELDS) f32 packed line table
    ids: torch.Tensor,  # (n_tiles, n_chunks, C) i32, -1 = masked
    md: torch.Tensor,  # (n_tiles, tile^2) f32 depth-peel floor
    near: float,
    far: float,
    chunk: int,
    tw: int,
    tile_offset: int = 0,
    tile: int = 16,
    tiles_per_cell: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row gather into the triangle-minor ``G`` and
    ``fine_raster_reference``. Returns per-tile (w, t)."""
    n_tiles, n_chunks, C = ids.shape
    G = LT[torch.clamp(ids, min=0).reshape(-1).long()]
    G = G.reshape(n_tiles, n_chunks, C, FIELDS).transpose(2, 3).contiguous()
    return fine_raster_reference(
        G, ids, md, near, far, chunk, tw, tile_offset, tile, tiles_per_cell
    )


def _check(LT, ids, md, chunk, tile, tiles_per_cell):
    n_tiles, n_chunks, C = ids.shape
    dev = LT.device
    want = (
        (LT, torch.float32, (LT.shape[0], FIELDS)),
        (ids, torch.int32, (n_tiles, n_chunks, C)),
        (md, torch.float32, (n_tiles, tile * tile)),
    )
    for t, dt, shape in want:
        if t.device != dev:
            raise ValueError(f"fine_raster: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"fine_raster: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != shape or t.dim() != len(shape):
            raise ValueError(f"fine_raster: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("fine_raster: inputs must be contiguous")
    if C != chunk:
        raise ValueError(f"fine_raster: chunk {chunk} but C = {C}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"fine_raster: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if tile not in TILES:
        raise ValueError(f"fine_raster: tile {tile} not supported {TILES}")
    if tiles_per_cell not in TILES_PER_CELL:
        raise ValueError(f"fine_raster: tiles_per_cell {tiles_per_cell} not in {TILES_PER_CELL}")


def fine_raster(
    LT: torch.Tensor,
    ids: torch.Tensor,
    md: torch.Tensor,
    near: float,
    far: float,
    chunk: int,
    tw: int,
    tile_offset: int = 0,
    tile: int = 16,
    tiles_per_cell: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (w, t): best depth (inf = none) and winner id (-1). Every
    id must index a row of ``LT``.

    CPU tensors take ``fine_raster_plain``; CUDA tensors launch the kernel
    (``fine_raster.launches`` and ``fine_raster.launches_by_shape``, keyed
    by (tile, tiles_per_cell), count those launches)."""
    _check(LT, ids, md, chunk, tile, tiles_per_cell)
    if LT.device.type == "cpu":
        return fine_raster_plain(
            LT, ids, md, near, far, chunk, tw, tile_offset, tile, tiles_per_cell
        )
    if LT.device.type != "cuda":
        raise ValueError(f"fine_raster: unsupported device {LT.device}")
    if LT.data_ptr() % 16:
        raise ValueError("fine_raster: LT must be 16-byte aligned (cp.async rows)")
    lib = nvcc.load(SOURCE, "sl_fine_raster", _ARGTYPES)
    n_tiles, n_chunks, C = ids.shape
    w = torch.empty((n_tiles, tile * tile), dtype=torch.float32, device=LT.device)
    t = torch.empty((n_tiles, tile * tile), dtype=torch.int32, device=LT.device)
    words = -(-n_chunks // 32)  # occupancy mask words per tile
    work = torch.empty(1 + n_tiles * (1 + words), dtype=torch.int32, device=LT.device)
    err = lib.sl_fine_raster(
        LT.data_ptr(), ids.data_ptr(), md.data_ptr(), w.data_ptr(), t.data_ptr(),
        work.data_ptr(), n_tiles, n_chunks, C, tile, tw, int(tile_offset), tiles_per_cell,
        float(near), float(far), nvcc.stream_of(LT),
    )
    nvcc.check(err, "fine_raster")
    key = (tile, tiles_per_cell)
    fine_raster.launches += 1
    fine_raster.launches_by_shape[key] = fine_raster.launches_by_shape.get(key, 0) + 1
    return w, t


fine_raster.launches = 0
fine_raster.launches_by_shape = {}


def reset_launch_counts() -> None:
    fine_raster.launches = 0
    fine_raster.launches_by_shape = {}
