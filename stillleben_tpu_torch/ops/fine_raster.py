"""Classic-raster fine stage: the Hopper kernel and its plain PyTorch version.

Replaces ``stillleben_tpu/ops/fine_raster.py::_kernel`` and
``::_kernel_grouped`` (reached through ``fine_raster_pallas``). Each screen
tile has ``n_chunks`` chunks of C triangle slots (id -1 = masked). Per tile
and pixel centre the five homogeneous edge lines ``[L0|L1|L2|Lsum|Lz]`` are
evaluated, the inside test for either winding applied, and
``wp = Ez / Esum`` kept where ``|Esum| > 1e-20`` and ``near < wp <= far``
and ``wp > md + 1e-5`` and ``id >= 0``. Within a chunk the minimum ``wp``
wins, the lowest id at equal depth; across chunks a chunk wins only with a
strictly smaller depth, so an equal-depth tie keeps the earlier chunk's
id. A single running compare over all slots of a tile is NOT the same
function: it would give such a tie to the lower id.

Layout (the JAX package's, so both packages take the same arrays):
``G (n_tiles, n_chunks, FIELDS, C)`` f32 triangle-minor,
``ids (n_tiles, n_chunks, C)`` i32, ``md (n_tiles, tile^2)`` f32 and
``tile_offset``, the global id of tile row 0 (the caller slabs big maps).

What bounds it on the card: at the camera shape (tile 16, C 128)
arithmetic over the unmasked slots x tile^2 pixels; at the shadow shape
(tile 64) the bytes of ``md`` and the outputs. The CUDA source
(``csrc/fine_raster.cu``) runs one block per tile (``tiles_per_cell`` = 1,
K2) or per TPG tiles (4 or 8, K3), skips fully masked chunks and keeps the
z-buffer in registers; see the note at its top.

Dispatch: ``fine_raster`` takes the plain version for tensors on the CPU
and launches the kernel for CUDA tensors. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

FIELDS = 16  # 15 line coefficients [L0|L1|L2|Lsum|Lz] x (x, y, c) + 1 pad row
TILES_PER_CELL = (1, 4, 8)  # the kernel's instantiations (TPG)
TILES = (16, 32, 64)
SOURCE = "fine_raster.cu"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
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


def _check(G, ids, md, chunk, tile, tiles_per_cell):
    n_tiles, n_chunks, C = ids.shape
    dev = G.device
    want = (
        (G, torch.float32, (n_tiles, n_chunks, FIELDS, C)),
        (ids, torch.int32, (n_tiles, n_chunks, C)),
        (md, torch.float32, (n_tiles, tile * tile)),
    )
    for t, dt, shape in want:
        if t.device != dev:
            raise ValueError(f"fine_raster: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"fine_raster: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fine_raster: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("fine_raster: inputs must be contiguous")
    if C != chunk:
        raise ValueError(f"fine_raster: chunk {chunk} but C = {C}")
    if tile not in TILES:
        raise ValueError(f"fine_raster: tile {tile} not supported {TILES}")
    if tiles_per_cell not in TILES_PER_CELL:
        raise ValueError(f"fine_raster: tiles_per_cell {tiles_per_cell} not in {TILES_PER_CELL}")


def fine_raster(
    G: torch.Tensor,
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
    """Per-tile (w, t): best depth (inf = none) and winner id (-1).

    CPU tensors take ``fine_raster_reference``; CUDA tensors launch the
    kernel (``fine_raster.launches`` and ``fine_raster.launches_by_shape``,
    keyed by (tile, tiles_per_cell), count those launches)."""
    _check(G, ids, md, chunk, tile, tiles_per_cell)
    if G.device.type == "cpu":
        return fine_raster_reference(
            G, ids, md, near, far, chunk, tw, tile_offset, tile, tiles_per_cell
        )
    if G.device.type != "cuda":
        raise ValueError(f"fine_raster: unsupported device {G.device}")
    lib = nvcc.load(SOURCE, "sl_fine_raster", _ARGTYPES)
    n_tiles, n_chunks, C = ids.shape
    w = torch.empty((n_tiles, tile * tile), dtype=torch.float32, device=G.device)
    t = torch.empty((n_tiles, tile * tile), dtype=torch.int32, device=G.device)
    err = lib.sl_fine_raster(
        G.data_ptr(), ids.data_ptr(), md.data_ptr(), w.data_ptr(), t.data_ptr(),
        n_tiles, n_chunks, C, tile, tw, int(tile_offset), tiles_per_cell,
        float(near), float(far), nvcc.stream_of(G),
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
