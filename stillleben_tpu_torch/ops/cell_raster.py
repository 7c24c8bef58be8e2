"""Compact-cell z-buffer: the Hopper kernel and its plain PyTorch version.

Replaces ``stillleben_tpu/ops/cell_raster.py::_kernel`` (reached through
``cell_raster_pallas``). A CELL is up to C triangles of one screen tile;
per cell the kernel evaluates the 5 homogeneous edge lines
``[L0|L1|L2|Lsum|Lz]`` at the tile's pixel centres, applies the inside test
for either winding, takes ``wp = Ez / Esum`` where ``|Esum| > 1e-20`` and
``near < wp <= far`` and ``wp > md + 1e-5`` and ``id >= 0``, and keeps the
per-pixel minimum ``wp`` with the lowest id at equal depth. An invalid cell
(``cell_tile >= n_tiles``) gives ``(inf, -1)``.

What bounds it on the card: arithmetic, ``cells x C x tile^2`` edge
evaluations (~170M for a 640x480 camera pass); inputs and outputs are a
few MB. The CUDA source (``csrc/cell_raster.cu``) runs one block per cell,
stages the cell's line rows in shared memory and keeps each pixel's running
winner in registers; see the note at its top.

Dispatch: ``cell_raster`` takes the plain version for tensors on the CPU
and launches the kernel for CUDA tensors. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

FIELDS = 16  # 15 line coefficients [L0|L1|L2|Lsum|Lz] x (x, y, c) + 1 pad
SOURCE = "cell_raster.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]


def cell_raster_reference(
    G: torch.Tensor,  # (MAXC, C, FIELDS) f32 line rows
    ids: torch.Tensor,  # (MAXC, C) i32, -1 = masked
    cell_tile: torch.Tensor,  # (MAXC,) i32, n_tiles = invalid cell
    md: torch.Tensor,  # (MAXC, tile^2) f32 depth-peel floor
    near: float,
    far: float,
    tw: int,
    tile: int,
    n_tiles: int,
    chunk_cells: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same math on
    (cells, C, tile^2) tensors, ``chunk_cells`` cells at a time so the
    transient stays bounded. Returns per-cell (w, t)."""
    n_cells, C = ids.shape
    pix_n = tile * tile
    dev = G.device
    pix = torch.arange(pix_n, dtype=torch.int32, device=dev)
    px = torch.remainder(pix, tile).to(torch.float32)
    py = torch.div(pix, tile, rounding_mode="floor").to(torch.float32)
    w_out = torch.empty((n_cells, pix_n), dtype=torch.float32, device=dev)
    t_out = torch.empty((n_cells, pix_n), dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    big_id = torch.tensor(2**30, dtype=torch.int32, device=dev)
    for c0 in range(0, n_cells, chunk_cells):
        sl = slice(c0, min(c0 + chunk_cells, n_cells))
        ti = cell_tile[sl]
        valid = ti < n_tiles
        tile_ox = float(tile) * torch.remainder(ti, tw).to(torch.float32)
        tile_oy = float(tile) * torch.div(ti, tw, rounding_mode="floor").to(torch.float32)
        X = (tile_ox[:, None] + px[None, :] + 0.5)[:, None, :]  # (n, 1, PIX)
        Y = (tile_oy[:, None] + py[None, :] + 0.5)[:, None, :]
        g = G[sl]

        def edge(e):  # (n, C, PIX) = (lx * X + ly * Y) + lc
            return (
                g[:, :, 3 * e, None] * X + g[:, :, 3 * e + 1, None] * Y
            ) + g[:, :, 3 * e + 2, None]

        E0, E1, E2, Esum, Ez = (edge(e) for e in range(5))
        inside = ((E0 >= 0) & (E1 >= 0) & (E2 >= 0)) | (
            (E0 <= 0) & (E1 <= 0) & (E2 <= 0)
        )
        del E0, E1, E2
        small = Esum.abs() < 1e-20
        wp = Ez / torch.where(small, torch.ones_like(Esum), Esum)
        idc = ids[sl][:, :, None]
        ok = (
            inside
            & (Esum.abs() > 1e-20)
            & (wp > near)
            & (wp <= far)
            & (wp > (md[sl] + 1e-5)[:, None, :])
            & (idc >= 0)
        )
        score = torch.where(ok, wp, inf)
        bw = score.amin(dim=1)  # (n, PIX)
        bt = torch.where((score == bw[:, None, :]) & ok, idc, big_id).amin(dim=1)
        bt = torch.where(bw < inf, bt, torch.full_like(bt, -1))
        w_out[sl] = torch.where(valid[:, None], bw, inf)
        t_out[sl] = torch.where(valid[:, None], bt, torch.full_like(bt, -1))
    return w_out, t_out


def _check(G, ids, cell_tile, md, tile):
    n_cells, C = ids.shape
    dev = G.device
    want = (
        (G, torch.float32, (n_cells, C, FIELDS)),
        (ids, torch.int32, (n_cells, C)),
        (cell_tile, torch.int32, (n_cells,)),
        (md, torch.float32, (n_cells, tile * tile)),
    )
    for t, dt, shape in want:
        if t.device != dev:
            raise ValueError(f"cell_raster: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"cell_raster: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"cell_raster: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("cell_raster: inputs must be contiguous")


def cell_raster(
    G: torch.Tensor,
    ids: torch.Tensor,
    cell_tile: torch.Tensor,
    md: torch.Tensor,
    near: float,
    far: float,
    tw: int,
    tile: int,
    n_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell (w, t): best depth (inf = none) and winner id (-1).

    CPU tensors take ``cell_raster_reference``; CUDA tensors launch the
    kernel (``cell_raster.launches`` and ``cell_raster.launches_by_tile``
    count those launches)."""
    _check(G, ids, cell_tile, md, tile)
    if G.device.type == "cpu":
        return cell_raster_reference(G, ids, cell_tile, md, near, far, tw, tile, n_tiles)
    if G.device.type != "cuda":
        raise ValueError(f"cell_raster: unsupported device {G.device}")
    if (tile * tile) not in (256, 1024, 4096):
        raise ValueError(f"cell_raster kernel: tile {tile} not supported (16, 32, 64)")
    lib = nvcc.load(SOURCE, "sl_cell_raster", _ARGTYPES)
    n_cells, C = ids.shape
    w = torch.empty((n_cells, tile * tile), dtype=torch.float32, device=G.device)
    t = torch.empty((n_cells, tile * tile), dtype=torch.int32, device=G.device)
    err = lib.sl_cell_raster(
        G.data_ptr(), ids.data_ptr(), cell_tile.data_ptr(), md.data_ptr(),
        w.data_ptr(), t.data_ptr(), n_cells, C, tile, tw, n_tiles,
        float(near), float(far), nvcc.stream_of(G),
    )
    nvcc.check(err, "cell_raster")
    cell_raster.launches += 1
    cell_raster.launches_by_tile[tile] = cell_raster.launches_by_tile.get(tile, 0) + 1
    return w, t


cell_raster.launches = 0
cell_raster.launches_by_tile = {}


def reset_launch_counts() -> None:
    cell_raster.launches = 0
    cell_raster.launches_by_tile = {}
