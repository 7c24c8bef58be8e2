"""Compact-cell z-buffer, cells to tiles: the Hopper kernel and its plain
PyTorch version.

Replaces ``stillleben_tpu/ops/cell_raster.py::_kernel`` (reached through
``cell_raster_pallas``) together with the row gather before it and the
cells -> tiles merge after it (``stillleben_tpu/render/rasterize_tiled.py``
:334 and :360-377). A CELL is up to C triangle ids of one screen tile; per
cell the 5 homogeneous edge lines ``[L0|L1|L2|Lsum|Lz]`` are evaluated at
the tile's pixel centres, the inside test for either winding applied, and
``wp = Ez / Esum`` kept where ``|Esum| > 1e-20`` and ``near < wp <= far``
and ``wp > md + 1e-5`` and ``id >= 0``; the per-pixel minimum ``wp`` wins,
the lowest id at equal depth, first within a cell and then across the
cells of a tile. An invalid cell (``cell_tile >= n_tiles``) adds nothing.

- ``cell_raster_reference`` is the per-cell function of the JAX ``_kernel``
  on the gathered rows ``G = LT[ids]``; ``merge_cells`` is the JAX merge.
- ``cell_raster_plain`` composes them: gather, per-cell z-buffer, merge.
- ``cell_raster`` computes the same function: the plain version for
  tensors on the CPU, the CUDA kernel (``csrc/cell_raster.cu``) for CUDA
  tensors. The kernel gathers the rows itself and folds the merge into a
  64-bit ``atomicMin`` of ``(orderable(w) << 32) | id`` per tile pixel;
  ``depth_keys`` is that packing in PyTorch. A failed build or launch
  raises.

What bounds it on the card: operations at the camera shape, bytes at the
shadow shape, with the operations counted from what the data needs; see
the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

FIELDS = 16  # 15 line coefficients [L0|L1|L2|Lsum|Lz] x (x, y, c) + 1 pad
SOURCE = "cell_raster.cu"
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]
TILES = (16, 32, 64)


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
    """The per-cell function of the JAX ``_kernel`` in plain PyTorch: the
    math on (cells, C, tile^2) tensors, ``chunk_cells`` cells at a time so the
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


def merge_cells(w_c, t_c, cell_tile, n_tiles: int):
    """Cells -> tiles: scatter-min of depth, then the lowest id among cells
    at that depth (rasterize_tiled.py:360-377). Returns (depth, tri) per
    tile, (n_tiles, tile^2)."""
    dev = w_c.device
    pix = w_c.shape[1]
    inf = float("inf")
    idx = cell_tile.long()[:, None].expand(-1, pix)
    wt = torch.full((n_tiles + 1, pix), inf, device=dev).scatter_reduce_(
        0, idx, w_c, "amin"
    )
    big_id = 2**31 - 1
    cand = torch.where(
        (w_c <= wt[cell_tile.long()]) & (w_c < inf) & (t_c >= 0), t_c, big_id
    )
    tt = torch.full((n_tiles + 1, pix), big_id, dtype=torch.int32, device=dev).scatter_reduce_(
        0, idx, cand, "amin"
    )
    depth_t = wt[:n_tiles]
    tri_t = torch.where(depth_t < inf, tt[:n_tiles], -1)
    return depth_t, tri_t


def cell_raster_plain(
    LT: torch.Tensor,  # (F, FIELDS) f32 packed line table
    ids: torch.Tensor,  # (MAXC, C) i32, -1 = masked
    cell_tile: torch.Tensor,  # (MAXC,) i32, n_tiles = invalid cell
    md_tiles: torch.Tensor | None,  # (n_tiles + 1, tile^2) f32 floor, None = 0
    near: float,
    far: float,
    tw: int,
    tile: int,
    n_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain pieces composed: the row gather, the per-cell z-buffer and
    the merge. Returns per-tile (depth, tri), (n_tiles, tile^2)."""
    n_cells, C = ids.shape
    G = LT[torch.clamp(ids, min=0).long().reshape(-1)].reshape(n_cells, C, FIELDS)
    if md_tiles is None:
        mdc = torch.zeros((n_cells, tile * tile), device=LT.device)
    else:
        mdc = md_tiles[cell_tile.long()]
    w_c, t_c = cell_raster_reference(G, ids, cell_tile, mdc, near, far, tw, tile, n_tiles)
    return merge_cells(w_c, t_c, cell_tile, n_tiles)


def _orderable(w: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) whose order is the float order, -0.0
    taken as +0.0 (raster_common.cuh::orderable)."""
    u = (w + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, 0xFFFFFFFF - u, u + 2**31)


def depth_keys(w: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The kernels' 64-bit merge key ``(orderable(w) << 32) | low`` as int64
    (its top bit flipped, so the signed order is the unsigned order);
    ``low`` is an id, or ``(chunk << 24) | id``. Empty is the int64 max."""
    return (_orderable(w) - 2**31) * 2**32 + (low.to(torch.int64) & 0xFFFFFFFF)


def keys_to_depth(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The unpack kernel's inverse of ``depth_keys``: (depth, low), with
    the empty key as (inf, -1)."""
    o = torch.div(keys, 2**32, rounding_mode="floor") + 2**31
    low = keys - (o - 2**31) * 2**32
    u = torch.where(o >= 2**31, o - 2**31, 0xFFFFFFFF - o)
    w = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)
    empty = keys == torch.iinfo(torch.int64).max
    return torch.where(empty, float("inf"), w), torch.where(empty, -1, low).to(torch.int32)


def _check(LT, ids, cell_tile, md_tiles, tile, n_tiles):
    n_cells, _ = ids.shape
    dev = LT.device
    want = [
        (LT, torch.float32, (LT.shape[0], FIELDS)),
        (ids, torch.int32, (n_cells, ids.shape[1])),
        (cell_tile, torch.int32, (n_cells,)),
    ]
    if md_tiles is not None:
        want.append((md_tiles, torch.float32, (n_tiles + 1, tile * tile)))
    for t, dt, shape in want:
        if t.device != dev:
            raise ValueError(f"cell_raster: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"cell_raster: expected {dt}, got {t.dtype}")
        if tuple(t.shape) != shape or t.dim() != len(shape):
            raise ValueError(f"cell_raster: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("cell_raster: inputs must be contiguous")
    if tile not in TILES:
        raise ValueError(f"cell_raster: tile {tile} not supported {TILES}")


def cell_raster(
    LT: torch.Tensor,
    ids: torch.Tensor,
    cell_tile: torch.Tensor,
    md_tiles: torch.Tensor | None,
    near: float,
    far: float,
    tw: int,
    tile: int,
    n_tiles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (depth, tri), (n_tiles, tile^2): best depth (inf = none)
    and winner id (-1). Every id must index a row of ``LT``.

    CPU tensors take ``cell_raster_plain``; CUDA tensors launch the kernel
    (``cell_raster.launches`` and ``cell_raster.launches_by_tile`` count
    those launches)."""
    _check(LT, ids, cell_tile, md_tiles, tile, n_tiles)
    if LT.device.type == "cpu":
        return cell_raster_plain(LT, ids, cell_tile, md_tiles, near, far, tw, tile, n_tiles)
    if LT.device.type != "cuda":
        raise ValueError(f"cell_raster: unsupported device {LT.device}")
    if LT.data_ptr() % 16:
        raise ValueError("cell_raster: LT must be 16-byte aligned (cp.async rows)")
    lib = nvcc.load(SOURCE, "sl_cell_raster", _ARGTYPES)
    n_cells, C = ids.shape
    pix = tile * tile
    dev = LT.device
    keys = torch.empty((n_tiles, pix), dtype=torch.int64, device=dev)
    w = torch.empty((n_tiles, pix), dtype=torch.float32, device=dev)
    t = torch.empty((n_tiles, pix), dtype=torch.int32, device=dev)
    err = lib.sl_cell_raster(
        LT.data_ptr(), ids.data_ptr(), cell_tile.data_ptr(),
        0 if md_tiles is None else md_tiles.data_ptr(), keys.data_ptr(), w.data_ptr(),
        t.data_ptr(), n_cells, C, tile, tw, n_tiles, float(near), float(far),
        nvcc.stream_of(LT),
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
