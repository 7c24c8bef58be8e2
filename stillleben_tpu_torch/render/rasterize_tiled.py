"""Tile-binned rasterizers (the camera and shadow z-buffer).

Counterpart of ``stillleben_tpu/render/rasterize_tiled.py``, both paths:

- the compact-cell path (``rasterize_vertices_cells``, the default): every
  active triangle emits one (tile + depth)-keyed pair per tile it may cover
  (1-, 4- and 16-slot span classes; big or behind-camera triangles go to
  every tile); one stable sort orders the pairs by tile, near first; each
  tile's pairs are cut into cells of ``CHUNK`` triangles under a static
  cell budget; the cell kernel (``ops/cell_raster.py``) z-buffers every
  cell and merges cells into tiles, the lowest id winning ties;
- the classic span-class path (``rasterize_vertices``, ``raster="classic"``):
  sub-4-px triangles go to an exact per-pixel stage (two scatter-mins),
  triangles of up to 4x4 tiles to per-tile lists of ``tile_capacity``
  slots (depth-sorted, the farthest dropped), the rest to one global list
  of ``big_capacity`` slots appended to every tile; the fine kernel
  (``ops/fine_raster.py``) z-buffers each tile's chunks in order.

Both kernels take the packed line table ``LT`` and the triangle ids and
gather the rows themselves.

Class windows, capacities and sorts are the same as in JAX, so the kernels'
inputs have the same layout in both packages. Not ported: the facing cull
(``cull_sign``, ``SL_BACKFACE_CULL``) and the classic path's XLA scan
fallback (``use_pallas=False``), which breaks equal-depth ties by slot, not
by id.
"""

from __future__ import annotations

import torch

from ..core import math as m
from ..ops.cell_raster import FIELDS, cell_raster
from ..ops.fine_raster import fine_raster
from .atlas import RenderInputs, SceneAtlas
from .camera import DEFAULT_FAR, DEFAULT_NEAR
from .rasterize import GBuffer, GeometryBuffers

TILE = 16
SPAN_TILES = 4
CHUNK = 128  # triangles per cell (C)
TILE_CAP = 8192  # per-tile pair cap: beyond it the farthest pairs drop
BIG_CAPACITY = 64  # "big" triangles per camera frame
PIXEL_WINDOW = 4  # classic path: tiny-class bbox limit in pixels
MAX_TILES_PER_PASS = 4096  # classic path: tiles per fine-kernel launch (caps
# the plain version's gathered line table at high tile counts)
RASTERS = ("cells", "classic")


def _edge_lines(v: torch.Tensor) -> torch.Tensor:
    """(..., 3 verts, 3 coords) -> (..., 3 edges, 3 coefs)."""
    return torch.stack(
        [m.cross(v[..., 1, :], v[..., 2, :]), m.cross(v[..., 2, :], v[..., 0, :]),
         m.cross(v[..., 0, :], v[..., 1, :])],
        dim=-2,
    )


def untile_img(x: torch.Tensor, tw: int, th: int, pad_h: int, pad_w: int,
               height: int, width: int, tile: int = TILE) -> torch.Tensor:
    """(n_tiles, tile^2) tile-major -> (H, W) image."""
    return (
        x.reshape(th, tw, tile, tile).permute(0, 2, 1, 3).reshape(pad_h, pad_w)[:height, :width]
    )


def _bounds(v, depth_attr, tri_active, width: int, height: int, near: float, far: float):
    """Classify (rasterize_tiled.py:434-456): returns (all_front, the
    clipped pixel bbox x0, x1, y0, y1, zmin, active), where active drops
    triangles behind the near plane and front triangles off screen or out
    of the depth range."""
    w = v[..., 2]
    all_front = (w > 1e-6).all(dim=-1)
    safe_w = torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)
    u_px = v[..., 0] / safe_w
    v_px = v[..., 1] / safe_w
    umin, umax = u_px.amin(-1), u_px.amax(-1)
    vmin, vmax = v_px.amin(-1), v_px.amax(-1)
    x0 = torch.clamp(torch.floor(umin), 0, width - 1)
    x1 = torch.clamp(torch.ceil(umax), 0, width - 1)
    y0 = torch.clamp(torch.floor(vmin), 0, height - 1)
    y1 = torch.clamp(torch.ceil(vmax), 0, height - 1)
    on_screen = (umax >= 0) & (umin < width) & (vmax >= 0) & (vmin < height)
    zmin = depth_attr.amin(-1)
    zmax = depth_attr.amax(-1)
    in_range = (zmax > near) & (zmin <= far)
    active = tri_active & (zmax > near)
    active = active & ~(all_front & (~on_screen | ~in_range))
    return all_front, x0, x1, y0, y1, zmin, active


def _line_table(v: torch.Tensor, depth_attr: torch.Tensor):
    """(Lf (F, 3, 3), LT (F, FIELDS)): the edge lines and the packed line
    table [L0|L1|L2|Lsum|Lz] x (x, y, c) with one pad column."""
    Lf = _edge_lines(v)
    Lsum = Lf[:, 0] + Lf[:, 1] + Lf[:, 2]
    d = depth_attr[:, :, None]
    Lz = Lf[:, 0] * d[:, 0] + Lf[:, 1] * d[:, 1] + Lf[:, 2] * d[:, 2]
    pad = torch.zeros((v.shape[0], FIELDS - 15), device=v.device)
    return Lf, torch.cat([Lf.reshape(-1, 9), Lsum, Lz, pad], dim=1)


def build_cells(
    v: torch.Tensor,  # (F, 3, 3) homogeneous vertex coords (u*w, v*w, w)
    depth_attr: torch.Tensor,  # (F, 3) per-vertex depth to interpolate and test
    tri_active: torch.Tensor,  # (F,) bool
    width: int,
    height: int,
    near: float,
    far: float,
    big_capacity: int,
    tile: int = TILE,
):
    """Everything before the kernel (rasterize_tiled.py:94-333): returns
    (LT, ids, cell_tile, tw, th, n_tiles) with LT (F, FIELDS) the packed
    line table and ids (MAXC, C) the triangle ids (-1 = masked)."""
    dev = v.device
    F = v.shape[0]
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    i32 = dict(dtype=torch.int32, device=dev)

    all_front, x0, x1, y0, y1, zmin, active = _bounds(
        v, depth_attr, tri_active, width, height, near, far
    )
    tx0 = (x0 / tile).to(torch.int32)
    tx1 = (x1 / tile).to(torch.int32)
    ty0 = (y0 / tile).to(torch.int32)
    ty1 = (y1 / tile).to(torch.int32)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1

    fits = active & all_front
    one_tile = fits & (span_x == 1) & (span_y == 1)
    class2 = fits & ~one_tile & (span_x <= 2) & (span_y <= 2)
    class4 = fits & ~one_tile & ~class2 & (span_x <= SPAN_TILES) & (span_y <= SPAN_TILES)
    big = active & ~one_tile & ~class2 & ~class4  # incl. behind-camera verts

    znorm = torch.clamp(zmin / far, 0.0, 1.0) * 0.999
    sentinel = float(n_tiles + 2)

    # One stable sort by class: [big | one_tile | class2 | class4 | rest];
    # each class reads a fixed-size window at its start offset, and
    # overflow cascades into the next wider window (rasterize_tiled.py:153-263).
    cap1 = F
    cap2 = int(min(F, max(32768, F // 3)))
    cap4 = int(min(F, max(2048, F // 64)))
    class_key = torch.full((F,), 4, **i32)
    class_key = torch.where(class4, 3, class_key)
    class_key = torch.where(class2, 2, class_key)
    class_key = torch.where(one_tile, 1, class_key)
    class_key = torch.where(big, 0, class_key)
    sorted_ids = torch.sort(class_key, stable=True).indices.to(torch.int32)
    sorted_ids = torch.cat(
        [sorted_ids, torch.full((cap1 + cap2 + cap4 + big_capacity,), -1, **i32)]
    )
    count1 = one_tile.sum()
    count2 = class2.sum()
    count4 = class4.sum()
    countb = big.sum()

    packed = torch.stack(
        [tx0.float(), ty0.float(), span_x.float(), span_y.float(), znorm], dim=1
    )  # (F, 5)

    start1 = countb
    start2 = start1 + torch.minimum(count1, torch.tensor(cap1, device=dev))
    n_in2 = countb + count1 + count2 - start2
    start4 = start2 + torch.minimum(n_in2, torch.tensor(cap2, device=dev))

    def window(start, cap, n_in):
        ar = torch.arange(cap, device=dev)
        return sorted_ids[start + ar], ar < n_in

    def span_keys(ids, ok, span_budget):
        f = packed[ids.long()]  # (cap, 5); id -1 reads the last row, masked below
        s = torch.arange(span_budget * span_budget, dtype=torch.float32, device=dev)
        sx = torch.remainder(s, span_budget)
        sy = torch.floor(s / span_budget)
        ptx = f[None, :, 0] + sx[:, None]
        pty = f[None, :, 1] + sy[:, None]
        pok = ok[None, :] & (sx[:, None] < f[None, :, 2]) & (sy[:, None] < f[None, :, 3])
        key = torch.where(pok, pty * tw + ptx + f[None, :, 4], sentinel).reshape(-1)
        tri = ids[None, :].expand(s.shape[0], ids.shape[0]).reshape(-1)
        return key, tri

    ids1, ok1 = window(start1, cap1, count1)
    ids2, ok2 = window(start2, cap2, n_in2)
    ids4, ok4 = window(start4, cap4, countb + count1 + count2 + count4 - start4)
    key1, tri1 = span_keys(ids1, ok1, 1)
    key2, tri2 = span_keys(ids2, ok2, 2)
    key4, tri4 = span_keys(ids4, ok4, SPAN_TILES)

    # big window: the first countb sorted faces x every tile
    big_ids, big_ok = window(0, big_capacity, countb)
    tile_ids = torch.arange(n_tiles, dtype=torch.float32, device=dev)
    keyb = torch.where(
        big_ok[None, :], tile_ids[:, None] + znorm[big_ids.long()][None, :], sentinel
    ).reshape(-1)
    trib = big_ids[None, :].expand(n_tiles, big_capacity).reshape(-1)

    key = torch.cat([key1, key2, key4, keyb])
    pair_tri = torch.cat([tri1, tri2, tri4, trib])
    sorted_key, perm = torch.sort(key, stable=True)
    sorted_tri = pair_tri[perm]
    n_pairs = sorted_tri.shape[0]

    # per-tile pair ranges -> compact cell list (rasterize_tiled.py:287-321)
    bounds = torch.searchsorted(
        sorted_key, torch.arange(n_tiles + 1, dtype=torch.float32, device=dev)
    )
    starts = bounds[:-1]
    counts = torch.clamp(bounds[1:] - starts, max=TILE_CAP)
    C = CHUNK
    ncells = (counts + C - 1) // C
    cum = torch.cumsum(ncells, 0)
    total = cum[-1]
    # the static cell budget of rasterize_tiled.py:297-305, so the cells are
    # laid out as in the JAX package
    max_cells = int(min(n_pairs // C + n_tiles, n_tiles + max(512, (F * 2) // C)))
    j = torch.arange(max_cells, device=dev)
    t_of = torch.searchsorted(cum, j, right=True)
    t_cl = torch.clamp(t_of, max=n_tiles - 1)
    base = cum[t_cl] - ncells[t_cl]
    j_in = j - base
    cell_valid = j < total
    cell_tile = torch.where(cell_valid, t_cl, n_tiles).to(torch.int32)
    offs = torch.arange(C, device=dev)
    gi = (starts[t_cl] + j_in * C)[:, None] + offs[None, :]
    in_count = (j_in[:, None] * C + offs[None, :]) < counts[t_cl][:, None]
    ids = torch.where(
        cell_valid[:, None] & in_count,
        sorted_tri[torch.clamp(gi, 0, n_pairs - 1)],
        -1,
    ).to(torch.int32)  # (MAXC, C)

    _, LT = _line_table(v, depth_attr)
    return LT, ids, cell_tile, tw, th, n_tiles


def rasterize_vertices_cells(
    v: torch.Tensor,
    depth_attr: torch.Tensor,
    tri_active: torch.Tensor,
    width: int,
    height: int,
    near: float,
    far: float,
    big_capacity: int,
    tile: int = TILE,
):
    """Compact-cell binned z-buffer (rasterize_tiled.py:54-383). Returns
    (depth image, triangle-id image), both (H, W). The depth-peel floor
    the kernel takes is 0 everywhere (alpha peel is not ported)."""
    LT, ids, cell_tile, tw, th, n_tiles = build_cells(
        v, depth_attr, tri_active, width, height, near, far, big_capacity, tile=tile
    )
    depth_t, tri_t = cell_raster(
        LT, ids, cell_tile, None, float(near), float(far), tw, tile, n_tiles
    )
    pad_w, pad_h = tw * tile, th * tile
    depth_img = untile_img(depth_t, tw, th, pad_h, pad_w, height, width, tile)
    tri_img = untile_img(tri_t, tw, th, pad_h, pad_w, height, width, tile)
    return depth_img, tri_img


def _compact(mask: torch.Tensor, cap: int):
    """The first ``cap`` indices where ``mask`` holds, by a cumsum rank and
    a scatter into a dump slot at ``cap`` (rasterize_tiled.py:503-508), no
    sort: returns (ids (cap,) i32, 0 past the count; ok (cap,) bool)."""
    F = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    src = torch.where(mask & (rank < cap), rank, cap).long()
    ar = torch.arange(F, dtype=torch.int32, device=mask.device)
    ids = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device).scatter_(0, src, ar)[:cap]
    ok = torch.arange(cap, device=mask.device) < mask.sum()
    return ids, ok


def build_tile_lists(
    v: torch.Tensor,  # (F, 3, 3) homogeneous vertex coords (u*w, v*w, w)
    depth_attr: torch.Tensor,  # (F, 3)
    tri_active: torch.Tensor,  # (F,) bool
    width: int,
    height: int,
    near: float,
    far: float,
    tile_capacity: int,
    big_capacity: int,
    fine_chunk: int,
    pixel_stage: bool,
    tile: int = TILE,
):
    """Everything of the classic path before the fine kernel
    (rasterize_tiled.py:428-609). Returns a dict: ``ids`` (n_tiles,
    n_chunks, fine_chunk) i32, each tile's slots (its ``tile_capacity``
    list, then the global big list, -1 where masked); ``LT`` (F, FIELDS)
    the packed line table; ``Lf`` the edge lines; ``tw``, ``th``,
    ``n_tiles``; and what the pixel stage needs (``tiny``, ``px_span_x``,
    ``px_span_y``, ``x0``, ``y0``)."""
    dev = v.device
    F = v.shape[0]
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    all_front, x0, x1, y0, y1, zmin, active = _bounds(
        v, depth_attr, tri_active, width, height, near, far
    )
    px_span_x = (x1.to(torch.int32) - x0.to(torch.int32)) + 1
    px_span_y = (y1.to(torch.int32) - y0.to(torch.int32)) + 1
    if pixel_stage:
        tiny = active & all_front & (px_span_x <= PIXEL_WINDOW) & (px_span_y <= PIXEL_WINDOW)
    else:  # low-poly scenes: everything goes through the tile lists
        tiny = torch.zeros_like(active)
    tx0 = (x0 / tile).to(torch.int32)
    tx1 = (x1 / tile).to(torch.int32)
    ty0 = (y0 / tile).to(torch.int32)
    ty1 = (y1 / tile).to(torch.int32)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    small = active & all_front & ~tiny & (span_x <= SPAN_TILES) & (span_y <= SPAN_TILES)
    big = active & ~small & ~tiny
    znorm = torch.clamp(zmin / far, 0.0, 1.0) * 0.999

    def span_class_pairs(mask, span_budget, cap):
        """(key, tri) pairs of a compacted span class (:501-528)."""
        ids, ok = _compact(mask, cap)
        il = ids.long()
        s = torch.arange(span_budget * span_budget, dtype=torch.int32, device=dev)
        sx = s % span_budget
        sy = s // span_budget
        ptx = tx0[il][None, :] + sx[:, None]
        pty = ty0[il][None, :] + sy[:, None]
        pok = ok[None, :] & (sx[:, None] < span_x[il][None, :]) & (sy[:, None] < span_y[il][None, :])
        ptile = pty * tw + ptx
        key = torch.where(
            pok, ptile.to(torch.float32) + znorm[il][None, :], float(n_tiles + 2)
        ).reshape(-1)
        tri = ids[None, :].expand(s.shape[0], cap).reshape(-1)
        return key, tri

    small2 = small & (span_x <= 2) & (span_y <= 2)
    small4 = small & ~small2
    cap2 = int(min(F, max(16384, F // 8)))
    cap4 = int(min(F, max(4096, F // 32)))
    key2, tri2 = span_class_pairs(small2, 2, cap2)
    key4, tri4 = span_class_pairs(small4, SPAN_TILES, cap4)
    key = torch.cat([key2, key4])
    pair_tri = torch.cat([tri2, tri4])

    # per-tile lists (:539-548): a stable sort of the f32 keys, then the
    # first tile_capacity pairs from each tile's left search position
    sorted_key, order = torch.sort(key, stable=True)
    sorted_tri = pair_tri[order]
    sorted_tile = torch.floor(sorted_key).to(torch.int32)
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_key, tiles.to(torch.float32))
    offs = torch.arange(tile_capacity, device=dev)
    gi = torch.clamp(starts[:, None] + offs[None, :], 0, sorted_tri.shape[0] - 1)
    tile_ok = sorted_tile[gi] == tiles[:, None]
    # the global big list (:550-570) appended to every tile
    big_ids, big_ok = _compact(big, big_capacity)
    tile_tris = torch.cat([sorted_tri[gi], big_ids[None].expand(n_tiles, -1)], dim=1)
    tile_ok = torch.cat([tile_ok, big_ok[None].expand(n_tiles, -1)], dim=1)

    K = tile_tris.shape[1]
    n_chunks = -(-K // fine_chunk)
    ids = torch.full((n_tiles, n_chunks * fine_chunk), -1, dtype=torch.int32, device=dev)
    ids[:, :K] = torch.where(tile_ok, tile_tris, -1)
    Lf, LT = _line_table(v, depth_attr)
    return dict(
        ids=ids.reshape(n_tiles, n_chunks, fine_chunk), LT=LT, Lf=Lf, tw=tw, th=th,
        n_tiles=n_tiles, tiny=tiny, px_span_x=px_span_x, px_span_y=px_span_y, x0=x0, y0=y0,
    )


def fine_stage(ids, LT, md_tiles, near, far, fine_chunk, tw, tile, tiles_per_cell=1):
    """The fine kernel, slabbed over ``MAX_TILES_PER_PASS`` tiles
    (:627-659). Returns per-tile (w, t)."""
    n_tiles = ids.shape[0]
    w_parts, t_parts = [], []
    for t0 in range(0, n_tiles, MAX_TILES_PER_PASS):
        ids_s = ids[t0 : t0 + MAX_TILES_PER_PASS]
        w, t = fine_raster(
            LT, ids_s.contiguous(), md_tiles[t0 : t0 + ids_s.shape[0]].contiguous(), float(near),
            float(far), fine_chunk, tw, tile_offset=t0, tile=tile, tiles_per_cell=tiles_per_cell,
        )
        w_parts.append(w)
        t_parts.append(t)
    if len(w_parts) == 1:
        return w_parts[0], t_parts[0]
    return torch.cat(w_parts), torch.cat(t_parts)


def rasterize_vertices(
    v: torch.Tensor,
    depth_attr: torch.Tensor,
    tri_active: torch.Tensor,
    width: int,
    height: int,
    near: float,
    far: float,
    tile_capacity: int,
    big_capacity: int,
    fine_chunk: int,
    pixel_stage: bool = True,
    tile: int = TILE,
    tiles_per_cell: int = 1,
):
    """Classic span-class binned z-buffer (rasterize_tiled.py:386-668, the
    kernel path). Returns (depth image, triangle-id image), both (H, W).
    The depth-peel floor is 0 everywhere (alpha peel is not ported)."""
    lists = build_tile_lists(
        v, depth_attr, tri_active, width, height, near, far, tile_capacity, big_capacity,
        fine_chunk, pixel_stage, tile=tile,
    )
    tw, th, n_tiles = lists["tw"], lists["th"], lists["n_tiles"]
    md_tiles = torch.zeros((n_tiles, tile * tile), device=v.device)
    depth_t, tri_t = fine_stage(
        lists["ids"], lists["LT"], md_tiles, near, far, fine_chunk, tw, tile, tiles_per_cell
    )
    pad_w, pad_h = tw * tile, th * tile
    depth_img = untile_img(depth_t, tw, th, pad_h, pad_w, height, width, tile)
    tri_img = untile_img(tri_t, tw, th, pad_h, pad_w, height, width, tile)
    if pixel_stage:
        depth_img, tri_img = _run_pixel_stages(
            lists["Lf"], depth_attr, lists["tiny"], lists["px_span_x"], lists["px_span_y"],
            lists["x0"], lists["y0"], width, height, near, far, depth_img, tri_img,
        )
    return depth_img, tri_img


def _run_pixel_stages(
    Lf, depth_attr, tiny, px_span_x, px_span_y, x0, y0, width, height, near, far,
    depth_img, tri_img,
):
    """The exact per-pixel stage (:764-795): sub-2-px triangles pay a
    4-pair window, the compacted 2-4-px rest a 16-pair window; both pair
    lists feed one resolve."""
    F = Lf.shape[0]
    tiny2 = tiny & (px_span_x <= 2) & (px_span_y <= 2)
    pid2, w2, tid2 = _pixel_pairs(
        Lf, depth_attr, tiny2, x0, y0, width, height, near, far, window=2
    )
    tiny4 = tiny & ~tiny2
    cap4 = int(min(F, max(4096, F // 16)))
    ids4, ok4 = _compact(tiny4, cap4)
    il = ids4.long()
    pid4, w4, tid4 = _pixel_pairs(
        Lf[il], depth_attr[il], ok4, x0[il], y0[il], width, height, near, far,
        window=4, tri_ids=ids4,
    )
    return _resolve_pixel_pairs(
        torch.cat([pid2, pid4]), torch.cat([w2, w4]), torch.cat([tid2, tid4]),
        width, height, depth_img, tri_img,
    )


def _pixel_pairs(Lf, depth_attr, tiny, x0, y0, width, height, near, far,
                 window=PIXEL_WINDOW, tri_ids=None):
    """(pixel id, depth, triangle id) covering pairs of one tiny span class
    (:798-857): centre coverage of every (triangle, window pixel) pair;
    ``tri_ids`` names the triangles of a compacted subset."""
    dev = Lf.device
    F = Lf.shape[0]
    n_px = width * height
    win = torch.arange(window * window, dtype=torch.int32, device=dev)
    px = x0.to(torch.int32)[None, :] + (win % window)[:, None]  # (n_win, F)
    py = y0.to(torch.int32)[None, :] + (win // window)[:, None]
    in_image = (px < width) & (py < height)
    pix_id = py * width + px
    cx = px.to(torch.float32) + 0.5
    cy = py.to(torch.float32) + 0.5
    E0 = Lf[None, :, 0, 0] * cx + Lf[None, :, 0, 1] * cy + Lf[None, :, 0, 2]
    E1 = Lf[None, :, 1, 0] * cx + Lf[None, :, 1, 1] * cy + Lf[None, :, 1, 2]
    E2 = Lf[None, :, 2, 0] * cx + Lf[None, :, 2, 1] * cy + Lf[None, :, 2, 2]
    inside = ((E0 >= 0) & (E1 >= 0) & (E2 >= 0)) | ((E0 <= 0) & (E1 <= 0) & (E2 <= 0))
    Esum = E0 + E1 + E2
    denom = torch.where(Esum.abs() < 1e-20, torch.ones_like(Esum), Esum)
    wp = (
        E0 * depth_attr[None, :, 0] + E1 * depth_attr[None, :, 1] + E2 * depth_attr[None, :, 2]
    ) / denom
    covers = (
        tiny[None, :] & in_image & inside & (Esum.abs() > 1e-20) & (wp > near) & (wp <= far)
    )
    pid = torch.where(covers, pix_id, n_px).reshape(-1)  # n_px = dump slot
    wflat = torch.where(covers, wp, float("inf")).reshape(-1)
    tids = torch.arange(F, dtype=torch.int32, device=dev) if tri_ids is None else tri_ids
    return pid, wflat, tids[None, :].expand(window * window, F).reshape(-1)


def _resolve_pixel_pairs(pid, wflat, tid_pairs, width, height, depth_img, tri_img):
    """Winner per pixel with two scatter-mins (:860-887): the depth, then
    the lowest id among the pairs at exactly that depth; merged into the
    tile result with a strict ``<``, so the tile result keeps a tie."""
    n_px = width * height
    dev = wflat.device
    pid = pid.long()
    dmin = torch.full((n_px + 1,), float("inf"), device=dev).scatter_reduce_(
        0, pid, wflat, "amin"
    )
    big_id = 2**31 - 1
    cand = torch.where((wflat <= dmin[pid]) & torch.isfinite(wflat), tid_pairs, big_id)
    twin = torch.full((n_px + 1,), big_id, dtype=torch.int32, device=dev).scatter_reduce_(
        0, pid, cand, "amin"
    )
    cw = dmin[:n_px].reshape(height, width)
    ctri = twin[:n_px].reshape(height, width)
    better = cw < depth_img
    return torch.where(better, cw, depth_img), torch.where(better, ctri, tri_img)


def rasterize_tiled(
    geom: GeometryBuffers,
    atlas: SceneAtlas,
    inputs: RenderInputs,
    width: int,
    height: int,
    raster: str = "cells",
    tile_capacity: int = 256,
    big_capacity: int = BIG_CAPACITY,
    fine_chunk: int = 128,
    pixel_stage: bool | None = None,
    tiles_per_cell: int = 1,
) -> GBuffer:
    """Camera raster (rasterize_tiled.py:890-934, two-sided), through the
    cell path or, with ``raster="classic"``, the span-class path (the JAX
    package's ``SL_RASTER``). ``pixel_stage`` None means on for more than
    20,000 faces. Barycentrics and facing are recomputed in shading."""
    faces = atlas.faces.long()
    v = geom.pix_hom[faces]  # (F, 3, 3)
    visible = inputs.obj_visible[atlas.face_obj.long()]
    if raster == "cells":
        depth_img, tri_img = rasterize_vertices_cells(
            v, v[..., 2], visible, width, height, DEFAULT_NEAR, DEFAULT_FAR, big_capacity
        )
    elif raster == "classic":
        if pixel_stage is None:
            pixel_stage = faces.shape[0] > 20_000
        depth_img, tri_img = rasterize_vertices(
            v, v[..., 2], visible, width, height, DEFAULT_NEAR, DEFAULT_FAR, tile_capacity,
            big_capacity, fine_chunk, pixel_stage, tiles_per_cell=tiles_per_cell,
        )
    else:
        raise ValueError(f"rasterize_tiled: raster {raster!r} not in {RASTERS}")
    return GBuffer(
        tri_id=tri_img,
        depth=depth_img,
        bary=torch.zeros((height, width, 3), device=v.device),
        front_facing=torch.zeros((height, width), dtype=torch.bool, device=v.device),
    )
