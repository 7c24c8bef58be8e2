"""The cell z-buffer of the PyTorch port against the JAX package's Pallas
kernel (run in interpret mode on the CPU), and the CUDA kernel against the
port's plain PyTorch version on a card.

Inputs are random triangles made from a numpy seed, turned into the
kernel's line rows the way the raster does, and handed to both packages.

- Per cell (``cell_raster_reference`` against ``cell_raster_pallas``) on
  perspective triangles: ``w`` within 1e-6 relative; ``t`` equal at every
  pixel whose best and second-best depth differ by more than 1e-6 relative
  (XLA on the CPU contracts ``a*x + b*y + c`` into fused multiply-adds,
  PyTorch does not, so near-ties may resolve differently).
- Cells to tiles (``cell_raster_plain`` against ``cell_raster_pallas`` and
  the JAX merge) on the exact grid, where every value is exact in float32
  in either evaluation order: equal, with equal depths across the cells of
  a tile, depths of +-0.0 and below 0 (the shadow pass's near plane is
  -1e-3), invalid cells and masked slots.
- The kernel's packed 64-bit keys: their minimum is the merge.
- On the card the kernel must match the plain version (``torch.equal``,
  which takes -0.0 and +0.0 as equal).
"""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.ops.cell_raster import (
    FIELDS,
    cell_raster,
    cell_raster_plain,
    cell_raster_reference,
    depth_keys,
    keys_to_depth,
    merge_cells,
)
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

NEAR, FAR = 0.1, 10.0
SPREAD = 6  # triangle vertices within +-SPREAD px of a centre


def make_cells(seed, tile, tw, th, n_cells, C=128):
    """Random (G, ids, cell_tile, md) in the kernel's layout: each cell's
    triangles lie around its tile; some slots masked, some cells invalid,
    one cell fully masked, some pixels with a depth-peel floor."""
    rng = np.random.default_rng(seed)
    n_tiles = tw * th
    cell_tile = rng.integers(0, n_tiles, n_cells).astype(np.int32)
    cell_tile[rng.random(n_cells) < 0.15] = n_tiles  # invalid cells
    ox = (cell_tile % tw) * tile
    oy = (cell_tile // tw) * tile
    # triangles of a few pixels around points of the tile, with vertices
    # on the integer pixel grid and w in {1, 1.5, 2}: every line
    # coefficient and edge value is then exact in float32, in either
    # evaluation order, so shared edges, pixel centres on an edge and equal
    # depths are real and both packages must resolve them the same way
    centre = rng.integers(-2, tile + 2, (n_cells, C, 1, 2))
    uv = (centre + rng.integers(-SPREAD, SPREAD + 1, (n_cells, C, 3, 2))).astype(np.float64)
    uv[..., 0] += ox[:, None, None]
    uv[..., 1] += oy[:, None, None]
    # odd triangles share the edge (v1, v2) of the even one before them
    uv[:, 1::2, 1:] = uv[:, 0:-1:2, 2:0:-1]
    w = rng.integers(2, 5, (n_cells, C, 3)) / 2.0
    w[:, 1::2, 1:] = w[:, 0:-1:2, 2:0:-1]
    v = np.concatenate([uv * w[..., None], w[..., None]], axis=-1).astype(np.float32)
    depth = w.astype(np.float32)
    L = np.stack(
        [np.cross(v[..., 1, :], v[..., 2, :]), np.cross(v[..., 2, :], v[..., 0, :]),
         np.cross(v[..., 0, :], v[..., 1, :])], axis=-2,
    ).astype(np.float32)  # (n, C, 3 edges, 3)
    Lsum = L[..., 0, :] + L[..., 1, :] + L[..., 2, :]
    Lz = L[..., 0, :] * depth[..., 0:1] + L[..., 1, :] * depth[..., 1:2] + L[..., 2, :] * depth[..., 2:3]
    G = np.zeros((n_cells, C, FIELDS), np.float32)
    G[..., :9] = L.reshape(n_cells, C, 9)
    G[..., 9:12] = Lsum
    G[..., 12:15] = Lz
    ids = rng.integers(0, 5000, (n_cells, C)).astype(np.int32)
    ids[:, 1::4] = ids[:, 0::4]  # duplicate ids, as big triangles repeat across cells
    ids[rng.random((n_cells, C)) < 0.2] = -1
    ids[1] = -1  # one cell with every slot masked
    md = np.where(rng.random((n_cells, tile * tile)) < 0.3,
                  rng.uniform(0.0, 2.0, (n_cells, tile * tile)), 0.0).astype(np.float32)
    return G, ids, cell_tile, md, n_tiles


def near_tie_mask(G, ids, cell_tile, md, tile, tw, n_tiles, rel=1e-6):
    """Pixels whose best and second-best candidate depths lie within
    ``rel`` of each other (recomputed in float64)."""
    n, C, _ = G.shape
    p = np.arange(tile * tile)
    g = G.astype(np.float64)
    ti = np.minimum(cell_tile, n_tiles - 1)
    X = (ti % tw * tile)[:, None] + p % tile + 0.5
    Y = (ti // tw * tile)[:, None] + p // tile + 0.5
    E = [g[:, :, 3 * e, None] * X[:, None] + g[:, :, 3 * e + 1, None] * Y[:, None]
         + g[:, :, 3 * e + 2, None] for e in range(5)]
    inside = ((E[0] >= 0) & (E[1] >= 0) & (E[2] >= 0)) | ((E[0] <= 0) & (E[1] <= 0) & (E[2] <= 0))
    wp = E[4] / np.where(np.abs(E[3]) < 1e-20, 1.0, E[3])
    ok = inside & (np.abs(E[3]) > 1e-20) & (wp > NEAR) & (wp <= FAR) & (wp > md[:, None] + 1e-5)
    ok &= ids[:, :, None] >= 0
    # distinct ids only: the same triangle twice is no tie
    score = np.where(ok, wp, np.inf)
    s = np.sort(score, axis=1)
    best, second = s[:, 0], s[:, 1]
    # a second candidate with the winner's own id is not a competitor
    return np.isfinite(second) & (np.abs(second - best) <= rel * np.abs(best))


@pytest.mark.parametrize("tile,tw,th,n_cells", [(16, 5, 4, 13), (32, 3, 3, 11)])
def test_plain_matches_pallas_interpret(tile, tw, th, n_cells):
    # jax is imported here, not at the top: the card's machine has no jax
    # and runs this file's GPU test alone (README.md)
    import jax.numpy as jnp

    from stillleben_tpu.ops.cell_raster import cell_raster_pallas

    G, ids, cell_tile, md, n_tiles = make_cells(tile, tile, tw, th, n_cells)
    wj, tj = cell_raster_pallas(
        jnp.asarray(G), jnp.asarray(ids), jnp.asarray(cell_tile), jnp.asarray(md),
        NEAR, FAR, tw, tile, n_tiles, interpret=True,
    )
    wj, tj = np.asarray(wj), np.asarray(tj)
    wt, tt = cell_raster_reference(
        torch.from_numpy(G), torch.from_numpy(ids), torch.from_numpy(cell_tile),
        torch.from_numpy(md), NEAR, FAR, tw, tile, n_tiles,
    )
    wt, tt = wt.numpy(), tt.numpy()
    tie = near_tie_mask(G, ids, cell_tile, md, tile, tw, n_tiles)
    assert np.isfinite(wj).sum() > 100, "test cells hit too few pixels"
    assert tie.sum() > 0, "no exact depth ties: the tie rule is not exercised"
    np.testing.assert_array_equal(np.isfinite(wt), np.isfinite(wj))
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tt[~tie], tj[~tie])
    # invalid and fully masked cells give the empty result
    empty = (cell_tile >= n_tiles) | (ids < 0).all(axis=1)
    assert np.isinf(wt[empty]).all() and (tt[empty] == -1).all()


SHADOW_NEAR, SHADOW_FAR = -1e-3, 1.0


def line_rows(v, depth):
    """(..., 3, 3) homogeneous vertices and (..., 3) depths -> (..., FIELDS)
    packed line rows [L0|L1|L2|Lsum|Lz] in float32, as the raster packs them."""
    L = np.stack(
        [np.cross(v[..., 1, :], v[..., 2, :]), np.cross(v[..., 2, :], v[..., 0, :]),
         np.cross(v[..., 0, :], v[..., 1, :])], axis=-2,
    ).astype(np.float32)
    rows = np.zeros(v.shape[:-2] + (FIELDS,), np.float32)
    rows[..., :9] = L.reshape(v.shape[:-2] + (9,))
    rows[..., 9:12] = L[..., 0, :] + L[..., 1, :] + L[..., 2, :]
    rows[..., 12:15] = (L[..., 0, :] * depth[..., 0:1] + L[..., 1, :] * depth[..., 1:2]
                        + L[..., 2, :] * depth[..., 2:3])
    return rows


def make_table_cells(seed, tile, tw, th, n_cells, C=128):
    """Random (LT, ids, cell_tile, md_tiles, n_tiles) for the cells ->
    tiles function, on the exact grid: integer pixel vertices with w = 1
    (the shadow pass's ortho triangles) and depths that are multiples of
    1/8, +-0.0 or -2^-11, so every line coefficient, edge value and depth
    is exact in float32. Cells share tiles; the geometry of some slots is
    copied into another cell of the same tile under another id (equal
    depths across cells), and within a cell (shared edges, equal depths);
    some slots are masked, some cells invalid, one valid cell fully masked;
    the depth-peel floor is above 0 at some pixels and below the near
    plane at most."""
    rng = np.random.default_rng(seed)
    n_tiles = tw * th
    cell_tile = np.sort(rng.integers(0, n_tiles, n_cells)).astype(np.int32)
    cell_tile[rng.random(n_cells) < 0.15] = n_tiles  # invalid cells
    ox = (np.minimum(cell_tile, n_tiles - 1) % tw) * tile
    oy = (np.minimum(cell_tile, n_tiles - 1) // tw) * tile
    centre = rng.integers(-2, tile + 2, (n_cells, C, 1, 2))
    uv = (centre + rng.integers(-SPREAD, SPREAD + 1, (n_cells, C, 3, 2))).astype(np.float64)
    uv[..., 0] += ox[:, None, None]
    uv[..., 1] += oy[:, None, None]
    uv[:, 1::2, 1:] = uv[:, 0:-1:2, 2:0:-1]  # odd slots share an edge
    depth = rng.integers(-1, 10, (n_cells, C, 3)) / 8.0
    kind = rng.random((n_cells, C))
    zero = kind < 0.25  # depth 0 of either sign at each vertex
    depth[zero] = np.where(rng.random((zero.sum(), 3)) < 0.5, 0.0, -0.0)
    depth[(kind >= 0.25) & (kind < 0.35)] = -(2.0**-11)  # behind 0, in front of near
    uv[:, 8:16] = uv[:, 0:8]  # equal depths within a cell
    depth[:, 8:16] = depth[:, 0:8]
    # equal depths across cells: the first slots of each cell again in the
    # next cell of the same tile
    for c in range(1, n_cells):
        if cell_tile[c] == cell_tile[c - 1] < n_tiles:
            uv[c, 16:32] = uv[c - 1, 0:16]
            depth[c, 16:32] = depth[c - 1, 0:16]
    v = np.concatenate([uv, np.ones(uv.shape[:-1] + (1,))], axis=-1).astype(np.float32)
    rows = line_rows(v, depth.astype(np.float32))
    ids = rng.permutation(n_cells * C).reshape(n_cells, C).astype(np.int32)
    LT = np.zeros((n_cells * C + 7, FIELDS), np.float32)  # a few rows no slot uses
    LT[ids.reshape(-1)] = rows.reshape(-1, FIELDS)
    ids[rng.random((n_cells, C)) < 0.2] = -1
    ids[np.flatnonzero(cell_tile < n_tiles)[1]] = -1  # a valid cell with every slot masked
    # the floor: above 0 at some pixels; -1 at most, so depths at and below
    # 0 pass it (a floor of 0 keeps only depths above 1e-5)
    r = rng.random((n_tiles + 1, tile * tile))
    md_tiles = np.where(r < 0.3, rng.uniform(0.0, 0.6, r.shape), np.where(r < 0.8, -1.0, 0.0))
    md_tiles = md_tiles.astype(np.float32)
    md_tiles[n_tiles] = 0.0
    return LT, ids, cell_tile, md_tiles, n_tiles


def jax_merge(w_c, t_c, cell_tile, n_tiles):
    """The JAX package's cells -> tiles merge, stillleben_tpu/render/
    rasterize_tiled.py:363-377, as it stands there."""
    import jax.numpy as jnp

    pix = w_c.shape[1]
    inf = jnp.float32(jnp.inf)
    wt = jnp.full((n_tiles + 1, pix), inf, jnp.float32).at[cell_tile].min(w_c, mode="drop")
    BIGID = jnp.int32(2**31 - 1)
    cand = jnp.where((w_c <= wt[cell_tile]) & (w_c < inf) & (t_c >= 0), t_c, BIGID)
    tt = jnp.full((n_tiles + 1, pix), BIGID, jnp.int32).at[cell_tile].min(cand, mode="drop")
    depth_t = wt[:n_tiles]
    return depth_t, jnp.where(depth_t < inf, tt[:n_tiles], -1)


@pytest.mark.parametrize("tile,tw,th,n_cells", [(16, 4, 3, 24), (32, 3, 2, 14)])
def test_cells_to_tiles_plain_matches_pallas_interpret_and_jax_merge(tile, tw, th, n_cells):
    import jax.numpy as jnp

    from stillleben_tpu.ops.cell_raster import cell_raster_pallas

    LT, ids, cell_tile, md_tiles, n_tiles = make_table_cells(21, tile, tw, th, n_cells)
    G = LT[np.maximum(ids, 0)]
    wj_c, tj_c = cell_raster_pallas(
        jnp.asarray(G), jnp.asarray(ids), jnp.asarray(cell_tile), jnp.asarray(md_tiles[cell_tile]),
        SHADOW_NEAR, SHADOW_FAR, tw, tile, n_tiles, interpret=True,
    )
    wj, tj = (np.asarray(a) for a in jax_merge(wj_c, tj_c, jnp.asarray(cell_tile), n_tiles))
    wp, tp = cell_raster_plain(
        *(torch.from_numpy(a) for a in (LT, ids, cell_tile, md_tiles)),
        SHADOW_NEAR, SHADOW_FAR, tw, tile, n_tiles,
    )
    wp, tp = wp.numpy(), tp.numpy()
    np.testing.assert_array_equal(wp, wj)  # -0.0 == +0.0, as torch.equal
    np.testing.assert_array_equal(tp, tj)
    # what the inputs are there for really happens
    wj_c, tj_c = np.asarray(wj_c), np.asarray(tj_c)
    assert np.isfinite(wj).sum() > 200, "test cells hit too few pixels"
    assert (wj < 0).sum() > 0 and (wj == 0).sum() > 0, "no depths at or below 0"
    zeros = wj_c[wj_c == 0]
    assert np.signbit(zeros).any() and (~np.signbit(zeros)).any(), "no -0.0 and +0.0 winners"
    valid = cell_tile < n_tiles
    cross = 0
    for ti in range(n_tiles):
        cells = np.flatnonzero(cell_tile == ti)
        if len(cells) > 1:
            w_t = wj_c[cells]
            at_min = (w_t == w_t.min(0)) & np.isfinite(w_t)
            cross += (at_min.sum(0) > 1).sum()
    assert cross > 0, "no equal depth across the cells of a tile"
    assert (ids[valid] < 0).any() and (~valid).any()
    # the lowest id wins the cross-cell ties
    for ti in range(n_tiles):
        cells = np.flatnonzero(cell_tile == ti)
        if len(cells) > 1:
            w_t, t_t = wj_c[cells], tj_c[cells]
            at_min = (w_t == wp[ti]) & np.isfinite(w_t)
            best = np.where(at_min, t_t, 2**31 - 1).min(0)
            np.testing.assert_array_equal(np.where(np.isfinite(wp[ti]), best, -1), tp[ti])


def test_depth_keys_min_equals_merge_cells():
    rng = np.random.default_rng(8)
    n_cells, pix, n_tiles = 300, 64, 40
    choices = np.array([-0.0, 0.0, -5e-4, -2.0**-11, 0.25, 0.5, 1.0, np.inf, 3.5e-3], np.float32)
    w_c = choices[rng.integers(0, len(choices), (n_cells, pix))]
    rand = rng.random((n_cells, pix)) < 0.3
    w_c[rand] = rng.uniform(-1e-3, 2.0, rand.sum())
    t_c = rng.integers(0, 2**31 - 1, (n_cells, pix)).astype(np.int32)
    small = rng.random((n_cells, pix)) < 0.5
    t_c[small] = rng.integers(0, 50, small.sum())  # few ids: equal (depth, id) pairs too
    t_c[~np.isfinite(w_c)] = -1
    # n_tiles: invalid; tiles 0-4 have no cell
    cell_tile = rng.integers(5, n_tiles + 1, n_cells).astype(np.int32)
    w_c, t_c, cell_tile = (torch.from_numpy(a) for a in (w_c, t_c, cell_tile))
    wm, tm = merge_cells(w_c, t_c, cell_tile, n_tiles)
    # the kernel's rule: the minimum key per tile pixel, all ones = empty
    keys = torch.where(torch.isfinite(w_c), depth_keys(w_c, t_c), torch.iinfo(torch.int64).max)
    kt = torch.full((n_tiles + 1, pix), torch.iinfo(torch.int64).max, dtype=torch.int64)
    kt.scatter_reduce_(0, cell_tile.long()[:, None].expand(-1, pix), keys, "amin")
    wk, tk = keys_to_depth(kt[:n_tiles])
    assert torch.equal(wk, wm) and torch.equal(tk, tm)
    assert (wm == 0).any() and (wm < 0).any() and torch.isinf(wm).any()
    # the key order is the (depth, id) order, -0.0 equal to +0.0
    a, b = torch.randint(0, n_cells * pix, (2, 20000), generator=torch.Generator().manual_seed(2))
    wa, wb = w_c.reshape(-1)[a], w_c.reshape(-1)[b]
    ta, tb = t_c.reshape(-1)[a], t_c.reshape(-1)[b]
    fin = torch.isfinite(wa) & torch.isfinite(wb)
    less = (wa < wb) | ((wa == wb) & (ta < tb))
    assert torch.equal((depth_keys(wa, ta) < depth_keys(wb, tb))[fin], less[fin])
    wr, tr = keys_to_depth(depth_keys(wa[fin], ta[fin]))
    assert torch.equal(wr, wa[fin]) and torch.equal(tr, ta[fin])
    assert not torch.signbit(wr[wr == 0]).any()  # -0.0 comes back as +0.0


def test_wrapper_uses_plain_version_on_cpu():
    LT, ids, cell_tile, md_tiles, n_tiles = make_table_cells(3, 16, 5, 4, 9)
    args = [torch.from_numpy(a) for a in (LT, ids, cell_tile, md_tiles)]
    before = cell_raster.launches
    w1, t1 = cell_raster(*args, SHADOW_NEAR, SHADOW_FAR, 5, 16, n_tiles)
    w2, t2 = cell_raster_plain(*args, SHADOW_NEAR, SHADOW_FAR, 5, 16, n_tiles)
    assert torch.equal(w1, w2) and torch.equal(t1, t2)
    assert w1.shape == (n_tiles, 256) and torch.isfinite(w1).any()
    # no floor is a floor of 0
    w3, t3 = cell_raster(*args[:3], None, SHADOW_NEAR, SHADOW_FAR, 5, 16, n_tiles)
    w4, t4 = cell_raster_plain(*args[:3], torch.zeros_like(args[3]), SHADOW_NEAR, SHADOW_FAR, 5,
                               16, n_tiles)
    assert torch.equal(w3, w4) and torch.equal(t3, t4)
    assert cell_raster.launches == before  # no kernel launch on the CPU
    with pytest.raises(TypeError):
        cell_raster(args[0].double(), *args[1:], NEAR, FAR, 5, 16, n_tiles)
    with pytest.raises(ValueError):
        cell_raster(*args[:3], args[3][:-1], NEAR, FAR, 5, 16, n_tiles)  # md_tiles has n_tiles + 1 rows
    with pytest.raises(ValueError):
        cell_raster(*args[:3], None, NEAR, FAR, 5, 48, n_tiles)  # no kernel for tile 48


@pytest.mark.gpu
@pytest.mark.parametrize("tile,tw,th,n_cells", [(16, 40, 30, 600), (32, 64, 64, 400)])
def test_kernel_bitwise_equals_plain_on_cuda(tile, tw, th, n_cells):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell-raster kernel runs only on the card")
    # perspective triangles (make_cells) and the exact grid with depths at
    # and below 0 (make_table_cells)
    G, ids_c, cell_tile_c, md_c, n_tiles = make_cells(7, tile, tw, th, n_cells)
    rng = np.random.default_rng(9)
    md_tiles = np.where(rng.random((n_tiles + 1, tile * tile)) < 0.3,
                        rng.uniform(0.0, 2.0, (n_tiles + 1, tile * tile)), 0.0).astype(np.float32)
    rows = np.arange(ids_c.size, dtype=np.int32).reshape(ids_c.shape)
    perspective = (G.reshape(-1, FIELDS), np.where(ids_c >= 0, rows, -1).astype(np.int32),
                   cell_tile_c, md_tiles, NEAR, FAR)
    LT, ids, cell_tile, md_tiles, _ = make_table_cells(7, tile, tw, th, n_cells)
    grid = (LT, ids, cell_tile, md_tiles, SHADOW_NEAR, SHADOW_FAR)
    for LT, ids, cell_tile, md_tiles, near, far in (perspective, grid):
        args = [torch.from_numpy(a).cuda() for a in (LT, ids, cell_tile, md_tiles)]
        for md in (args[3], None):
            wp, tp = cell_raster_plain(*args[:3], md, near, far, tw, tile, n_tiles)
            assert torch.isfinite(wp).sum() > 1000
            before = cell_raster.launches
            wk, tk = cell_raster(*args[:3], md, near, far, tw, tile, n_tiles)
            torch.cuda.synchronize()
            assert cell_raster.launches == before + 1
            assert torch.equal(wk, wp), md is None
            assert torch.equal(tk, tp), md is None
