"""The classic raster's fine stage (K2/K3) of the PyTorch port against the
JAX package's Pallas kernel (run in interpret mode on the CPU), and the
CUDA kernel against the port's plain PyTorch version on a card.

Inputs are made from a numpy seed: a line table ``LT`` and per-tile slot
ids into it for the port (``fine_raster_plain``), the same rows gathered
into the JAX kernel's triangle-minor ``G`` for the JAX package. On the exact grid (integer pixel vertices, w in {1, 1.5,
2}) every line coefficient, edge value and depth is exact in float32 in
either evaluation order, so equal depths are real ties and both outputs
must be equal exactly. The inputs hold equal-depth ties inside a chunk
(the lowest id wins) and across two chunks (the earlier chunk wins, even
with the larger id), a fully masked tile, a fully masked chunk, a depth-
peel floor and a non-zero tile offset. On random float inputs ``w`` is
held within 1e-6 relative and ``t`` equal off near-ties, at pixels whose
float32 depth is well conditioned (XLA on the CPU contracts ``a*x + b*y +
c`` into fused multiply-adds, PyTorch does not; at the few ill-conditioned
pixels the port is held within 1e-4 of float64).
The JAX package's grouped kernel (``tiles_per_cell`` 4 or 8) is held to
the port's plain version with the same argument, bit for bit on the exact
grid. On the card the kernel must match the plain version bit for bit, and
K3 (4 or 8 tiles per block) must match the plain version and K2.
"""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.ops.cell_raster import cell_raster_reference, depth_keys, keys_to_depth
from stillleben_tpu_torch.ops.fine_raster import (
    FIELDS,
    MAX_CHUNK,
    fine_raster,
    fine_raster_plain,
)
from stillleben_tpu_torch.render.frame import FrameConfig
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

NEAR, FAR = 0.1, 10.0
TIED = 16  # slots of chunk 0 copied (geometry) into chunk 1 and into 16..31
ID_STRIDE = 2000  # tile i's ids are i * stride + [100, base + K), stride >= ID_STRIDE


def make_tiles(seed, tile, tw, n_tiles, n_chunks, tile_offset, C=128, grid=True):
    """Random (G, LT, ids, md): triangles around each tile (global id
    ``tile_offset + i``), shared edges, exact ties within and across
    chunks, masked slots, a fully masked tile (1) and chunk (tile 3, chunk
    0), and a depth-peel floor at some pixels. ``ids`` index the rows of
    ``LT``; ``G`` holds each slot's row in the JAX kernel's layout."""
    rng = np.random.default_rng(seed)
    gi = tile_offset + np.arange(n_tiles)
    shape = (n_tiles, n_chunks, C)
    spread = max(6, tile // 4)
    centre = rng.integers(-2, tile + 2, shape + (1, 2))
    uv = (centre + rng.integers(-spread, spread + 1, shape + (3, 2))).astype(np.float64)
    uv[..., 0] += ((gi % tw) * tile)[:, None, None, None]
    uv[..., 1] += ((gi // tw) * tile)[:, None, None, None]
    uv[..., 1::2, 1:, :] = uv[..., 0:-1:2, 2:0:-1, :]  # odd slots share an edge
    w = rng.integers(2, 5, shape + (3,)) / 2.0
    w[..., 1::2, 1:] = w[..., 0:-1:2, 2:0:-1]
    if not grid:
        uv += rng.uniform(-0.5, 0.5, uv.shape)
        w = rng.uniform(1.0, 2.0, w.shape)
    # equal depths: copies of chunk 0's first slots later in chunk 0 and in chunk 1
    uv[:, 0, TIED : 2 * TIED] = uv[:, 0, :TIED]
    w[:, 0, TIED : 2 * TIED] = w[:, 0, :TIED]
    uv[:, 1, :TIED] = uv[:, 0, :TIED]
    w[:, 1, :TIED] = w[:, 0, :TIED]
    v = np.concatenate([uv * w[..., None], w[..., None]], axis=-1).astype(np.float32)
    depth = w.astype(np.float32)
    L = np.stack(
        [np.cross(v[..., 1, :], v[..., 2, :]), np.cross(v[..., 2, :], v[..., 0, :]),
         np.cross(v[..., 0, :], v[..., 1, :])], axis=-2,
    ).astype(np.float32)  # (..., 3 edges, 3)
    Lsum = L[..., 0, :] + L[..., 1, :] + L[..., 2, :]
    Lz = L[..., 0, :] * depth[..., 0:1] + L[..., 1, :] * depth[..., 1:2] + L[..., 2, :] * depth[..., 2:3]
    rows = np.zeros(shape + (FIELDS,), np.float32)
    rows[..., :9] = L.reshape(shape + (9,))
    rows[..., 9:12] = Lsum
    rows[..., 12:15] = Lz
    G = np.ascontiguousarray(rows.transpose(0, 1, 3, 2))  # triangle-minor
    # ids distinct within a tile: [base, base + K), the tied copies below
    # (K <= 384: base 1000, copies at -500 and -900)
    K = n_chunks * C
    d1 = max(500, K + 100)
    d2 = max(900, 2 * d1 - 100)
    base = d2 + 100
    ids = np.stack([rng.permutation(K) for _ in range(n_tiles)]) + base
    ids = ids.reshape(shape).astype(np.int32)
    ids[:, 0, TIED : 2 * TIED] = ids[:, 0, :TIED] - d1  # within a chunk: lower id wins
    ids[:, 1, :TIED] = ids[:, 0, :TIED] - d2  # across chunks: lower id loses
    masked = rng.random(shape) < 0.2
    masked[:, :, : 2 * TIED] = False  # keep the ties
    ids[masked] = -1
    ids[1] = -1  # a fully masked tile
    ids[3, 0] = -1  # a fully masked chunk
    # distinct ids across tiles as well, each the row of its slot in LT
    stride = max(ID_STRIDE, base + K)
    ids = np.where(ids >= 0, ids + (np.arange(n_tiles) * stride)[:, None, None], -1)
    ids = ids.astype(np.int32)
    LT = np.zeros((n_tiles * stride, FIELDS), np.float32)
    LT[ids[ids >= 0]] = rows[ids >= 0]
    md = np.where(rng.random((n_tiles, tile * tile)) < 0.3,
                  rng.uniform(0.0, 1.2, (n_tiles, tile * tile)), 0.0).astype(np.float32)
    return G, LT, ids, md


def grouped_tiles(seed, tile, tw, n_tiles, n_chunks, tile_offset, tpg, C=128, grid=True):
    """``make_tiles`` cut to ``n_tiles`` (fewer than 4 allowed), with the
    second group of ``tpg`` tiles fully masked where there is one."""
    G, LT, ids, md = make_tiles(seed, tile, tw, max(n_tiles, 4), n_chunks, tile_offset, C, grid)
    G, ids, md = (np.ascontiguousarray(a[:n_tiles]) for a in (G, ids, md))
    ids[tpg : 2 * tpg] = -1
    return G, LT, ids, md


def run_jax(G, ids, md, tw, tile_offset, tile, chunk, tiles_per_cell=1):
    # jax is imported here, not at the top: the card's machine has no jax
    # and runs this file's GPU test alone (README.md)
    import jax.numpy as jnp

    from stillleben_tpu.ops.fine_raster import fine_raster_pallas

    w, t = fine_raster_pallas(
        jnp.asarray(G), jnp.asarray(ids), jnp.asarray(md), NEAR, FAR, chunk, tw,
        interpret=True, tile_offset=jnp.array([tile_offset], jnp.int32), tile=tile,
        tiles_per_cell=tiles_per_cell,
    )
    return np.asarray(w), np.asarray(t)


def run_port(LT, ids, md, tw, tile_offset, tile, chunk, tiles_per_cell=1):
    w, t = fine_raster_plain(
        torch.from_numpy(LT), torch.from_numpy(ids), torch.from_numpy(md), NEAR, FAR, chunk, tw,
        tile_offset=tile_offset, tile=tile, tiles_per_cell=tiles_per_cell,
    )
    return w.numpy(), t.numpy()


def single_compare(G, ids, md, tw, tile_offset, tile):
    """One running (depth, lowest id) compare over all of a tile's slots:
    the rule that is NOT the kernel's at cross-chunk ties."""
    n_tiles, n_chunks, _, C = G.shape
    Gc = torch.from_numpy(np.ascontiguousarray(G.transpose(0, 1, 3, 2))).reshape(n_tiles, -1, FIELDS)
    cell_tile = torch.arange(tile_offset, tile_offset + n_tiles, dtype=torch.int32)
    w, t = cell_raster_reference(
        Gc, torch.from_numpy(ids).reshape(n_tiles, -1), cell_tile, torch.from_numpy(md),
        NEAR, FAR, tw, tile, tile_offset + n_tiles,
    )
    return w.numpy(), t.numpy()


@pytest.mark.parametrize(
    "tile,tw,n_tiles,n_chunks,tile_offset",
    [(16, 7, 11, 3, 5), (64, 4, 6, 2, 9)],
)
def test_plain_matches_pallas_interpret_exact_grid(tile, tw, n_tiles, n_chunks, tile_offset):
    C = 128
    G, LT, ids, md = make_tiles(11, tile, tw, n_tiles, n_chunks, tile_offset, C)
    wj, tj = run_jax(G, ids, md, tw, tile_offset, tile, C)
    wp, tp = run_port(LT, ids, md, tw, tile_offset, tile, C)
    assert np.isfinite(wj).sum() > 200, "test tiles hit too few pixels"
    np.testing.assert_array_equal(wp, wj)
    np.testing.assert_array_equal(tp, tj)
    # the masked tile gives the empty result; the masked chunk changes nothing
    assert np.isinf(wp[1]).all() and (tp[1] == -1).all()
    ids_skip = ids.copy()
    ids_skip[3, 0] = -1
    np.testing.assert_array_equal(run_port(LT, ids_skip, md, tw, tile_offset, tile, C)[1][3], tp[3])
    # the cross-chunk tie rule is exercised: one running compare differs
    ws, ts = single_compare(G, ids, md, tw, tile_offset, tile)
    np.testing.assert_array_equal(ws, wp)
    differ = ts != tp
    assert differ.sum() > 0, "no cross-chunk equal-depth tie was exercised"
    chunk_of = {}
    for i in range(n_tiles):
        for j in range(n_chunks):
            for s in range(C):
                chunk_of[(i, int(ids[i, j, s]))] = min(chunk_of.get((i, int(ids[i, j, s])), j), j)
    for i, p in zip(*np.nonzero(differ)):
        assert ts[i, p] < tp[i, p] and chunk_of[(i, int(tp[i, p]))] < chunk_of[(i, int(ts[i, p]))]


@pytest.mark.parametrize(
    "tile,tw,n_tiles,n_chunks,tile_offset,tpg",
    [
        (16, 7, 19, 3, 5, 4),  # ragged last group of 3, group 1 masked
        (16, 7, 19, 3, 5, 8),
        (16, 5, 3, 2, 2, 4),  # fewer tiles than a group
        (64, 4, 10, 2, 9, 4),  # ragged last group of 2, group 1 masked
        (64, 4, 3, 2, 9, 8),  # fewer tiles than a group
    ],
)
def test_grouped_plain_matches_pallas_interpret_exact_grid(tile, tw, n_tiles, n_chunks,
                                                           tile_offset, tpg):
    """K3's function: the JAX package's grouped kernel (tiles_per_cell =
    tpg) against the port's plain version with the same tiles_per_cell, bit
    for bit on the exact grid; a masked tile, chunk and group, a ragged
    last group and a tile offset."""
    C = 128
    G, LT, ids, md = grouped_tiles(17, tile, tw, n_tiles, n_chunks, tile_offset, tpg, C)
    wj, tj = run_jax(G, ids, md, tw, tile_offset, tile, C, tiles_per_cell=tpg)
    wp, tp = run_port(LT, ids, md, tw, tile_offset, tile, C, tiles_per_cell=tpg)
    assert wj.shape == (n_tiles, tile * tile)
    assert np.isfinite(wj).sum() > 200, "test tiles hit too few pixels"
    np.testing.assert_array_equal(wp, wj)
    np.testing.assert_array_equal(tp, tj)
    # the masked tile and group give the empty result; the last group is
    # ragged and occupied
    empty = [1] + list(range(tpg, min(2 * tpg, n_tiles)))
    assert np.isinf(wp[empty]).all() and (tp[empty] == -1).all()
    last = (n_tiles - 1) // tpg * tpg
    assert n_tiles % tpg and np.isfinite(wp[last:]).any()
    if n_tiles > 3:  # the masked chunk of tile 3 changes nothing
        assert (ids[3, 0] == -1).all() and np.isfinite(wp[3]).any()


@pytest.mark.parametrize("tile,tw,n_tiles,n_chunks,tile_offset", [(16, 6, 9, 2, 0)])
def test_plain_matches_pallas_interpret_random_floats(tile, tw, n_tiles, n_chunks, tile_offset):
    C = 128
    G, LT, ids, md = make_tiles(5, tile, tw, n_tiles, n_chunks, tile_offset, C, grid=False)
    wj, tj = run_jax(G, ids, md, tw, tile_offset, tile, C)
    wp, tp = run_port(LT, ids, md, tw, tile_offset, tile, C)
    np.testing.assert_array_equal(np.isfinite(wp), np.isfinite(wj))
    # the float64 best and second-best depth over all of a tile's slots
    n, nc, _, _ = G.shape
    g = G.astype(np.float64).transpose(0, 1, 3, 2).reshape(n, nc * C, FIELDS)
    gi = tile_offset + np.arange(n)
    p = np.arange(tile * tile)
    X = (gi % tw * tile)[:, None] + p % tile + 0.5
    Y = (gi // tw * tile)[:, None] + p // tile + 0.5
    E = [g[:, :, 3 * e, None] * X[:, None] + g[:, :, 3 * e + 1, None] * Y[:, None]
         + g[:, :, 3 * e + 2, None] for e in range(5)]
    inside = ((E[0] >= 0) & (E[1] >= 0) & (E[2] >= 0)) | ((E[0] <= 0) & (E[1] <= 0) & (E[2] <= 0))
    wp64 = E[4] / np.where(np.abs(E[3]) < 1e-20, 1.0, E[3])
    ok = inside & (wp64 > NEAR) & (wp64 <= FAR) & (wp64 > md[:, None] + 1e-5)
    ok &= ids.reshape(n, -1)[:, :, None] >= 0
    s = np.sort(np.where(ok, wp64, np.inf), axis=1)
    hit = np.isfinite(wj)
    # w: 1e-6 relative where both packages' float32 depth lies within 5e-7
    # of float64 (elsewhere the homogeneous depth of a small triangle is
    # ill-conditioned in float32: there 1e-4 of float64, at <= 2% of hits)
    rel = lambda a: np.abs(a - s[:, 0]) / np.abs(s[:, 0])  # noqa: E731
    with np.errstate(invalid="ignore"):
        well = hit & (rel(wp) <= 5e-7) & (rel(wj) <= 5e-7)
        tie = np.isfinite(s[:, 1]) & (np.abs(s[:, 1] - s[:, 0]) <= 1e-6 * np.abs(s[:, 0]))
    np.testing.assert_allclose(wp[well], wj[well], rtol=1e-6, atol=0)
    ill = hit & ~well
    assert ill.sum() <= 0.02 * hit.sum(), f"{ill.sum()} ill-conditioned pixels"
    np.testing.assert_allclose(wp[ill], s[:, 0][ill], rtol=1e-4, atol=0)
    # t: equal off near-ties and ill-conditioned pixels
    keep = ~tie & ~ill
    assert (keep & hit).sum() > 200
    np.testing.assert_array_equal(tp[keep], tj[keep])


def test_many_chunks_match_pallas_interpret():
    """More chunks than one 32-bit occupancy word holds (the kernel keeps a
    mask word per 32 chunks), through the wrapper, against the JAX kernel.
    A chunk larger than the kernel stages is refused on every device."""
    tile, tw, n_tiles, n_chunks, tile_offset, C = 16, 5, 4, 40, 3, 32
    G, LT, ids, md = make_tiles(13, tile, tw, n_tiles, n_chunks, tile_offset, C)
    ids[0, 1:33] = -1  # tile 0: occupied chunks 0 and 33.. only
    G[0, 1:33] = 0.0
    wj, tj = run_jax(G, ids, md, tw, tile_offset, tile, C)
    args = [torch.from_numpy(a) for a in (LT, ids, md)]
    wp, tp = fine_raster(*args, NEAR, FAR, C, tw, tile_offset=tile_offset, tile=tile)
    assert np.isfinite(wj).sum() > 200
    np.testing.assert_array_equal(wp.numpy(), wj)
    np.testing.assert_array_equal(tp.numpy(), tj)
    with pytest.raises(ValueError):
        fine_raster(args[0], torch.full((1, 1, 2 * MAX_CHUNK), -1, dtype=torch.int32),
                    args[2][:1], NEAR, FAR, 2 * MAX_CHUNK, tw)
    with pytest.raises(ValueError):
        FrameConfig(width=64, height=48, raster="classic", fine_chunk=2 * MAX_CHUNK).check()


def test_chunk_keys_min_equals_strict_chunk_rule():
    """The split-chunk merge key (orderable(w), chunk, id) against the
    kernel's rule: the lowest id at equal depth within a chunk, a later
    chunk only when strictly nearer."""
    rng = np.random.default_rng(4)
    n_px, n_chunks, C = 4000, 3, 24
    choices = np.array([-0.0, 0.0, -5e-4, 0.25, 0.5, np.inf, np.inf], np.float32)
    w = choices[rng.integers(0, len(choices), (n_px, n_chunks, C))]
    rand = rng.random(w.shape) < 0.2
    w[rand] = rng.uniform(-1e-3, 1.0, rand.sum())
    ids = rng.integers(0, 2**24, w.shape).astype(np.int32)
    small = rng.random(w.shape) < 0.5
    ids[small] = rng.integers(0, 8, small.sum())  # equal ids in other chunks too
    w, ids = torch.from_numpy(w), torch.from_numpy(ids)
    # the rule, as fine_raster_reference applies it
    bw = torch.full((n_px,), float("inf"))
    bt = torch.full((n_px,), -1, dtype=torch.int32)
    for j in range(n_chunks):
        cw = w[:, j].amin(1)
        hit = (w[:, j] == cw[:, None]) & torch.isfinite(w[:, j])
        ct = torch.where(hit, ids[:, j], 2**30).amin(1)
        better = cw < bw
        bt = torch.where(better, ct, bt)
        bw = torch.where(better, cw, bw)
    # the key rule
    chunk = torch.arange(n_chunks, dtype=torch.int32)[None, :, None].expand_as(ids)
    keys = torch.where(torch.isfinite(w), depth_keys(w, chunk * 2**24 + ids),
                       torch.iinfo(torch.int64).max)
    wk, low = keys_to_depth(keys.reshape(n_px, -1).amin(1))
    tk = torch.where(low >= 0, low % 2**24, -1)
    assert torch.equal(wk, bw) and torch.equal(tk, bt)
    # the cases are there: ties across chunks that the earlier chunk keeps
    # with the larger id, and ties of -0.0 with +0.0
    plain = torch.where(torch.isfinite(w), depth_keys(w, ids), torch.iinfo(torch.int64).max)
    _, t_one = keys_to_depth(plain.reshape(n_px, -1).amin(1))
    assert (t_one != bt).sum() > 50
    assert ((w == 0) & torch.signbit(w)).any(1).logical_and(((w == 0) & ~torch.signbit(w)).any(1)).any()


def test_wrapper_uses_plain_version_on_cpu():
    G, LT, ids, md = make_tiles(3, 16, 5, 7, 2, 2)
    args = [torch.from_numpy(a) for a in (LT, ids, md)]
    before = fine_raster.launches
    w1, t1 = fine_raster(*args, NEAR, FAR, 128, 5, tile_offset=2)
    w2, t2 = fine_raster_plain(*args, NEAR, FAR, 128, 5, tile_offset=2)
    assert torch.equal(w1, w2) and torch.equal(t1, t2)
    assert torch.isfinite(w1).any()
    assert fine_raster.launches == before  # no kernel launch on the CPU
    with pytest.raises(TypeError):
        fine_raster(args[0].double(), *args[1:], NEAR, FAR, 128, 5)
    with pytest.raises(ValueError):
        fine_raster(*args, NEAR, FAR, 128, 5, tiles_per_cell=3)
    with pytest.raises(ValueError):
        fine_raster(*args, NEAR, FAR, 64, 5)  # chunk is not C


@pytest.mark.gpu
@pytest.mark.parametrize(
    "tile,tw,n_tiles,n_chunks,tile_offset,C",
    [
        (16, 40, 1201, 3, 0, 128),
        (64, 32, 301, 2, 700, 128),
        (32, 8, 37, 40, 3, 32),  # two occupancy words a tile
        (64, 6, 13, 5, 0, 1024),  # fewer chunks staged at once than four
    ],
)
def test_kernel_bitwise_equals_plain_on_cuda(tile, tw, n_tiles, n_chunks, tile_offset, C):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fine-raster kernel runs only on the card")
    _, LT, ids, md = make_tiles(7, tile, tw, n_tiles, n_chunks, tile_offset, C, grid=False)
    args = [torch.from_numpy(a).cuda() for a in (LT, ids, md)]
    kw = dict(tile_offset=tile_offset, tile=tile)
    before = fine_raster.launches
    wk, tk = fine_raster(*args, NEAR, FAR, C, tw, **kw)
    wp, tp = fine_raster_plain(*args, NEAR, FAR, C, tw, **kw)
    torch.cuda.synchronize()
    assert fine_raster.launches == before + 1
    assert torch.equal(wk, wp)
    assert torch.equal(tk, tp)
    for tpg in (4, 8):  # K3: the same outputs with tpg tiles per block
        launched = fine_raster.launches_by_shape.get((tile, tpg), 0)
        wg, tg = fine_raster(*args, NEAR, FAR, C, tw, tiles_per_cell=tpg, **kw)
        torch.cuda.synchronize()
        assert fine_raster.launches_by_shape[(tile, tpg)] == launched + 1
        assert torch.equal(wg, wk) and torch.equal(tg, tk), tpg
        assert torch.equal(wg, wp) and torch.equal(tg, tp), tpg


def heavy_among_empty(seed, tile, tw, tile_offset):
    """21 tiles (ragged for 4 and 8 a group) of 3 chunks of 128: tile 2
    heavy (every live slot, ~300) beside a light tile 3 and empty mates,
    tiles 4-15 empty (a whole group at either size), tile 17 heavy and
    tile 20 light in the ragged last group."""
    _, LT, ids, md = make_tiles(seed, tile, tw, 21, 3, tile_offset, 128, grid=False)
    keep = np.zeros(21, bool)
    keep[[2, 3, 17, 20]] = True
    ids[~keep] = -1
    ids[3, :, 10:] = -1
    ids[20, 1:] = -1
    return LT, ids, md


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("case", ["heavy", "few", "slab"])
def test_grouped_kernel_bitwise_equals_plain_on_cuda(tile, case):
    """K3 at 4 and 8 tiles per block, and K2, against the plain version:
    one heavy tile among empty group mates, a whole empty group and a
    ragged last group (``heavy``); fewer tiles than a group (``few``);
    calls of a slab at tile offsets 4096 and 8192 (``slab``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fine-raster kernel runs only on the card")
    calls = {
        "heavy": [(9, 0) + heavy_among_empty(21, tile, 9, 0)],
        "few": [(5, 2) + make_tiles(22, tile, 5, 4, 2, 2, 128, grid=False)[1:]],
        "slab": [(80, off) + make_tiles(23, tile, 80, 30, 3, off, 128, grid=False)[1:]
                 for off in (4096, 8192)],
    }[case]
    for tw, tile_offset, LT, ids, md in calls:
        if case == "few":
            ids, md = ids[:3].copy(), md[:3].copy()
        args = [torch.from_numpy(a).cuda() for a in (LT, ids, md)]
        kw = dict(tile_offset=tile_offset, tile=tile)
        wp, tp = fine_raster_plain(*args, NEAR, FAR, 128, tw, **kw)
        assert torch.isfinite(wp).any()
        outs = {}
        for tpg in (1, 4, 8):
            launched = fine_raster.launches_by_shape.get((tile, tpg), 0)
            outs[tpg] = fine_raster(*args, NEAR, FAR, 128, tw, tiles_per_cell=tpg, **kw)
            torch.cuda.synchronize()
            assert fine_raster.launches_by_shape[(tile, tpg)] == launched + 1
            assert torch.equal(outs[tpg][0], wp) and torch.equal(outs[tpg][1], tp), tpg
            assert torch.equal(outs[tpg][0], outs[1][0]) and torch.equal(outs[tpg][1], outs[1][1])
