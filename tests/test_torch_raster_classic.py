"""The port's classic span-class raster against the JAX package's
(``SL_RASTER=classic`` with the Pallas kernel in interpret mode), on the
small procedural scene and on random shadow-map triangles.

Both packages get the very same projected vertices (numpy from the JAX
geometry stage). The fine kernel's slot lists (each tile's list, then the
global big list) must be identical, also where a small ``tile_capacity``
drops triangles: same classes, compaction, stable sort and search. The
images must agree on >= 99.9% of pixels, every disagreeing pixel a depth
tie within 1e-5 or a pixel centre on an edge of either winner (XLA on the
CPU fuses multiply-adds that PyTorch rounds separately); where the ids
agree, depth within 1e-5 by ``torch_port_scene.check_depth``'s rule. The
slabbed fine stage equals one pass bit for bit. The classic shadow depth
pass (splats plus binned rest) is held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu.render.rasterize_tiled import rasterize_vertices as jax_rasterize_vertices
from stillleben_tpu.render.shadow import _ortho_rasterize_depth as jax_ortho_depth
from stillleben_tpu_torch.render import rasterize_tiled as rt
from stillleben_tpu_torch.render.shadow import _ortho_rasterize_depth
from torch_port_scene import (
    H, W, build_meshes, check_depth, check_id_agreement, depth_f64, jax_template,
)

NEAR, FAR = 0.1, 10.0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    tpl = jax_template(meshes)
    poses, cam, _ = jax_settle_scene(
        jax.random.PRNGKey(5), tpl, jax_default_config(), settle_iterations=10
    )
    nb = tpl.base_inputs.obj_to_world.shape[0]
    inputs = tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:nb].set(poses[:nb]), cam_pose=cam
    )
    geom = jax_geometry_stage(tpl.render_atlas, inputs, W, H)
    return np.asarray(geom.pix_hom)[np.asarray(tpl.render_atlas.faces)]


@pytest.fixture
def classic(monkeypatch):
    monkeypatch.setenv("SL_RASTER", "classic")
    monkeypatch.setenv("SL_FINE_TPG", "1")


def run_jax(monkeypatch, v, tile_capacity, pixel_stage, record=None):
    """JAX's classic raster through the Pallas kernel (interpret mode);
    ``record`` collects the kernel's (G, ids) inputs."""
    import stillleben_tpu.ops.fine_raster as jfr

    original = jfr.fine_raster_pallas

    def recorder(G, ids, *args, **kwargs):
        record.append((np.asarray(G), np.asarray(ids)))
        return original(G, ids, *args, **kwargs)

    if record is not None:
        monkeypatch.setattr(jfr, "fine_raster_pallas", recorder)
    act = np.ones(v.shape[0], bool)
    d, t = jax_rasterize_vertices(
        jnp.asarray(v), jnp.asarray(v[..., 2]), jnp.asarray(act), W, H, NEAR, FAR,
        tile_capacity, 64, 128, None, pixel_stage=pixel_stage, use_pallas=True,
    )
    return np.asarray(d), np.asarray(t)


def run_port(v, tile_capacity, pixel_stage):
    vt = torch.from_numpy(v)
    act = torch.ones(v.shape[0], dtype=torch.bool)
    d, t = rt.rasterize_vertices(vt, vt[..., 2], act, W, H, NEAR, FAR, tile_capacity, 64, 128,
                                 pixel_stage)
    return d.numpy(), t.numpy()


@pytest.mark.parametrize("tile_capacity", [256, 24])
def test_tile_lists_identical_to_jax(scene, classic, monkeypatch, tile_capacity):
    v = scene
    record = []
    run_jax(monkeypatch, v, tile_capacity, False, record)
    assert len(record) == 1
    G_j, ids_j = record[0]
    vt = torch.from_numpy(v)
    lists = rt.build_tile_lists(
        vt, vt[..., 2], torch.ones(v.shape[0], dtype=torch.bool), W, H, NEAR, FAR,
        tile_capacity, 64, 128, False,
    )
    ids = lists["ids"].numpy()
    np.testing.assert_array_equal(ids, ids_j)
    assert (ids >= 0).sum() > 50
    if tile_capacity == 24:  # the capacity binds: the farthest drop in both
        full = rt.build_tile_lists(
            vt, vt[..., 2], torch.ones(v.shape[0], dtype=torch.bool), W, H, NEAR, FAR,
            256, 64, 128, False,
        )["ids"]
        assert (full >= 0).sum() > (lists["ids"] >= 0).sum()
    # the gathered line rows, to float32 rounding (XLA fuses the cross products)
    g = lists["LT"][torch.clamp(lists["ids"], min=0).reshape(-1).long()]
    g = g.reshape(ids.shape + (-1,)).transpose(2, 3).numpy()
    scale = np.abs(G_j).max()
    np.testing.assert_allclose(g, G_j, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("tile_capacity,pixel_stage", [(256, False), (256, True), (24, False)])
def test_classic_raster_matches_jax(scene, classic, monkeypatch, tile_capacity, pixel_stage):
    v = scene
    dj, tj = run_jax(monkeypatch, v, tile_capacity, pixel_stage)
    dp, tp = run_port(v, tile_capacity, pixel_stage)
    assert (tj >= 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tp, tj, v, v[..., 2])
    # well-conditioned: both within 5e-6 of float64, so within 1e-5 of each
    # other; the rest (at most 2% of the hits) within 1e-4 of float64
    check_depth(dp, dj, depth_f64(v, v[..., 2], tj), agree & (tj >= 0), well_tol=5e-6,
                max_ill_frac=0.02)


def test_slabbed_fine_stage_equals_one_pass(scene, monkeypatch):
    v = scene
    one = run_port(v, 256, True)
    monkeypatch.setattr(rt, "MAX_TILES_PER_PASS", 2)
    slabbed = run_port(v, 256, True)
    np.testing.assert_array_equal(slabbed[0], one[0])
    np.testing.assert_array_equal(slabbed[1], one[1])


def shadow_triangles(seed, size, n):
    """``n`` triangles over a size^2 map in three size classes (sub-2 px,
    2-4 px and larger, up to a sixth of the map), each on a plane through a
    depth in [0.1, 0.9] at its centre with a slope of at most 0.4 per map
    width, as the faces of a caster seen by the light are."""
    rng = np.random.default_rng(seed)
    spans = np.concatenate([
        rng.uniform(0.3, 1.5, n // 3), rng.uniform(2.2, 3.8, n // 3),
        rng.uniform(5.0, size / 6, n - 2 * (n // 3)),
    ])
    centre = rng.uniform(0, size, (n, 1, 2))
    offset = rng.uniform(-0.5, 0.5, (n, 3, 2)) * spans[:, None, None]
    xy = (centre + offset).reshape(-1, 2)
    slope = rng.uniform(-0.4, 0.4, (n, 1, 2)) / size
    z = (rng.uniform(0.1, 0.9, (n, 1)) + (offset * slope).sum(-1)).reshape(-1)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    on = rng.random(n) < 0.95
    return xy.astype(np.float32), z.astype(np.float32), faces, on


def shadow_depth_bounds(xy, z, faces, on, ys, xs, slack=4.0):
    """Where float32 leaves the nearest depth at the pixel centres (ys + .5,
    xs + .5): (lo, hi) in [0, 1], 1 = none, from float64 and a first-order
    forward error bound. An edge function E_k = lx*X + ly*Y + lc, whose
    coefficients are cross products of the float32 vertices, is known in
    float32 only to err_k = ``slack`` * eps * S_k, S_k the sum of the
    magnitudes of its terms. A triangle may cover a centre where every E_k
    reaches -err_k on the side of Esum (``lo``'s set; either side for a
    sliver whose Esum is within its error, which may give any depth) and
    surely covers it where every E_k passes err_k (``hi``'s); its depth
    Ez / Esum is known to sum_k err_k (|z_k| + |d|) / |Esum|. Any float32
    evaluation of the min-depth raster lies in [lo, hi]: a narrow interval
    except at centres on an edge, on slivers and on large triangles far
    from the map's origin."""
    eps = float(np.finfo(np.float32).eps)
    p = np.concatenate([xy, np.ones_like(xy[:, :1])], 1)[faces].astype(np.float64)
    zf = z[faces].astype(np.float64)
    nxt, prv = p[:, [1, 2, 0]], p[:, [2, 0, 1]]  # edge k is opposite vertex k
    L = np.cross(nxt, prv)  # (F, 3 edges, 3 coefs)
    lc_mag = np.abs(nxt[..., 0] * prv[..., 1]) + np.abs(nxt[..., 1] * prv[..., 0])
    lo, hi = np.ones(len(ys)), np.ones(len(ys))
    for i, (y, x) in enumerate(zip(ys, xs)):
        X, Y = x + 0.5, y + 0.5
        E = L[..., 0] * X + L[..., 1] * Y + L[..., 2]  # (F, 3)
        err = slack * eps * (np.abs(L[..., 0]) * X + np.abs(L[..., 1]) * Y + lc_mag)
        Es = E.sum(1)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = (E * zf).sum(1) / Es
            derr = (err * (np.abs(zf) + np.abs(d)[:, None])).sum(1) / np.abs(Es)
        s = np.sign(Es)[:, None]
        sliver = on & (np.abs(Es) <= err.sum(1))
        ok = on & ~sliver
        maybe = ok & (s * E >= -err).all(1) & (d + derr > 0) & (d - derr <= 1)
        surely = ok & (s * E > err).all(1) & (d - derr > 0) & (d + derr <= 1)
        sliver &= (E >= -err).all(1) | (E <= err).all(1)
        lo[i] = 0.0 if sliver.any() else min(1.0, (d - derr)[maybe].min(initial=1.0))
        hi[i] = min(1.0, (d + derr)[surely].min(initial=1.0))
    return lo, hi


@pytest.mark.parametrize("size,n", [(64, 200), (1024, 400)])
def test_classic_shadow_depth_matches_jax(classic, size, n):
    xy, z, faces, on = shadow_triangles(3, size, n)
    dj = np.asarray(jax_ortho_depth(
        jnp.asarray(xy), jnp.asarray(z), jnp.asarray(faces), jnp.asarray(on), size,
        use_pallas=True,
    ))
    dp = _ortho_rasterize_depth(
        torch.from_numpy(xy), torch.from_numpy(z), torch.from_numpy(faces), torch.from_numpy(on),
        size, raster="classic",
    ).numpy()
    covered = dj < 1.0
    assert covered.sum() > 0.02 * size * size, "the map is nearly empty"
    # 1e-5 wherever float32 pins the depth down to 1e-5. A pixel beyond it,
    # at most 1% of the covered pixels, must be one where it does not (XLA's
    # fused multiply-adds and PyTorch's separate roundings then land
    # differently), and there the port lies within float32's error bound of
    # the float64 answer.
    ys, xs = np.nonzero(np.abs(dp - dj) > 1e-5)
    assert len(ys) <= 0.01 * covered.sum(), f"{len(ys)} ill-conditioned pixels"
    lo, hi = shadow_depth_bounds(xy, z, faces, on, ys, xs)
    assert (hi - lo > 1e-5).all(), "a well-conditioned pixel differs by more than 1e-5"
    assert (dp[ys, xs] >= lo).all() and (dp[ys, xs] <= hi).all()
