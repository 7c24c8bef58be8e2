"""Public names of the JAX package's modules that the port's counterparts
lacked, against the JAX functions on the same seeded numpy inputs:
``Range3D.union``, ``ConsolidatedMesh.num_faces``, ``convex.mesh_volume``,
``HullAtlas.num_hulls`` and ``shadow.shadow_factor`` (the 4x4 PCF on
(H, W, 3) world positions).

Tolerances: ``union`` and the counts exact; ``mesh_volume`` within 1e-6
relative (both float64 sums of the same float32 products in numpy, so
equal in practice); ``shadow_factor`` bitwise, on world points and
matrices whose products are exact in float32 (multiples of 1/64 times
powers of two), so no compare sits on a rounding edge of either
backend's matrix product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu.assets import consolidate as jconsolidate
from stillleben_tpu.assets import convex as jconvex
from stillleben_tpu.core.range3d import Range3D as JRange3D
from stillleben_tpu.physics import types as jtypes
from stillleben_tpu.render import shadow as jshadow
from stillleben_tpu_torch.assets import consolidate, convex
from stillleben_tpu_torch.core.range3d import Range3D
from stillleben_tpu_torch.physics import types
from stillleben_tpu_torch.render import shadow


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range3d_union(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(2, 5, 3)).astype(np.float32)
    ours = Range3D.from_points(a).union(Range3D.from_points(b))
    ref = JRange3D.from_points(a).union(JRange3D.from_points(b))
    np.testing.assert_array_equal(ours.min, ref.min)
    np.testing.assert_array_equal(ours.max, ref.max)
    empty = Range3D().union(Range3D.from_points(a))
    np.testing.assert_array_equal(empty.max, JRange3D().union(JRange3D.from_points(a)).max)


def _mesh(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (70, 3)).astype(np.uint32)
    return v, f


@pytest.mark.parametrize("seed", [0, 1])
def test_consolidated_num_faces(seed):
    v, f = _mesh(seed)
    fields = dict(positions=v, normals=v, texcoords=v[:, :2], colors=np.ones((40, 4), np.float32),
                  tangents=np.ones((40, 4), np.float32),
                  vertex_indices=np.arange(1, 41, dtype=np.uint32), faces=f)
    ours = consolidate.ConsolidatedMesh(**fields)
    ref = jconsolidate.ConsolidatedMesh(**fields)
    assert ours.num_faces == ref.num_faces == 70
    assert ours.num_vertices == ref.num_vertices


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_volume(seed):
    v, f = _mesh(seed)
    np.testing.assert_allclose(convex.mesh_volume(v, f), jconvex.mesh_volume(v, f), rtol=1e-6)
    cube = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 2)], np.float32)
    faces = np.array([[0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
                      [2, 6, 7], [2, 7, 3], [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5]])
    assert convex.mesh_volume(cube, faces) == jconvex.mesh_volume(cube, faces) == 2.0


def test_hull_atlas_num_hulls():
    rng = np.random.default_rng(4)
    lists = [[{"verts": rng.normal(size=(9, 3)), "planes": rng.normal(size=(12, 4))}
              for _ in range(k)] for k in (2, 0, 3)]
    fields = types.build_hull_atlas_numpy(lists)
    ours = types.HullAtlas(**{k: torch.from_numpy(a) for k, a in fields.items()})
    assert ours.num_hulls == jtypes.build_hull_atlas(lists).num_hulls == 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shadow_factor(seed):
    """The PCF on (H, W, 3) points over a random map, each light: bitwise."""
    rng = np.random.default_rng(seed)
    L, S, H, W = 2, 16, 12, 20
    maps = rng.uniform(0.0, 1.0, (L, S, S)).astype(np.float32)
    mats = np.zeros((L, 4, 4), np.float32)
    for i in range(L):  # u, v in texels (scale 8 about the middle), z in [0, 1]
        mats[i, 0, 0] = mats[i, 1, 1] = 8.0
        mats[i, 0, 2], mats[i, 1, 0] = 2.0 * (i - 0.5), 0.5
        mats[i, 2, 2], mats[i, :3, 3] = 0.25, (8.0, 8.0, 0.5)
    world = (rng.integers(-128, 129, (H, W, 3)) / 64.0).astype(np.float32)
    for light in range(L):
        ours = shadow.shadow_factor(torch.from_numpy(maps), torch.from_numpy(mats), light,
                                    torch.from_numpy(world))
        ref = jshadow.shadow_factor(jnp.asarray(maps), jnp.asarray(mats), light,
                                    jnp.asarray(world))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        planar = shadow.shadow_factor_planar(torch.from_numpy(maps), torch.from_numpy(mats), light,
                                             torch.from_numpy(world).permute(2, 0, 1))
        np.testing.assert_array_equal(ours.numpy(), planar.numpy())
        assert 0.0 < float(ours.mean()) < 1.0
