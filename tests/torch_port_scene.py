"""Shared fixtures of the PyTorch-port tests: one small scene built from the
procedural mesh files, as a JAX template and as a port template, plus the
pixel-agreement rule the raster and frame tests hold both packages to."""

from __future__ import annotations

import os

import numpy as np
import pytest

W = H = 48
SHADOW_SIZE = 64


def build_meshes(directory: str, subdiv: int = 3, port: bool = False, native_decomp: bool = True):
    """cube (0.25 bbox diagonal, class 1), sphere (0.3, class 2) and a
    dense blob (0.25, class 3) loaded from the procedural OBJ files, by the
    port's own ``Mesh`` (``port=True``) or by the JAX package's. The convex
    cooking cache goes to ``directory`` too. ``native_decomp=False`` makes
    the JAX package cook hulls with its Python decomposition, the one
    algorithm the port has, so templates of both packages can be compared."""
    if port:
        from stillleben_tpu_torch.assets.mesh import Mesh
    else:
        from stillleben_tpu.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import write_meshes

    paths = write_meshes(directory, subdiv=subdiv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", os.path.join(directory, "mesh_cache"))
        if not native_decomp:
            mp.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "0")
        cube = Mesh(paths["cube"])
        sphere = Mesh(paths["sphere"])
        blob = Mesh(paths["blob"], flags=Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL)
    cube.scale_to_bbox_diagonal(0.25)
    sphere.scale_to_bbox_diagonal(0.3)
    blob.center_bbox()
    blob.scale_to_bbox_diagonal(0.25)
    for i, mesh in enumerate((cube, sphere, blob)):
        mesh.class_index = i + 1
    return cube, sphere, blob


def jax_template(meshes, metallic_roughness=None):
    import stillleben_tpu as sl
    from stillleben_tpu.parallel.batch import template_from_scene

    scene = sl.Scene((W, H))
    scene.seed(0)
    for i, mesh in enumerate(meshes):
        o = sl.Object(mesh)
        if metallic_roughness is not None:
            o.metallic, o.roughness = metallic_roughness[i]
        scene.add_object(o)
    return template_from_scene(scene)


def port_template(meshes, device="cpu", metallic_roughness=None):
    from stillleben_tpu_torch.parallel.batch import template_from_scene
    from stillleben_tpu_torch.scene.scene import Object, Scene

    scene = Scene((W, H))
    for i, mesh in enumerate(meshes):
        o = Object(mesh)
        if metallic_roughness is not None:
            o.metallic, o.roughness = metallic_roughness[i]
        scene.add_object(o)
    return template_from_scene(scene, device)


def to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def edge_values(v: np.ndarray, tri: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """Homogeneous edge functions (E0, E1, E2) and Esum, in float64, of
    triangles ``tri`` at pixel centres (xs + .5, ys + .5); v (F, 3, 3)."""
    t = v[tri].astype(np.float64)
    L = np.stack(
        [np.cross(t[:, 1], t[:, 2]), np.cross(t[:, 2], t[:, 0]), np.cross(t[:, 0], t[:, 1])], 1
    )
    p = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, dtype=np.float64)], -1)
    E = np.einsum("nkc,nc->nk", L, p)
    return E, E.sum(1)


def check_id_agreement(ids_a, ids_b, v, depth_attr, min_frac=0.999, tie=1e-5, on_edge=1e-5):
    """Triangle ids equal on >= ``min_frac`` of the pixels, and every
    mismatch is a depth tie (the two winners' depths within ``tie``) or a
    pixel centre on an edge of either winner (|E_k| / |Esum| < ``on_edge``).
    Returns the boolean map of agreeing pixels."""
    agree = ids_a == ids_b
    assert agree.mean() >= min_frac, f"ids agree on only {agree.mean():.5f} of pixels"
    ys, xs = np.nonzero(~agree)
    for y, x in zip(ys, xs):
        a, b = int(ids_a[y, x]), int(ids_b[y, x])
        cands = [t for t in (a, b) if t >= 0]
        E, Es = edge_values(v, np.array(cands), np.full(len(cands), y), np.full(len(cands), x))
        edge = (np.abs(E).min(1) / np.maximum(np.abs(Es), 1e-30) < on_edge).any()
        depth_tie = False
        if a >= 0 and b >= 0:
            d = np.einsum("nk,nk->n", E, depth_attr[np.array(cands)].astype(np.float64)) / Es
            depth_tie = abs(d[0] - d[1]) <= tie
        assert edge or depth_tie, f"pixel ({y}, {x}): ids {a} vs {b} neither tie nor on an edge"
    return agree


def depth_f64(v, depth_attr, tri_img):
    """The winner's interpolated depth Ez / Esum evaluated in float64 from
    the same float32 vertices; nan where no triangle won."""
    ys, xs = np.nonzero(tri_img >= 0)
    out = np.full(tri_img.shape, np.nan)
    t = tri_img[ys, xs]
    E, Es = edge_values(v, t, ys, xs)
    out[ys, xs] = (E * depth_attr[t].astype(np.float64)).sum(1) / Es
    return out


def check_depth(d_port, d_ref, d64, mask, tol=1e-5, ill_tol=1e-4, max_ill_frac=0.01,
                well_tol=None):
    """Depth within ``tol`` of the reference at every pixel of ``mask``
    where both are within ``well_tol`` (default ``tol``) of the float64
    value. The homogeneous
    depth of a triangle only a pixel or two across is ill-conditioned in
    float32 (large line coefficients cancel): there the rounding of either
    side alone (fused multiply-adds in XLA, none in PyTorch, or a different
    interpolation formula) moves it by more than ``tol``. At those pixels,
    at most ``max_ill_frac`` of ``mask``, the port must be within
    ``ill_tol`` of the float64 value."""
    well_tol = tol if well_tol is None else well_tol
    well = (np.abs(d_ref - d64) <= well_tol) & (np.abs(d_port - d64) <= well_tol)
    np.testing.assert_allclose(d_port[mask & well], d_ref[mask & well], rtol=0, atol=tol)
    ill = mask & ~well
    assert ill.sum() <= max_ill_frac * mask.sum(), f"{ill.sum()} ill-conditioned pixels"
    np.testing.assert_allclose(d_port[ill], d64[ill], rtol=0, atol=ill_tol)


def well_conditioned(bary_a, bary_b, tri, v, tol=1e-5):
    """Hit pixels where both runs' float32 barycentrics lie within
    ``tol`` of the float64 ones: there every interpolated buffer is as
    good as float32 allows. Elsewhere (triangles a pixel or two across)
    the barycentrics themselves are ill-conditioned."""
    ys, xs = np.nonzero(tri >= 0)
    E, Es = edge_values(v, tri[ys, xs], ys, xs)
    b64 = E / Es[:, None]
    ok = np.zeros(tri.shape, bool)
    ok[ys, xs] = (np.abs(bary_a[ys, xs] - b64).max(1) <= tol) & (
        np.abs(bary_b[ys, xs] - b64).max(1) <= tol
    )
    return ok
