"""Shared fixtures of the PyTorch-port tests: one small scene built from the
procedural mesh files, as a JAX template and as a port template, plus the
pixel-agreement rule the raster and frame tests hold both packages to."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on one machine. With torch's default of
# one intra-op thread per core in each of them the OpenMP pools oversubscribe
# the cores and spin against each other: six workers on eight cores took over
# 25 minutes for a file that runs in 30 s alone, and 60 s with one thread
# each. Every port test file imports this module, so the limit holds for all.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

W = H = 48
SHADOW_SIZE = 64


def build_meshes(directory: str, subdiv: int = 3, port: bool = False, *, native_decomp: bool):
    """cube (0.25 bbox diagonal, class 1), sphere (0.3, class 2) and a
    dense blob (0.25, class 3) loaded from the procedural OBJ files, by the
    port's own ``Mesh`` (``port=True``) or by the JAX package's. The convex
    cooking cache goes to ``directory`` too. Both packages read the same
    switch, ``STILLLEBEN_TPU_NATIVE_DECOMP``, so every caller states the
    cooker: ``native_decomp`` True cooks with the native decomposer, False
    with the Python one; templates of the two packages compare only when
    their meshes were cooked alike."""
    if port:
        from stillleben_tpu_torch.assets.mesh import Mesh
    else:
        from stillleben_tpu.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import write_meshes

    paths = write_meshes(directory, subdiv=subdiv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", os.path.join(directory, "mesh_cache"))
        mp.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1" if native_decomp else "0")
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


def image_loss_grad(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """dL/dI (3, H, W) of 0.5 |blur(I) - blur(T)|^2 with the 5x5 Gaussian of
    sigma 1 (the loss of tests/test_diff.py::_image_loss_grad), by
    autograd; ``img`` and ``target`` (H, W, 3). convolve2d's "same" mode
    is the correlation with the flipped kernel, padded by 2."""
    import torch.nn.functional as F

    from stillleben_tpu_torch import diff

    kernel = torch.flip(diff.gaussian_kernel(5, 1.0, img.device), (0, 1))[None, None]

    def blur(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], kernel, padding=2)[:, 0]

    img = img.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(0.5 * ((blur(img) - blur(target)) ** 2).sum(), img)
    return g.permute(2, 0, 1)


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


# --- the full frame: textures, stickers, background plane, light map -------

SUN = (np.array([0.3, 0.5, -0.8], np.float32) / np.linalg.norm([0.3, 0.5, -0.8]),
       np.array([3.0, 2.8, 2.5], np.float32))


def build_full_meshes(directory: str, subdiv: int = 3, port: bool = False, *,
                      native_decomp: bool):
    """cube (class 1), sphere (2), the textured blob (3) and the cube with
    the cutout texture (4), by the port's ``Mesh`` or the JAX package's,
    cooked as ``build_meshes`` says."""
    if port:
        from stillleben_tpu_torch.assets.mesh import Mesh
    else:
        from stillleben_tpu.assets.mesh import Mesh
    from stillleben_tpu_torch.assets.procedural import write_meshes

    paths = write_meshes(directory, subdiv=subdiv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", os.path.join(directory, "mesh_cache"))
        mp.setenv("STILLLEBEN_TPU_NATIVE_DECOMP", "1" if native_decomp else "0")
        cube = Mesh(paths["cube"])
        sphere = Mesh(paths["sphere"])
        blob = Mesh(paths["blob_textured"], flags=Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL)
        cutout = Mesh(paths["cube_cutout"])
    cube.scale_to_bbox_diagonal(0.25)
    sphere.scale_to_bbox_diagonal(0.3)
    blob.center_bbox()
    blob.scale_to_bbox_diagonal(0.25)
    cutout.scale_to_bbox_diagonal(0.25)
    for i, mesh in enumerate((cube, sphere, blob, cutout)):
        mesh.class_index = i + 1
    return cube, sphere, blob, cutout


def sticker_pixels(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded (h, w, 4) uint8 sticker, alpha at least 128."""
    st = np.random.default_rng(seed).integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    st[..., 3] = np.maximum(st[..., 3], 128)
    return st


def fill_full_scene(scene, meshes, make_object, texture_cls, texture2d_cls, light_map,
                    stickers: bool = False, overrides: bool = True):
    """The same full scene into either package's host ``Scene``: the objects
    (seeded metallic/roughness overrides; with ``stickers`` a sticker of its
    own size on every object but the first), a 3 x 3 m plane with the
    512^2 checker, and the light map."""
    from stillleben_tpu_torch.assets.procedural import checker_texture

    rng = np.random.default_rng(7)
    for i, mesh in enumerate(meshes):
        o = make_object(mesh)
        if overrides:
            o.metallic, o.roughness = float(rng.random()), float(rng.random())
        if stickers and i > 0:
            o.sticker_texture = texture_cls(sticker_pixels(i, 20 + 6 * i, 30 - 4 * i))
            o.sticker_range = np.array([-0.5, -0.5, 1.0, 1.0], np.float32)
            o.sticker_rotation = np.array([0.9238795, 0.3826834, 0.0, 0.0], np.float32)
        scene.add_object(o)
    scene.light_map = light_map
    scene.background_plane_size = np.array([3.0, 3.0], np.float32)
    scene.background_plane_texture = texture2d_cls(checker_texture())
    return scene


def jax_light_map():
    """The JAX package's precompute of the benchmark's sky panorama."""
    from stillleben_tpu.render.light_map import LightMap
    from stillleben_tpu_torch.assets.procedural import sky_equirect

    return LightMap.from_equirect(sky_equirect(), lights=[SUN])


def jax_full_template(meshes, light_map, stickers=False, overrides=True, size=(W, H)):
    import stillleben_tpu as sl
    from stillleben_tpu.parallel.batch import template_from_scene

    scene = sl.Scene(size)
    scene.seed(0)
    fill_full_scene(scene, meshes, sl.Object, sl.Texture, sl.Texture2D, light_map,
                    stickers, overrides)
    return template_from_scene(scene)


def port_full_template(meshes, light_map, device="cpu", stickers=False, overrides=True,
                       size=(W, H)):
    from stillleben_tpu_torch.assets.texture import Texture, Texture2D
    from stillleben_tpu_torch.parallel.batch import template_from_scene
    from stillleben_tpu_torch.scene.scene import Object, Scene

    scene = fill_full_scene(Scene(size), meshes, Object, Texture, Texture2D, light_map,
                            stickers, overrides)
    return template_from_scene(scene, device)


# --- one scene rendered by both packages, and the frame rules ---------------


def settled_scene(tpl, key: int = 3, iterations: int = 10):
    """JAX-settled (poses, camera, light direction) of the template."""
    import jax

    from stillleben_tpu.parallel.batch import settle_scene
    from stillleben_tpu.physics.types import default_config

    return settle_scene(jax.random.PRNGKey(key), tpl, default_config(),
                        settle_iterations=iterations)


def frame_inputs(tpl, poses, cam, light):
    """The JAX template's RenderInputs of one settled scene."""
    n = min(tpl.base_inputs.obj_to_world.shape[0], poses.shape[0])  # a plane's slot stays
    return tpl.base_inputs._replace(
        obj_to_world=tpl.base_inputs.obj_to_world.at[:n].set(poses[:n]), cam_pose=cam,
        light_directions=tpl.base_inputs.light_directions.at[0].set(light),
    )


def render_pair(tpl, ptpl, poses, cam, light, jax_cfg, cfg):
    """Both packages' frames of one scene (numpy, uint16 maps as int32), and
    what the frame rules need: both triangle-id images of the camera raster
    and the projected vertices (F, 3, 3). The JAX package runs eagerly, so
    the environment variables the caller set are read now; its raster
    follows ``jax_cfg.use_pallas`` and ``SL_RASTER``, the port's ``cfg``."""
    from stillleben_tpu.parallel.batch import render_with_poses as jax_render
    from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
    from stillleben_tpu.render.rasterize_tiled import rasterize_tiled as jax_rasterize_tiled
    from stillleben_tpu_torch.parallel.batch import render_with_poses
    from stillleben_tpu_torch.render.rasterize import geometry_stage
    from stillleben_tpu_torch.render.rasterize_tiled import rasterize_tiled

    w, h = cfg.width, cfg.height
    fj = to_numpy(jax_render(tpl, poses, cam, jax_cfg, light))
    pposes, pcam, plight = (torch.from_numpy(np.array(x)) for x in (poses, cam, light))
    fp = render_with_poses(ptpl, pposes, pcam, cfg, plight)
    fp = type(fp)(*(x.to(torch.int32).numpy() if x.dtype == torch.uint16 else x.numpy() for x in fp))
    jin = frame_inputs(tpl, poses, cam, light)
    jgeom = jax_geometry_stage(tpl.render_atlas, jin, w, h)
    tri_j = np.asarray(jax_rasterize_tiled(
        jgeom, tpl.render_atlas, jin, w, h, use_pallas=jax_cfg.use_pallas).tri_id)
    pin = ptpl.base_inputs._replace(
        obj_to_world=torch.from_numpy(np.asarray(jin.obj_to_world)), cam_pose=pcam,
        light_directions=torch.from_numpy(np.asarray(jin.light_directions)),
    )
    pgeom = geometry_stage(ptpl.render_atlas, pin, w, h)
    tri_p = rasterize_tiled(pgeom, ptpl.render_atlas, pin, w, h, raster=cfg.raster,
                            backface_cull=cfg.backface_cull).tri_id.numpy()
    v = np.asarray(jgeom.pix_hom)[np.asarray(tpl.render_atlas.faces)]
    return fj, fp, tri_j, tri_p, v


def check_frame_pair(fj, fp, tri_j, tri_p, v, calm=None, min_quiet=0.3):
    """The rules of ``tests/test_torch_frame.py``: triangle ids by the
    tie/edge rule and the index maps equal where they agree; valid equal;
    depth 1e-5 by ``check_depth``; where the ids agree, coordinates and
    normals 1e-5 (where the barycentrics are ill-conditioned, 1e-4 and
    1e-3);
    hdr 1e-4 relative at well-conditioned pixels (and within ``calm``, an
    (H, W) mask, when given), which must be ``min_quiet`` of the hit
    pixels at least; rgb within 1 LSB where the ids agree."""
    assert (fj.instance_index > 0).sum() > 100, "scene unexpectedly empty"
    agree = check_id_agreement(tri_p, tri_j, v, v[..., 2])
    h, w = agree.shape
    for name in ("instance_index", "class_index", "vertex_indices"):
        diff = (getattr(fp, name) != getattr(fj, name)).reshape(h, w, -1).any(-1)
        assert not (diff & agree).any(), f"{name} differs where the triangle ids agree"
    hit = agree & (tri_j >= 0)
    well = well_conditioned(fj.barycentric_coeffs, fp.barycentric_coeffs, tri_j, v)
    np.testing.assert_array_equal(fp.valid, fj.valid)
    check_depth(fp.depth, fj.depth, depth_f64(v, v[..., 2], tri_j), hit)
    # where the barycentrics are ill-conditioned they differ by up to ~1e-3:
    # coordinates (a few mm across a triangle) move by < 1e-4, unit
    # normals (which turn across it) by < 1e-3, as in tests/test_torch_gpu.py
    for name, ill_tol in (("object_coordinates", 1e-4), ("cam_coordinates", 1e-4),
                          ("normals", 1e-3)):
        a, b = getattr(fp, name), getattr(fj, name)
        np.testing.assert_allclose(a[agree & (well | ~hit)], b[agree & (well | ~hit)],
                                   rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a[hit & ~well], b[hit & ~well], rtol=0, atol=ill_tol,
                                   err_msg=name)
    quiet = agree & (well | (tri_j < 0))
    if calm is not None:
        quiet &= calm | (tri_j < 0)
    assert (hit & quiet).sum() >= min_quiet * hit.sum(), "too few well-conditioned pixels"
    np.testing.assert_allclose(fp.hdr[quiet], fj.hdr[quiet], rtol=1e-4, atol=1e-6)
    d = np.abs(fp.rgb.astype(np.int32) - fj.rgb.astype(np.int32))
    assert d[agree].max() <= 1
    return agree


def vsm_penumbra(fj, tpl, poses, cam, light, jax_cfg):
    """Pixels of the JAX frame in the VSM penumbra (shadow factor strictly
    between 0 and 1), where the Chebyshev bound turns 1e-7 differences of
    the world position into relative colour changes of 1e-3."""
    from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
    from stillleben_tpu.render.shadow import render_shadow_maps, shadow_factor_vsm_planar

    jin = frame_inputs(tpl, poses, cam, light)
    h, w = fj.valid.shape
    maps, mats = render_shadow_maps(tpl.render_atlas, jin,
                                    jax_geometry_stage(tpl.render_atlas, jin, w, h), jax_cfg)
    cam_pose = np.asarray(cam)
    cc = fj.cam_coordinates[..., :3].reshape(-1, 3).T.astype(np.float64)
    world = (cam_pose[:3, :3] @ cc + cam_pose[:3, 3:4]).reshape(3, h, w)
    sf = np.asarray(shadow_factor_vsm_planar(maps, mats, 0, world.astype(np.float32)))
    return (sf > 1e-3) & (sf < 1 - 1e-3)
