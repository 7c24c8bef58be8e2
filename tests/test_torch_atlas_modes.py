"""The atlas's two modes against the JAX package: the shadow-caster proxy's
target (``build_scene_atlas(shadow_proxy_target=)``, the JAX package's
``SL_SHADOW_PROXY``, read at each call; 0 = the full geometry casts the
shadow) and the cull-eligibility threshold (``cull_closedness=``,
``SL_CULL_CLOSEDNESS``, read at import: the JAX side patches its module
constant).

On the 81,920-face blob (beside a cube, the open sphere and the blob with
holes cut, whose closedness lies between the thresholds and under the
default 0.98), targets 0 and
2048 give shadow arrays equal to JAX's, and thresholds 0.5 and 1.0 give
cull flags equal to JAX's. On the small scene at 48 x 48, with a target of
512 (binding the blob and the sphere) and with a threshold of 1.0 under the
back-face cull, the port's own atlas equals the JAX package's, the PCF
shadow maps agree within 1e-5 (at most 0.1% of the covered pixels within
1e-4, as in ``tests/test_torch_shadow_modes.py``) and the frames by the
rules of ``tests/test_torch_frame.py``; the proxy changes the frame, the
threshold 1.0 does not (the cube's and the blob's closedness is exactly
1.0, the sphere's 0).
"""

import os

import numpy as np
import pytest
import torch

import stillleben_tpu as jsl
from stillleben_tpu.parallel.batch import template_from_scene as jax_template_from_scene
from stillleben_tpu.render import atlas as jatlas
from stillleben_tpu.render import shadow as jsh
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu.render.rasterize import geometry_stage as jax_geometry_stage
from stillleben_tpu_torch.assets.procedural import _blob, _write_obj
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.parallel.batch import render_with_poses, template_from_scene
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.render import shadow as sh
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.scene.scene import Object, Scene
from torch_port_scene import (
    H, SHADOW_SIZE, W, build_meshes, check_frame_pair, frame_inputs, render_pair, settled_scene,
    to_numpy, vsm_penumbra,
)

SHADOW_FIELDS = ("shadow_positions", "shadow_vert_obj", "shadow_faces", "shadow_face_obj",
                 "shadow_face_cullable")
JAX_CFG = JaxFrameConfig(
    width=W, height=H, shading="pbr", ssao=False, max_lights=1, shadow_size=SHADOW_SIZE,
    shadow_mode="vsm", sample_textures=False, sample_stickers=False, alpha_peel=False,
    shading_dtype="f32",
)
CFG = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                  sample_textures=False, sample_stickers=False)


def holed_blob(directory, subdiv, port):
    """The blob with a wedge (faces whose centre lies beyond 0.55 of the
    largest x) and every 50th face cut out, closedness ~0.97, loaded by the
    port's ``Mesh`` or the JAX package's, scaled as ``build_meshes`` scales
    the blob."""
    if port:
        from stillleben_tpu_torch.assets.mesh import Mesh
    else:
        from stillleben_tpu.assets.mesh import Mesh
    path = os.path.join(directory, f"blob_s{subdiv}_holed.obj")
    if not os.path.exists(path):
        p, f = _blob(subdiv, 0)
        x = p[f].mean(1)[:, 0]
        keep = (x < 0.55 * np.abs(p[f].mean(1)).max()) & (np.arange(len(f)) % 50 != 0)
        _write_obj(path, p, f[keep])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", os.path.join(directory, "mesh_cache"))
        mesh = Mesh(path, physics=False)
    mesh.center_bbox()
    mesh.scale_to_bbox_diagonal(0.25)
    mesh.class_index = 4
    return mesh


def meshes_of(directory, subdiv, port):
    """cube, sphere, the blob and the holed blob."""
    return (*build_meshes(directory, subdiv, port, native_decomp=True),
            holed_blob(directory, subdiv, port))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dense"))
    jm, pm = meshes_of(d, 6, False), meshes_of(d, 6, True)
    assert pm[2].consolidated.faces.shape[0] == 81920
    closed = [patlas._mesh_closedness(m.consolidated.positions, m.consolidated.faces) for m in pm]
    assert 0.5 < closed[3] < 1.0 and closed[2] == 1.0, closed
    return [jsl.Object(m) for m in jm], [Object(m) for m in pm]


@pytest.mark.parametrize("target", [0, 2048])
def test_shadow_proxy_arrays_equal_jax(dense, monkeypatch, target):
    jobjs, pobjs = dense
    monkeypatch.setenv("SL_SHADOW_PROXY", str(target))
    ja = jatlas.build_scene_atlas(jobjs)
    pa = patlas.build_scene_atlas_numpy(pobjs, shadow_proxy_target=target)
    for name in SHADOW_FIELDS:
        np.testing.assert_array_equal(pa[name], np.asarray(getattr(ja, name)), err_msg=name)
    n = pa["shadow_faces"].shape[0]
    assert n > 81920 if target == 0 else n < 4 * 2048, n  # full casters, or the blobs decimated


@pytest.mark.parametrize("threshold", [0.5, 1.0])
def test_cull_flags_equal_jax(dense, monkeypatch, threshold):
    jobjs, pobjs = dense
    monkeypatch.setattr(jatlas, "CULL_CLOSEDNESS", threshold)
    ja = jatlas.build_scene_atlas(jobjs)
    pa = patlas.build_scene_atlas_numpy(pobjs, cull_closedness=threshold)
    for name in ("face_cullable", "shadow_face_cullable"):
        np.testing.assert_array_equal(pa[name], np.asarray(getattr(ja, name)), err_msg=name)
    holed = pa["face_obj"] == 3
    assert holed.any()
    assert pa["face_cullable"][holed].all() == (threshold < 0.9)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(JAX, port) meshes of the small scene: the cube, the sphere and the
    blob."""
    d = str(tmp_path_factory.mktemp("small"))
    return tuple(build_meshes(d, 3, port, native_decomp=True) for port in (False, True))


MODES = {"proxy 512": dict(shadow_proxy_target=512), "closedness 1.0": dict(cull_closedness=1.0)}


def _templates(small, monkeypatch, mode):
    """The JAX package's template of the small scene under ``mode``, and
    the port's own. (The frames compare on the JAX template's arrays, as
    every frame test does: the two packages' projection matrices differ by
    an ulp.)"""
    kw = MODES[mode]
    jm, pm = small
    monkeypatch.setenv("SL_SHADOW_PROXY", str(kw.get("shadow_proxy_target", 8192)))
    monkeypatch.setattr(jatlas, "CULL_CLOSEDNESS", kw.get("cull_closedness", 0.98))
    js = jsl.Scene((W, H))
    js.seed(0)
    ps = Scene((W, H))
    rng = np.random.default_rng(7)  # the overrides of tests/test_torch_shadow_modes.py
    for jmesh, pmesh in zip(jm, pm):
        jo, po = jsl.Object(jmesh), Object(pmesh)
        jo.metallic = po.metallic = float(rng.random())
        jo.roughness = po.roughness = float(rng.random())
        js.add_object(jo)
        ps.add_object(po)
    return jax_template_from_scene(js), template_from_scene(ps, "cpu", **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_under_the_mode_matches_jax(small, monkeypatch, mode):
    cull = mode.startswith("closedness")
    if cull:
        monkeypatch.setenv("SL_BACKFACE_CULL", "1")
    tpl, own = _templates(small, monkeypatch, mode)
    ptpl = template_from_numpy(to_numpy(tpl), "cpu")
    for name, value in own.render_atlas._asdict().items():  # the port's own atlas is JAX's
        want = getattr(ptpl.render_atlas, name)
        assert value == want if isinstance(value, int) else torch.equal(value, want), name
    poses, cam, light = settled_scene(tpl)
    jin = frame_inputs(tpl, poses, cam, light)
    pin = ptpl.base_inputs._replace(**{f: torch.from_numpy(np.array(getattr(jin, f)))
                                       for f in ("obj_to_world", "cam_pose", "light_directions")})
    maps_j, _ = to_numpy(jsh.render_shadow_maps(
        tpl.render_atlas, jin, jax_geometry_stage(tpl.render_atlas, jin, W, H),
        JAX_CFG._replace(shadow_mode="pcf")))
    maps_p, _ = sh.render_shadow_maps(ptpl.render_atlas, pin, SHADOW_SIZE, 1, mode="pcf")
    err = np.abs(maps_p.numpy() - maps_j)
    covered = maps_j < 1
    assert covered.mean() > 0.02, "the map is nearly empty"
    assert (err > 1e-5).sum() <= 1e-3 * covered.sum(), f"{(err > 1e-5).sum()} pixels beyond 1e-5"
    assert err.max() <= 1e-4
    cfg = CFG._replace(backface_cull=cull)
    fj, fp, tri_j, tri_p, v = render_pair(tpl, ptpl, poses, cam, light,
                                          JAX_CFG._replace(use_pallas=None), cfg)
    check_frame_pair(fj, fp, tri_j, tri_p, v, ~vsm_penumbra(fj, tpl, poses, cam, light, JAX_CFG))
    # against the port's frame at both modes' defaults: the proxy moves the
    # shadow; the threshold 1.0 keeps the cube and the blob (closedness
    # exactly 1.0) cullable and the open sphere not, as 0.98 does
    default = template_from_scene_default(ptpl, small[1])
    pp, pc, pl = (torch.from_numpy(np.array(x)) for x in (poses, cam, light))
    before = render_with_poses(default, pp, pc, cfg, pl)
    after = render_with_poses(ptpl, pp, pc, cfg, pl)
    assert torch.equal(before.hdr, after.hdr) == cull, mode


def template_from_scene_default(ptpl, meshes):
    """``ptpl`` with the render atlas of the port's ``meshes`` at both
    modes' defaults."""
    ps = Scene((W, H))
    for pmesh in meshes:
        ps.add_object(Object(pmesh))
    return ptpl._replace(render_atlas=template_from_scene(ps, "cpu").render_atlas)
