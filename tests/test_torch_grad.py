"""Pose gradients of the port against ``jax.grad`` of the JAX package, at
48x48 on the CPU (the JAX side with its Pallas kernels in interpret mode).

The loss of ``tests/test_parallel.py:106-113``: a masked squared hdr error
to a target rendered at the settled poses, differentiated with respect to
the pose deltas of ``apply_pose_delta_matrix`` at 0.01 in alpha and 0.02 in
z. The target is the JAX frame, fed to both packages; the mask drops, in
both losses alike, the pixels where the two packages' instance maps of the
perturbed frame disagree (edge and tie pixels of the raster rule). A
second loss, the masked sum of ``depth``, checks the depth gradient.

Cases: shadow off, PCF and the classic raster with VSM (its shadow splats
keep their gradient, as the JAX package's do) here; the bench frame (VSM,
fast SSAO, textures, the image-based light with skybox, the background
plane) in ``test_torch_grad_bench.py``, which shares this file's helpers.
Tolerance per object, relative to that object's largest component: 2e-3,
or 2e-2 where VSM is on (the Chebyshev bound in the penumbra amplifies the
float32 rounding differences of ROADMAP C-5).

The z-buffers have no gradient in either package (the JAX package stops it
at rasterize_tiled.py:333, :348, :615-616, :927). Differentiating through
the port's plain z-buffer instead gives the VSM cases errors of 0.6-35x the
largest component, so these cases fail unless the port cuts the gradient
where the JAX package does. The kernel wrappers refuse inputs that carry a
gradient, on every device.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stillleben_tpu.parallel.batch import apply_pose_delta_matrix as jax_apply_delta
from stillleben_tpu.parallel.batch import render_with_poses as jax_render
from stillleben_tpu.parallel.batch import settle_scene as jax_settle_scene
from stillleben_tpu.physics.types import default_config as jax_default_config
from stillleben_tpu.render.frame import FrameConfig as JaxFrameConfig
from stillleben_tpu_torch.convert import template_from_numpy
from stillleben_tpu_torch.ops.cell_raster import cell_raster
from stillleben_tpu_torch.ops.fine_raster import fine_raster
from stillleben_tpu_torch.parallel.batch import apply_pose_delta_matrix, render_with_poses
from stillleben_tpu_torch.render.frame import FrameConfig
from torch_port_scene import H, SHADOW_SIZE, W, build_meshes, jax_template, to_numpy

PLAIN = dict(width=W, height=H, shading="pbr", ssao=False, max_lights=1,
             shadow_size=SHADOW_SIZE, sample_textures=False, sample_stickers=False)
BENCH = dict(width=W, height=H, shading="pbr", ssao=True, ssao_mode="fast", max_lights=1,
             shadow_size=SHADOW_SIZE, shadow_mode="vsm", sample_textures=True,
             sample_stickers=False, texture_filter="trilinear")
# case: (scene, frame fields, raster, per-object tolerance)
CASES = {
    "shadow_off": ("plain", dict(PLAIN, shadow_mode="off"), "cells", 2e-3),
    "pcf": ("plain", dict(PLAIN, shadow_mode="pcf"), "cells", 2e-3),
    "bench": ("full", BENCH, "cells", 2e-2),  # test_torch_grad_bench.py
    "classic": ("plain", dict(PLAIN, shadow_mode="vsm"), "classic", 2e-2),
}
DELTA = (0.01, 0.0, 0.0, 0.0, 0.0, 0.02)  # alpha, beta, gamma, x, y, z


def settled(tpl):
    """Both packages' templates with the JAX-settled poses, camera and light."""
    poses, cam, light = jax_settle_scene(
        jax.random.PRNGKey(3), tpl, jax_default_config(), settle_iterations=10)
    return tpl, template_from_numpy(to_numpy(tpl), "cpu"), poses, cam, light


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The plain scene: cube, sphere and blob with metallic/roughness."""
    rng = np.random.default_rng(7)
    meshes = build_meshes(str(tmp_path_factory.mktemp("meshes")), native_decomp=True)
    mr = [(float(rng.random()), float(rng.random())) for _ in meshes]
    return settled(jax_template(meshes, metallic_roughness=mr))


def gradients(scene, case):
    """Both packages' d(hdr loss)/d(delta) and d(depth loss)/d(delta),
    (nb, 6) each, and the mask of pixels both losses keep."""
    _, fields, raster, _ = CASES[case]
    tpl, ptpl, poses, cam, light = scene
    jax_cfg = JaxFrameConfig(shading_dtype="f32", use_pallas=True if raster == "classic" else None,
                             **fields)
    cfg = FrameConfig(raster=raster, **fields)
    nb = poses.shape[0]
    delta0 = np.tile(np.asarray(DELTA, np.float32), (nb, 1))

    old = os.environ.get("SL_RASTER")
    os.environ["SL_RASTER"] = raster  # read while the JAX side runs eagerly
    try:
        target = np.array(jax_render(tpl, poses, cam, jax_cfg, light).hdr)

        def forward(delta):
            f = jax_render(tpl, jax_apply_delta(poses, delta), cam, jax_cfg, light)
            return (f.hdr, f.depth), f.instance_index

        (hdr_j, depth_j), vjp, inst_j = jax.vjp(forward, jnp.asarray(delta0), has_aux=True)
        inst_j = np.asarray(inst_j).astype(np.int32)

        pdelta = torch.from_numpy(delta0).requires_grad_(True)
        pposes, pcam, plight = (torch.from_numpy(np.array(x)) for x in (poses, cam, light))
        f = render_with_poses(ptpl, apply_pose_delta_matrix(pposes, pdelta), pcam, cfg, plight)
        mask = inst_j == f.instance_index.to(torch.int32).numpy()
        m = mask.astype(np.float32)

        # the hdr loss sum(mask * (hdr - target)^2): its cotangent on JAX's hdr
        ct_hdr = np.zeros_like(target)
        ct_hdr[..., :3] = 2.0 * m[..., None] * (np.asarray(hdr_j)[..., :3] - target[..., :3])
        zeros_d = jnp.zeros_like(depth_j)
        (g_hdr_j,) = vjp((jnp.asarray(ct_hdr), zeros_d))
        (g_depth_j,) = vjp((jnp.zeros_like(hdr_j), jnp.asarray(m)))
    finally:
        if old is None:
            os.environ.pop("SL_RASTER", None)
        else:
            os.environ["SL_RASTER"] = old

    tm = torch.from_numpy(m)
    loss = (tm[..., None] * (f.hdr[..., :3] - torch.from_numpy(target[..., :3])) ** 2).sum()
    (g_hdr_p,) = torch.autograd.grad(loss, pdelta, retain_graph=True)
    (g_depth_p,) = torch.autograd.grad((tm * f.depth).sum(), pdelta)
    return (np.asarray(g_hdr_j), g_hdr_p.numpy()), (np.asarray(g_depth_j), g_depth_p.numpy()), mask


def relative_errors(g_port, g_jax):
    """Per object: the largest error of its 6 components relative to its
    largest JAX component."""
    scale = np.abs(g_jax).max(axis=1)
    return np.abs(g_port - g_jax).max(axis=1) / np.maximum(scale, 1e-30), scale


def check_gradients(scene, case):
    (hj, hp), (dj, dp), mask = gradients(scene, case)
    tol = CASES[case][3]
    assert mask.mean() > 0.98, f"instance maps agree on only {mask.mean():.4f} of the pixels"
    assert np.isfinite(hp).all() and np.isfinite(dp).all()
    for name, gp, gj in (("hdr", hp, hj), ("depth", dp, dj)):
        err, scale = relative_errors(gp, gj)
        print(f"{case} {name}: per-object relative errors {err}")
        # every object of the scene is in view and gets a gradient
        assert (scale > 0).all(), f"{name}: an object without a JAX gradient: {scale}"
        assert (np.abs(gp).max(axis=1) > 0).all(), f"{name}: an object without a port gradient"
        assert (err <= tol).all(), f"{case} {name}: per-object relative errors {err} > {tol}"


@pytest.mark.parametrize("case", ["shadow_off", "pcf", "classic"])
def test_pose_gradient_matches_jax(plain, case):
    check_gradients(plain, case)


@pytest.mark.parametrize("requires_grad", [True, False])
def test_kernel_wrappers_refuse_grad_inputs(requires_grad):
    """Both raster wrappers raise on an input that requires grad (the check
    runs before the device is looked at, so it holds on the card too);
    the same call without grad runs."""
    LT = torch.zeros((4, 16)).requires_grad_(requires_grad)
    ids = torch.full((2, 128), -1, dtype=torch.int32)
    cell_tile = torch.tensor([0, 1], dtype=torch.int32)
    md = torch.zeros((1, 256))
    ids2 = torch.full((1, 1, 128), -1, dtype=torch.int32)
    calls = (
        lambda: cell_raster(LT, ids, cell_tile, None, 0.1, 10.0, 1, 16, 1),
        lambda: fine_raster(LT, ids2, md, 0.1, 10.0, 128, 1),
    )
    for call in calls:
        if requires_grad:
            with pytest.raises(ValueError, match="requires grad"):
                call()
        else:
            w, t = call()
            assert torch.isinf(w).all() and (t == -1).all()


def test_cell_raster_refuses_grad_floor():
    md = torch.zeros((2, 256), requires_grad=True)
    ids = torch.full((1, 128), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires grad"):
        cell_raster(torch.zeros((4, 16)), ids, torch.zeros(1, dtype=torch.int32), md,
                    0.1, 10.0, 1, 16, 1)
