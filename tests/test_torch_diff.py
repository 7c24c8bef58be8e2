"""``sl.diff`` and ``sl.losses`` of the port against the JAX package's on
the CPU.

The fixture is ``tests/test_diff.py``'s with the in-repo textured blob in
place of the absent bunny: one object at 128x128 in front of the camera
(tilted 0.5 about y and 0.4 about x, 0.8 m away), ambient light only and a
fixed exposure, rendered by each package's own ``RenderPass(ssao=False)``.

- Every diff function of both packages on the same numpy inputs, the
  buffers of one JAX render (and of its depth-peel pass): masks and vertex
  ids equal, the float results within 1e-5 relative to their largest
  magnitude (the order of float32 sums differs).
- ``test_diff.py``'s unit tests for the port: the Sobel occlusion boundary,
  the dilation, the kernel width and the ``apply_pose_delta`` round trip,
  each also against the JAX function.
- The 6-direction test of the reference (tests/test_grad.py:125-153): the
  pose perturbed by +0.01 in one parameter, the gradient of a blurred L2
  image loss chained to the pose; each package through its own renders.
  A positive component means a step along -grad walks back to the
  ground truth. Every component must be positive in the port wherever it
  is in the JAX package, and have the JAX package's sign elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import stillleben_tpu as jsl
import stillleben_tpu_torch as sl
from stillleben_tpu import diff as jdiff
from stillleben_tpu.losses import neg_iou_loss as jax_neg_iou
from stillleben_tpu_torch import diff as pdiff
from stillleben_tpu_torch.assets.procedural import write_meshes
from stillleben_tpu_torch.losses import neg_iou_loss
from torch_port_scene import image_loss_grad

SIZE = 128
ACCESSORS = ("rgb", "instance_index", "depth", "coordinates", "barycentric_coeffs",
             "vertex_indices")


def _pose():
    a, b = 0.5, 0.4
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = [0.0, 0.0, 0.8]
    return T


def _fill(scene, mesh_cls, object_cls, path):
    mesh = mesh_cls(path, physics=False)
    mesh.center_bbox()
    mesh.scale_to_bbox_diagonal(0.3)
    scene.add_object(object_cls(mesh))
    scene.objects[0].set_pose(_pose())
    scene.light_colors = np.zeros((1, 3), np.float32)
    scene.ambient_light = [1.0, 1.0, 1.0]
    scene.manual_exposure = 1.0
    return scene


class Buffers:
    """A render result of numpy buffers (``torch=True``: CPU tensors)."""

    def __init__(self, result, torch_tensors=False):
        for name in ACCESSORS:
            a = np.array(getattr(result, name)())
            if a.dtype == np.uint16:
                a = a.astype(np.int32)
            setattr(self, "_" + name, torch.from_numpy(a) if torch_tensors else a)

    def __getattr__(self, name):
        if name in ACCESSORS:
            return lambda: self.__dict__["_" + name]
        raise AttributeError(name)


def jax_image_loss_grad(img, target):
    """dL/dI (3, H, W) of 0.5 |blur(I) - blur(T)|^2 with the 5x5 Gaussian
    (tests/test_diff.py::_image_loss_grad)."""
    kernel = jdiff.gaussian_kernel(5, 1.0)

    def blur(x):
        return jax.vmap(lambda c: jax.scipy.signal.convolve2d(c, kernel, mode="same"))(
            x.transpose(2, 0, 1))

    return jax.grad(lambda i: 0.5 * jnp.sum((blur(i) - blur(target)) ** 2))(img).transpose(2, 0, 1)


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """Both packages' scenes, and each package's 6-direction run: per
    parameter the perturbed render and the gradient chained to the pose."""
    sl.init(device="cpu")
    d = str(tmp_path_factory.mktemp("meshes"))
    path = write_meshes(d, subdiv=3)["blob_textured"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STILLLEBEN_TPU_MESH_CACHE", d)
        js = _fill(jsl.Scene((SIZE, SIZE)), jsl.Mesh, jsl.Object, path)
        ps = _fill(sl.Scene((SIZE, SIZE)), sl.Mesh, sl.Object, path)
    js.seed(21)
    jrp, prp = jsl.RenderPass(ssao=False), sl.RenderPass(ssao=False)
    gt = js.objects[0].pose()
    jgt = jnp.asarray(np.asarray(jrp.render(js).rgb())[..., :3], jnp.float32) / 255.0
    pgt = prp.render(ps).rgb()[..., :3].float() / 255.0
    runs = {"jax": [], "port": []}
    for k in range(6):
        delta = np.zeros(6, np.float32)
        delta[k] = 0.01
        js.objects[0].set_pose(np.asarray(jdiff.apply_pose_delta(gt, delta)))
        ps.objects[0].set_pose(pdiff.apply_pose_delta(torch.from_numpy(gt), torch.from_numpy(delta))
                               .numpy())
        jr = jrp.render(js)
        jimg = jnp.asarray(np.asarray(jr.rgb())[..., :3], jnp.float32) / 255.0
        jdl = jax_image_loss_grad(jimg, jgt)
        runs["jax"].append((jr, np.asarray(jdl),
                            np.asarray(jdiff.backpropagate_gradient_to_poses(js, jr, jdl))))
        pr = prp.render(ps)
        pdl = image_loss_grad(pr.rgb()[..., :3].float() / 255.0, pgt)
        runs["port"].append((pr, pdl, pdiff.backpropagate_gradient_to_poses(ps, pr, pdl).numpy()))
    js.objects[0].set_pose(gt)
    peel = jrp.render(js, depth_peel=runs["jax"][0][0])
    return js, ps, runs, peel


def test_gradient_direction_all_six_params(blob):
    """Each package's own 6-direction run (reference test_grad.py:125-153)."""
    _, _, runs, _ = blob
    gj = np.array([runs["jax"][k][2][0, k] for k in range(6)])
    gp = np.array([runs["port"][k][2][0, k] for k in range(6)])
    print("JAX components", gj, "port components", gp)
    assert np.isfinite(gp).all()
    # positive wherever the JAX package's is, the JAX sign elsewhere
    np.testing.assert_array_equal(np.sign(gp), np.sign(gj))
    assert (gj > 0).sum() >= 5, f"the JAX package descends on only {(gj > 0).sum()} of 6"


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("k", [0, 5])
def test_diff_functions_match_jax(blob, k):
    """Both packages' diff functions on the buffers of JAX's render
    perturbed in parameter ``k`` and its dL/dI."""
    js, ps, runs, _ = blob
    jr, jdl, _ = runs["jax"][k]
    jb, pb = Buffers(jr), Buffers(jr, torch_tensors=True)
    ps.objects[0].set_pose(js.objects[0].pose())
    pdl = torch.from_numpy(np.array(jdl))

    jm = np.asarray(jdiff.generate_sobel_valid_mask(jb.instance_index(), jb.depth()))
    pm = pdiff.generate_sobel_valid_mask(pb.instance_index(), pb.depth())
    assert pm.dtype == torch.bool and pm.device.type == "cpu"
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert (~jm).sum() == 0  # one object: no occlusion boundary

    for a, b in zip(pdiff.compute_image_space_gradients(ps, pb),
                    jdiff.compute_image_space_gradients(js, jb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    obj = jb.instance_index() == js.objects[0].instance_index
    jdm, jdc = jdiff.dilate_object_mask(obj, jm, jb.coordinates())
    pdm, pdc = pdiff.dilate_object_mask(torch.from_numpy(obj), pm, pb.coordinates())
    np.testing.assert_array_equal(pdm.numpy(), np.asarray(jdm))
    np.testing.assert_array_equal(pdc.numpy(), np.asarray(jdc))
    assert pdm.sum() > obj.sum()

    gj = np.asarray(jdiff.backpropagate_gradient_to_poses(js, jb, jdl))
    gp = pdiff.backpropagate_gradient_to_poses(ps, pb, pdl)
    assert gp.shape == (1, 6) and gp.device.type == "cpu"
    _close(gp.numpy(), gj)

    jvi, jgv, jgc = jdiff.bp_to_vertices_and_colors(js, jb, jdl)
    pvi, pgv, pgc = pdiff.bp_to_vertices_and_colors(ps, pb, pdl)
    assert len(pvi) == len(jvi) == 1
    np.testing.assert_array_equal(pvi[0].numpy(), jvi[0])
    assert pvi[0].min() >= 1  # 1-based vertex ids
    _close(pgv[0].numpy(), jgv[0])
    _close(pgc[0].numpy(), jgc[0])


def test_soft_forward_matches_jax(blob):
    """Two layers (the render and its depth-peel pass) with neg_iou_loss."""
    js, ps, runs, peel = blob
    r0 = runs["jax"][0][0]
    ps.objects[0].set_pose(js.objects[0].pose())
    obs = np.asarray(runs["jax"][5][0].rgb())[..., :3].astype(np.float32).transpose(2, 0, 1) / 255.0
    jout = jdiff.soft_forward(js, [Buffers(r0), Buffers(peel)], obs, jax_neg_iou)
    pout = pdiff.soft_forward(ps, [Buffers(r0, True), Buffers(peel, True)],
                              torch.from_numpy(obs), neg_iou_loss)
    soft, rgbs, loss_img, loss, vi, gv, gc = pout
    assert isinstance(rgbs, list) and len(rgbs) == 2 and soft.shape == (3, SIZE, SIZE)
    _close(soft.numpy(), jout[0])
    for a, b in zip(rgbs, jout[1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(loss_img.numpy(), jout[2])
    # the loss sums 49,152 products: against the float64 value of the same
    # blurred image 1e-6 relative; XLA's float32 sum on the CPU is ~1e-4 off
    blurred = F.conv2d(soft.double()[:, None],
                       torch.flip(pdiff.gaussian_kernel(11, 1.0, "cpu"), (0, 1)).double()[None, None],
                       padding=5)[:, 0].numpy()
    o = obs.astype(np.float64)
    loss64 = 1.0 - (blurred * o).sum() / ((blurred + o - blurred * o).sum() + 1e-6)
    assert abs(loss - loss64) <= 1e-6 * loss64
    assert abs(loss - jout[3]) <= 2e-4 * abs(jout[3])
    assert len(vi) == len(jout[4]) >= 1
    for a, b in zip(vi, jout[4]):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(gv + gc, jout[5] + jout[6]):
        _close(a.numpy(), b, rel=1e-4)


def test_neg_iou_loss_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.random((2, 3, 16, 20), dtype=np.float32)
    b = rng.random((2, 3, 16, 20), dtype=np.float32)
    ta = torch.from_numpy(a).requires_grad_(True)
    loss, img = neg_iou_loss(ta, torch.from_numpy(b))
    jloss, jimg = jax_neg_iou(a, b)
    assert abs(float(loss) - float(jloss)) <= 1e-6
    _close(img.numpy(), jimg)
    assert not img.requires_grad  # the loss image is detached, as stop_gradient
    (g,) = torch.autograd.grad(loss, ta)
    jg = jax.grad(lambda x: jax_neg_iou(x, b)[0])(jnp.asarray(a))
    _close(g.numpy(), jg)


def test_sobel_valid_mask_occlusion_boundary():
    inst = np.zeros((8, 8), np.int32)
    depth = np.full((8, 8), 3000.0, np.float32)
    inst[2:6, 2:6] = 1
    depth[2:6, 2:6] = 2.0
    inst[3:5, 3:5] = 2  # a closer object in front
    depth[3:5, 3:5] = 1.0
    mask = pdiff.generate_sobel_valid_mask(torch.from_numpy(inst), torch.from_numpy(depth))
    assert not mask[2, 2]  # a diagonal neighbour of object 2 at (3, 3)
    assert mask[3, 3]  # the closer object stays valid
    assert mask[0, 0]  # background stays valid
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jdiff.generate_sobel_valid_mask(inst, depth)))


def test_dilate_object_mask():
    mask = np.zeros((6, 6), bool)
    mask[2:4, 2:4] = True
    valid = np.ones((6, 6), bool)
    coords = np.zeros((6, 6, 3), np.float32)
    coords[2:4, 2:4] = 5.0
    out_mask, out_coords = pdiff.dilate_object_mask(
        torch.from_numpy(mask), torch.from_numpy(valid), torch.from_numpy(coords))
    assert out_mask[1, 1] and out_mask[4, 4]  # grown by 1 px
    assert not out_mask[0, 0]
    assert (out_coords[1, 2] == 5.0).all()  # a neighbouring object pixel's coordinates
    jm, jc = jdiff.dilate_object_mask(mask, valid, coords)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(out_coords.numpy(), np.asarray(jc))


def test_soft_forward_kernel_width():
    assert pdiff.KS == jdiff.KS == 11  # the reference's 11x11 sigma=1 (diff.py:65)
    assert pdiff.DB_WEIGHTS == jdiff.DB_WEIGHTS
    k = pdiff.gaussian_kernel(pdiff.KS, 1.0, "cpu")
    assert k.shape == (11, 11) and k.dtype == torch.float32
    assert abs(float(k.sum()) - 1.0) < 1e-6
    np.testing.assert_array_equal(k.numpy(), np.asarray(jdiff.gaussian_kernel(11, 1.0)))
    np.testing.assert_array_equal(pdiff._pose_generators(device="cpu").numpy(),
                                  np.asarray(jdiff._pose_generators()))


def test_apply_pose_delta_roundtrip():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, 0.2, 0.3]
    delta = np.array([0.02, -0.01, 0.03, 0.001, -0.002, 0.004], np.float32)
    out = pdiff.apply_pose_delta(torch.from_numpy(pose), torch.from_numpy(delta))
    R = out[:3, :3].numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)  # stays orthonormal
    np.testing.assert_allclose(out[:3, 3].numpy(), pose[:3, 3] + delta[3:], atol=1e-6)
    out_b = pdiff.apply_pose_delta(torch.from_numpy(np.stack([pose, _pose()])),
                                   torch.from_numpy(np.stack([delta, -delta])))
    assert out_b.shape == (2, 4, 4)
    np.testing.assert_allclose(out_b[0].numpy(), out.numpy(), atol=1e-6)
    jb = np.asarray(jdiff.apply_pose_delta(np.stack([pose, _pose()]), np.stack([delta, -delta])))
    np.testing.assert_allclose(out_b.numpy(), jb, atol=2e-6)
    raw = pdiff.apply_pose_delta(torch.from_numpy(pose), torch.from_numpy(delta), False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jdiff.apply_pose_delta(pose, delta, False)),
                               atol=1e-7)


def test_object_annotations_match_jax(blob):
    """Per-object annotations of both packages on their own renders of the
    same state; the solo re-renders go through each ``RenderPass``'s
    predicate. Pixel counts within 0.5% (the two rasters may split an
    edge pixel differently), the bbox within a pixel."""
    js, ps, _, _ = blob
    ps.objects[0].set_pose(js.objects[0].pose())
    ja = jsl.object_annotations(js, jsl.RenderPass(ssao=False).render(js))
    pa = sl.object_annotations(ps, sl.RenderPass(ssao=False).render(ps))
    assert len(pa) == len(ja) == 1
    a, b = pa[0], ja[0]
    assert a["instance_index"] == b["instance_index"] and a["class_index"] == b["class_index"]
    np.testing.assert_array_equal(a["pose"], b["pose"])
    np.testing.assert_allclose(a["cam_pose"], b["cam_pose"], atol=1e-6)
    assert a["px_count_visib"] > 300
    for key in ("px_count_visib", "px_count_all"):
        assert abs(a[key] - b[key]) <= 0.005 * b[key], (key, a[key], b[key])
    assert np.abs(np.array(a["bbox"]) - np.array(b["bbox"])).max() <= 1
    assert abs(a["visib_fract"] - b["visib_fract"]) <= 0.01


def test_render_debug_image_matches_jax(blob):
    """The axes overlay: the pixels each package draws over its render,
    equal on >= 99% of them, and the image a uint8 tensor."""
    js, ps, _, _ = blob
    ps.objects[0].set_pose(js.objects[0].pose())
    pimg = sl.render_debug_image(ps)
    jimg = np.asarray(jsl.render_debug_image(js))
    assert pimg.dtype == torch.uint8 and pimg.shape == (SIZE, SIZE, 4)
    plain_p = sl.RenderPass(ssao=False).render(ps).rgb().numpy()
    plain_j = np.asarray(jsl.RenderPass(ssao=False).render(js).rgb())
    drawn_p = (pimg.numpy() != plain_p).any(-1)
    drawn_j = (jimg != plain_j).any(-1)
    assert drawn_j.sum() > 20
    assert (drawn_p == drawn_j).mean() >= 0.99 and (drawn_p & drawn_j).sum() >= 0.9 * drawn_j.sum()
