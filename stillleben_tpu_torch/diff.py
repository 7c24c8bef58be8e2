"""Approximate differentiable rendering: image gradients chained to poses,
vertices and colours.

Counterpart of ``stillleben_tpu/diff.py`` (reference
python/stillleben/diff.py and its CUDA kernels python/src/diff.cu), with
the same functions and signatures:

- ``gaussian_kernel(l, sig)`` (diff.py:49-58);
- ``compute_image_space_gradients(scene, render_result)`` (diff.py:73-127):
  central differences of the RGB image scaled by W/4 and H/4, zero at
  occlusion boundaries;
- ``generate_sobel_valid_mask(instance, depth)`` (diff.cu:13-99): a pixel
  is invalid where a 3x3 neighbour belongs to another, closer object;
- ``dilate_object_mask(mask, sobel_valid, coordinates)`` (diff.cu:101-193):
  the mask grown by one pixel into all-valid neighbourhoods, with a
  neighbouring object pixel's coordinates;
- ``backpropagate_gradient_to_poses(scene, result, dL_dI)`` -> (N, 6)
  (diff.py:355-523): dL/dI -> image gradients -> d(screen xy)/d(camera
  point) from P by the quotient rule -> d(point)/d(pose) by the 6 so(3) +
  translation generators around the pose T0, per object;
- ``bp_to_vertices_and_colors(scene, result, dL_dI)`` (diff.py:215-352):
  the same chain in object space, spread over the winning triangle's
  (1-based) vertex ids by the barycentrics, and the colour gradients; both
  negated, as the reference does;
- ``soft_forward(scene, results, obs_rgb, loss_fn)`` (diff.py:130-213): up
  to 5 depth-peeled layers blended with weights (0.7, 0.3, 0.1, 0.1,
  0.05), blurred by an 11x11 Gaussian of sigma 1, the loss and its
  gradient by autograd, then per layer ``bp_to_vertices_and_colors``;
- ``apply_pose_delta(pose, delta, orthonormalize=True)`` (diff.py:525-590):
  ``T0 @ (I + [delta])`` with SVD re-orthonormalization, batched.

As in the reference, an object's ``pose()`` is taken as its camera-frame
pose and ``scene.projection_matrix()`` maps it to the screen: the chain
holds for a scene whose camera sits at the origin (the reference's tests
set it so); express a scene in the camera frame before calling it.

Inputs are tensors, numpy arrays or a ``RenderPassResult``; outputs are
tensors on the result's device (for functions without a result, the first
tensor input's, else the context's: the card unless ``init(device="cpu")``).
Lists stay lists. Nothing here runs a raster: the chain reads the render's
buffers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .core import math as _m

KS = 11  # Gaussian kernel size of soft_forward (reference diff.py:65)
DB_WEIGHTS = (0.7, 0.3, 0.1, 0.1, 0.05)  # depth-peel blend weights


def _device(*xs) -> torch.device:
    """The device of the first tensor among ``xs`` (a render result counts
    by its buffers), else the context's."""
    for x in xs:
        if callable(getattr(x, "rgb", None)):
            x = x.rgb()
        if isinstance(x, torch.Tensor):
            return x.device
    from .context import context

    return context().device


def _as_t(x, device, dtype=torch.float32) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def gaussian_kernel(l: int = 5, sig: float = 1.0, device=None) -> torch.Tensor:
    """(l, l) 2D Gaussian, summing to 1 (reference diff.py:49-58)."""
    ax = np.arange(-l // 2 + 1.0, l // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    kernel = np.exp(-(xx**2 + yy**2) / (2.0 * sig**2))
    return _as_t(kernel / kernel.sum(), _device() if device is None else torch.device(device))


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``img[y + dy, x + dx]`` with the indices clamped to the image, as
    the CUDA kernels clamp at the borders."""
    H, W = img.shape[:2]
    ys = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
    return img[ys][:, xs]


def generate_sobel_valid_mask(instance_index, depth) -> torch.Tensor:
    """(H, W) bool; False at occlusion boundaries (diff.cu:13-99)."""
    dev = _device(instance_index, depth)
    inst = _as_t(instance_index, dev, torch.int32)
    d = _as_t(depth, dev)
    invalid = torch.zeros(inst.shape, dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ni = _shift(inst, dy, dx)
            invalid |= (ni != inst) & (ni != 0) & (_shift(d, dy, dx) < d)
    invalid &= inst != 0  # background pixels stay valid
    return ~invalid


def _rgb_planes(render_result, dev) -> torch.Tensor:
    """The result's RGB as (3, H, W) float32 in [0, 1]."""
    return _as_t(render_result.rgb()[..., :3], dev).permute(2, 0, 1) / 255.0


def compute_image_space_gradients(scene, render_result):
    """-> (grad_x (3, H, W), grad_y (3, H, W), sobel_valid_mask (H, W))
    (reference diff.py:73-127)."""
    dev = _device(render_result)
    img = _rgb_planes(render_result, dev)
    H, W = img.shape[1:]
    # grad_x[y, x] = (I[y, x-1] - I[y, x+1]) * W/4 with zero padding: the
    # reference's negated convolution with [-1, 0, 1] * W/4
    left = F.pad(img, (1, 0))[:, :, :-1]
    right = F.pad(img, (0, 1))[:, :, 1:]
    grad_x = (left - right) * (W / 4.0)
    up = F.pad(img, (0, 0, 1, 0))[:, :-1, :]
    down = F.pad(img, (0, 0, 0, 1))[:, 1:, :]
    grad_y = (up - down) * (H / 4.0)
    mask = generate_sobel_valid_mask(render_result.instance_index(), render_result.depth())
    zero = torch.zeros((), device=dev)
    return torch.where(mask[None], grad_x, zero), torch.where(mask[None], grad_y, zero), mask


def dilate_object_mask(object_mask, sobel_valid_mask, coordinates):
    """Grow the object mask by one pixel into fully valid neighbourhoods,
    copying a neighbouring object pixel's coordinates (diff.cu:101-193).
    -> (dilated mask (H, W) bool, dilated coordinates (H, W, 3))."""
    dev = _device(object_mask, sobel_valid_mask, coordinates)
    mask = _as_t(object_mask, dev, torch.bool)
    valid = _as_t(sobel_valid_mask, dev, torch.bool)
    coords = _as_t(coordinates, dev)
    any_obj = torch.zeros_like(mask)
    all_valid = torch.ones_like(mask)
    neigh_coords = coords
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nm = _shift(mask, dy, dx)
            any_obj = any_obj | nm
            all_valid = all_valid & _shift(valid, dy, dx)
            neigh_coords = torch.where(nm[..., None], _shift(coords, dy, dx), neigh_coords)
    grow = ~mask & any_obj & all_valid
    return mask | grow, torch.where(grow[..., None], neigh_coords, coords)


def _pose_generators(dtype=torch.float32, device=None) -> torch.Tensor:
    """The 6 so(3) + translation generator matrices (diff.py:449-467)."""
    G = np.zeros((6, 4, 4), np.float32)
    G[0, 1, 2], G[0, 2, 1] = -1, 1  # alpha
    G[1, 0, 2], G[1, 2, 0] = 1, -1  # beta
    G[2, 0, 1], G[2, 1, 0] = -1, 1  # gamma
    G[3, 0, 3] = 1  # a
    G[4, 1, 3] = 1  # b
    G[5, 2, 3] = 1  # c
    return _as_t(G, _device() if device is None else torch.device(device), dtype)


def backpropagate_gradient_to_poses(
    scene, render_result, grad_objective_wrt_rnd_img, visualize_grad: bool = False
) -> torch.Tensor:
    """-> (N, 6) gradient of the objective with respect to the N object
    poses (reference diff.py:355-523; its docstring has the local
    linearization T(delta) = T0 (I + [delta])). ``grad_objective_wrt_rnd_img``
    is (3, H, W)."""
    dev = _device(render_result)
    grad_in = _as_t(grad_objective_wrt_rnd_img, dev)  # (3, H, W)
    coordinates = _as_t(render_result.coordinates(), dev)  # (H, W, 3)
    inst = _as_t(render_result.instance_index(), dev, torch.int32)
    P = _as_t(scene.projection_matrix(), dev)

    grad_x, grad_y, sobel_valid = compute_image_space_gradients(scene, render_result)
    g_xy = torch.stack([grad_x, grad_y], -1).permute(1, 2, 0, 3)  # (H, W, 3, 2)
    G = _pose_generators(device=dev)

    out = torch.zeros((len(scene.objects), 6), device=dev)
    for idx, obj in enumerate(scene.objects):
        object_mask, obj_coords = dilate_object_mask(
            inst == obj.instance_index, sobel_valid, coordinates
        )
        if not bool(object_mask.any()):
            print("object_mask is empty")
            print("This could happen if the object is out of field of view")
            continue
        T0 = _as_t(obj.pose(), dev)
        x = torch.cat([obj_coords, torch.ones_like(obj_coords[..., :1])], -1)  # (H, W, 4)
        y = x @ T0.T  # camera-frame points

        # d(screen xy)/d(3D point) by the quotient rule (diff.py:435-443):
        # gc[j, i] = P[j, i] / (P2 y) - P[2, i] (Pj y) / (P2 y)^2
        Py = y @ P.T  # (H, W, 4)
        w_clip = Py[..., 2]
        inv_w = 1.0 / torch.where(w_clip.abs() < 1e-12, torch.full_like(w_clip, 1e-12), w_clip)
        inv_w = inv_w[..., None, None]
        gc = P[:2, :3] * inv_w - P[2:3, :3] * (Py[..., :2, None] * inv_w**2)  # (H, W, 2, 3)

        # d(3D)/d(pose parameters): T0 @ G_k @ x (diff.py:445-483)
        gp = torch.einsum("ij,kjl,hwl->hwik", T0[:3], G, x)  # (H, W, 3, 6)
        chain = g_xy @ gc @ gp  # (H, W, 3, 6)
        chain = torch.where(object_mask[..., None, None], chain, torch.zeros((), device=dev))
        out[idx] = torch.einsum("chw,hwck->k", grad_in, chain)
    return out


def bp_to_vertices_and_colors(
    scene, render_result, grad_objective_wrt_rnd_img, visualize_grad: bool = False
):
    """-> (vertex_index list, grad_vertices list, grad_colors list), one
    entry per object in view (reference diff.py:215-352). The gradients are
    negated as in the reference ("take small step in the opposite
    direction")."""
    dev = _device(render_result)
    grad_in = _as_t(grad_objective_wrt_rnd_img, dev)  # (3, H, W)
    coordinates = _as_t(render_result.coordinates(), dev)
    inst = _as_t(render_result.instance_index(), dev, torch.int32)
    bcfs = _as_t(render_result.barycentric_coeffs(), dev)  # (H, W, 3)
    vidx = _as_t(render_result.vertex_indices(), dev, torch.int32)
    P = _as_t(scene.projection_matrix(), dev)

    grad_x, grad_y, _ = compute_image_space_gradients(scene, render_result)
    g_2d = torch.stack([grad_x, grad_y], 0).reshape(2, 3, -1)  # (2, 3, HW)
    x_all = torch.cat([coordinates, torch.ones_like(coordinates[..., :1])], -1).reshape(-1, 4)

    vertex_index_out, grad_vertices_out, grad_colors_out = [], [], []
    for obj in scene.objects:
        sel = (inst == obj.instance_index).reshape(-1)
        if not bool(sel.any()):
            print("instance_index image for the current object is empty")
            print("object not rendered as a part of the scene")
            continue
        x = x_all[sel]  # (p, 4) object-frame coordinates
        PT = P @ _as_t(obj.pose(), dev)  # rows 0..2 used
        Px = x @ PT[:3].T  # (p, 3)
        denom = Px[:, 2:3] ** 2
        # d(screen)/d(object point) by the quotient rule (diff.py:296-310)
        g2d3d = (
            Px[:, 2:3, None] * PT[None, :2, :3] - Px[:, :2, None] * PT[None, 2:3, :3]
        ) / denom[..., None]  # (p, 2, 3)
        g_img_2d = g_2d[:, :, sel].permute(2, 1, 0)  # (p, 3, 2)
        g_loss_img = grad_in.reshape(3, -1)[:, sel].T[:, None, :]  # (p, 1, 3)
        g_loss_3d = g_loss_img @ (g_img_2d @ g2d3d)  # (p, 1, 3)
        b = bcfs.reshape(-1, 3)[sel][..., None]  # (p, 3, 1)
        grad_vertices = (b @ g_loss_3d).reshape(-1, 3)  # (3p, 3)
        grad_colors = (b @ g_loss_img).reshape(-1, 3)
        vertex_index_out.append(vidx.reshape(-1, 3)[sel].reshape(-1))
        grad_vertices_out.append(-grad_vertices)
        grad_colors_out.append(-grad_colors)
    return vertex_index_out, grad_vertices_out, grad_colors_out


def soft_forward(scene, render_result, obs_rgb, loss_fn):
    """Soft occlusion-aware forward over depth-peeled layers (reference
    diff.py:130-213). ``render_result`` is a list of results, the first
    layer first; ``obs_rgb`` (3, H, W) in [0, 1]; ``loss_fn(pred, target)``
    takes (1, 3, H, W) images and returns (loss, loss image). Returns
    (soft_rgb (3, H, W), rgbs list, loss_img, loss, vertex_index list,
    grad_vertices list, grad_colors list)."""
    if not isinstance(render_result, (list, tuple)):
        raise ValueError("render_result should be a list or tuple")
    dev = _device(render_result[0])
    obs = _as_t(obs_rgb, dev)
    if obs.dim() != 3 or obs.shape[0] != 3:
        raise ValueError("Observed RGB should be CxHxW with C=3")
    if float(obs.max()) > 1.0:
        raise ValueError("Observed RGB should have range [0,1]")

    rgbs = torch.stack([_rgb_planes(rr, dev) for rr in render_result]).requires_grad_(True)
    weights = _as_t(DB_WEIGHTS[: rgbs.shape[0]], dev)
    # convolve2d(mode="same") is a correlation with the flipped kernel,
    # padded by half its size
    kernel = torch.flip(gaussian_kernel(KS, 1.0, dev), (0, 1))[None, None]

    with torch.enable_grad():
        soft = (rgbs * weights[:, None, None, None]).sum(0)  # (3, H, W)
        blurred = F.conv2d(soft[:, None], kernel, padding=KS // 2)[:, 0]
        loss, loss_img = loss_fn(blurred[None], obs[None])
        (grads,) = torch.autograd.grad(loss, rgbs)

    vertex_index_2_bp, grad_vertices_2_bp, grad_colors_2_bp = [], [], []
    for ir, rr in enumerate(render_result):
        vi, gv, gc = bp_to_vertices_and_colors(scene, rr, grads[ir])
        vertex_index_2_bp += vi
        grad_vertices_2_bp += gv
        grad_colors_2_bp += gc
    return (
        soft.detach(),
        list(rgbs.detach()),
        loss_img,
        float(loss.detach()),
        vertex_index_2_bp,
        grad_vertices_2_bp,
        grad_colors_2_bp,
    )


def apply_pose_delta(pose, delta, orthonormalize: bool = True) -> torch.Tensor:
    """``T0 @ (I + [delta])`` with the rotation re-orthonormalized by SVD
    (``core.math.orthonormalize``), batched over a leading axis
    (reference diff.py:525-590)."""
    dev = _device(pose, delta)
    pose = _as_t(pose, dev)
    delta = _as_t(delta, dev)
    batched = pose.dim() == 3
    if not batched:
        pose, delta = pose[None], delta[None]
    a, b, g, x, y, z = delta.unbind(-1)
    ones, zeros = torch.ones_like(a), torch.zeros_like(a)
    D = torch.stack([
        torch.stack([ones, -g, b, x], -1),
        torch.stack([g, ones, -a, y], -1),
        torch.stack([-b, a, ones, z], -1),
        torch.stack([zeros, zeros, zeros, ones], -1),
    ], -2)
    new_poses = pose @ D
    if orthonormalize:
        R = _m.orthonormalize(new_poses[:, :3, :3])
        new_poses = torch.cat([torch.cat([R, new_poses[:, :3, 3:]], -1), new_poses[:, 3:]], -2)
    return new_poses if batched else new_poses[0]
