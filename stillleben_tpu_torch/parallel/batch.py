"""Batched datagen: B scenes from one template.

Counterpart of ``stillleben_tpu/parallel/batch.py`` (``SceneTemplate``,
``template_from_scene``, ``settle_scene``, ``render_with_poses``,
``apply_pose_delta_matrix``, ``generate_batch``, ``generate_stream``). Per
scene: stack objects -> settle (100 frames x 4 substeps, redrop) -> random
camera fit -> random light -> render -> full GT.

The settle runs the whole batch at once (the state carries a batch axis);
the render runs one scene after the other, because each scene's cell list
is data-dependent. The template carries the scene's background plane (one
more slot of the render atlas) and its image-based light map, which every
scene of the batch shares. Sharding is not ported.
"""

from __future__ import annotations

from collections import deque
from itertools import count
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..physics import tabletop as tt
from ..physics.contacts import Floor
from ..physics.types import BodyParams, HullAtlas, SolverConfig
from ..render.atlas import RenderInputs, SceneAtlas, build_scene_atlas, render_inputs_from_scene
from ..render.light_map import LightMapData
from ..render.frame import FrameConfig, RenderedFrame, render_frame_core
from ..scene.camera_fit import choose_random_camera_pose, choose_random_light_direction


class SceneTemplate(NamedTuple):
    """Everything static shared by the scenes of a batch."""

    hull_atlas: HullAtlas
    body_params: BodyParams
    pairs: torch.Tensor  # (NP, 2) candidate hull pairs
    tabletop_geom: tt.TabletopGeom
    floor: Floor
    render_atlas: SceneAtlas
    base_inputs: RenderInputs
    bbox_corners: torch.Tensor  # (NB, 8, 3) mesh-frame bbox corners
    base_z: torch.Tensor  # scalar
    light_map: LightMapData | None = None  # the image-based light of every scene


def template_from_scene(scene, device="cuda") -> SceneTemplate:
    """Build the template from a host ``scene.scene.Scene`` (batch.py:47-82):
    the background plane and the light map are carried along. The light
    map's own analytic lights are not read, as in the JAX template."""
    atlas, params, pairs, geom = scene._compile(device)
    all_dynamic = all(not o.static for o in scene.objects)
    bg_plane = None
    if np.any(scene.background_plane_size):
        tex = scene.background_plane_texture
        bg_plane = dict(size=scene.background_plane_size,
                        texture=tex.pixels if tex is not None else None)
    render_atlas = build_scene_atlas(scene.objects, device, background_plane=bg_plane)
    light_map = None
    if scene.light_map is not None:
        light_map = LightMapData(*(x.to(device) for x in scene.light_map.data))
    corners = np.zeros((max(len(scene.objects), 1), 8, 3), np.float32)
    for i, o in enumerate(scene.objects):
        corners[i] = o.mesh.bbox.corners()
    base_z = tt.FLOOR_TOP_Z if all_dynamic else tt.STACK_BASE_STATIC
    return SceneTemplate(
        hull_atlas=atlas,
        body_params=params,
        pairs=pairs,
        tabletop_geom=geom,
        floor=scene._default_floor(all_dynamic, device),
        render_atlas=render_atlas,
        base_inputs=render_inputs_from_scene(scene, render_atlas, device),
        bbox_corners=torch.from_numpy(corners).to(device),
        base_z=torch.tensor(base_z, dtype=torch.float32, device=device),
        light_map=light_map,
    )


def settle_scene(
    generator: torch.Generator,
    batch: int,
    tpl: SceneTemplate,
    solver_cfg: SolverConfig,
    settle_iterations: int = tt.MAX_ITERATIONS,
    quats: torch.Tensor | None = None,
):
    """Settle B scenes: returns (poses (B, NB, 4, 4), cam_pose (B, 4, 4),
    light_dir (B, 3)). ``quats`` (B, NB, 4) replaces the random initial
    orientations (batch.py:178-202)."""
    dev = tpl.base_z.device
    nb = tpl.tabletop_geom.diameter.shape[0]
    if quats is None:
        quats = m.random_quaternion((batch, nb), generator).to(dev)
    state = tt.stack_objects(tpl.tabletop_geom, tpl.base_z, quats)
    state = tt.settle(
        tpl.hull_atlas, tpl.body_params, state, tpl.floor, tpl.pairs,
        tpl.tabletop_geom, solver_cfg, iterations=settle_iterations,
    )
    poses = state.pose_matrix()
    n_phys = tpl.bbox_corners.shape[0]
    world_corners = (
        torch.einsum("bnij,ncj->bnci", poses[:, :n_phys, :3, :3], tpl.bbox_corners)
        + poses[:, :n_phys, None, :3, 3]
    ).reshape(batch, -1, 3)
    valid = torch.ones(world_corners.shape[:2], dtype=torch.bool, device=dev)
    cam_pose = choose_random_camera_pose(generator, tpl.base_inputs.projection, world_corners, valid)
    light_dir = choose_random_light_direction(generator, cam_pose)
    return poses, cam_pose, light_dir


def render_with_poses(
    tpl: SceneTemplate,
    poses: torch.Tensor,  # (NB_phys, 4, 4), may carry a gradient
    cam_pose: torch.Tensor,  # (4, 4)
    cfg: FrameConfig,
    light_dir: torch.Tensor | None = None,
) -> RenderedFrame:
    """Render one scene of the template at the given poses (batch.py:205-223):
    the differentiable hook of render-and-compare pose refinement. Under
    autograd the gradient reaches ``poses`` through the depth and
    barycentrics that shading recomputes; the z-buffers have none."""
    obj_to_world = tpl.base_inputs.obj_to_world.clone()
    n = min(poses.shape[0], obj_to_world.shape[0])
    obj_to_world[:n] = poses[:n]
    inputs = tpl.base_inputs._replace(obj_to_world=obj_to_world, cam_pose=cam_pose)
    if light_dir is not None:
        dirs = inputs.light_directions.clone()
        dirs[0] = light_dir
        inputs = inputs._replace(light_directions=dirs)
    return render_frame_core(tpl.render_atlas, inputs, cfg, light_map=tpl.light_map)


def apply_pose_delta_matrix(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``pose @ (I + [delta])`` with the so(3) + translation generators,
    ``delta`` = (alpha, beta, gamma, x, y, z), batched over any leading
    axes (batch.py:226-241): the local linearization of the reference's
    diff module (python/stillleben/diff.py:525-590)."""
    a, b, g, x, y, z = delta.unbind(-1)
    zeros = torch.zeros_like(a)
    D = torch.stack([
        torch.stack([zeros, -g, b, x], -1),
        torch.stack([g, zeros, -a, y], -1),
        torch.stack([-b, a, zeros, z], -1),
        torch.stack([zeros, zeros, zeros, zeros], -1),
    ], -2)
    return pose @ (torch.eye(4, dtype=pose.dtype, device=pose.device) + D)


def generate_batch(
    generator: torch.Generator,
    batch: int,
    tpl: SceneTemplate,
    cfg: FrameConfig,
    solver_cfg: SolverConfig,
    settle_iterations: int = tt.MAX_ITERATIONS,
) -> RenderedFrame:
    """B complete scenes (batch.py:130-175); every output field gets a
    leading batch axis."""
    poses, cams, lights = settle_scene(generator, batch, tpl, solver_cfg, settle_iterations)
    frames = [render_with_poses(tpl, poses[b], cams[b], cfg, lights[b]) for b in range(batch)]
    return RenderedFrame(*(torch.stack(fs) for fs in zip(*frames)))


def _to_host(out: dict, stream) -> tuple[dict, object]:
    """Queue the copy of each tensor of ``out`` to host memory: on CUDA
    into pinned buffers on ``stream``, after the work queued so far on the
    current stream; returns (host tensors, the copy's end event or None)."""
    first = next(iter(out.values()))
    if first.device.type != "cuda":
        return {k: v.clone() for k, v in out.items()}, None
    stream.wait_stream(torch.cuda.current_stream(first.device))
    with torch.cuda.stream(stream):
        host = {}
        for k, v in out.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


def generate_stream(
    tpl: SceneTemplate,
    cfg: FrameConfig,
    solver_cfg: SolverConfig,
    *,
    batch: int,
    n_batches: int | None = None,
    seed: int = 0,
    prefetch: int = 2,
    gt_fields: tuple[str, ...] | None = None,
    settle_iterations: int = tt.MAX_ITERATIONS,
):
    """Yields ``n_batches`` (None: without end) batches of ``batch`` scenes
    as numpy arrays (batch.py:324-409, without the mesh): batch k is
    ``generate_batch`` on one ``torch.Generator`` seeded with ``seed``,
    after batches 0..k-1.

    ``gt_fields``: the ``RenderedFrame`` fields to read back (None: all,
    yielded as a ``RenderedFrame``). With it each batch is a dict of numpy
    arrays, and float32 fields are narrowed to float16 on the device before
    the copy (uint8, uint16, int32 and bool fields pass unchanged); an
    unknown field raises ``ValueError``.

    Batch k + ``prefetch`` is issued before batch k is read back. Issuing a
    batch runs its settle and render on the host's side too (the settle
    loop and the compactions read sizes from the device), so what overlaps
    the next batches' device work is batch k's narrowing and its copy to
    pinned host memory on a copy stream of its own."""
    if gt_fields is not None:
        bad = set(gt_fields) - set(RenderedFrame._fields)
        if bad:
            raise ValueError(f"unknown gt_fields {sorted(bad)}")
    generator = torch.Generator().manual_seed(seed)
    dev = tpl.base_z.device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    pending: deque = deque()

    def fetch(entry):
        host, done, _ = entry  # the device tensors stay referenced until here
        if done is not None:
            done.synchronize()
        arrays = {k: v.numpy() for k, v in host.items()}
        return arrays if gt_fields is not None else RenderedFrame(**arrays)

    for _ in range(n_batches) if n_batches is not None else count():
        frames = generate_batch(generator, batch, tpl, cfg, solver_cfg, settle_iterations)
        if gt_fields is None:
            out = frames._asdict()
        else:
            out = {}
            for f in gt_fields:
                x = getattr(frames, f)
                out[f] = x.to(torch.float16) if x.dtype == torch.float32 else x
        host, done = _to_host(out, stream)
        pending.append((host, done, out))
        if len(pending) > prefetch:
            yield fetch(pending.popleft())
    while pending:
        yield fetch(pending.popleft())
