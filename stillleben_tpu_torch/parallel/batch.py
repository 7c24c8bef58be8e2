"""Batched datagen: B scenes from one template, on one device or sharded
over a device mesh.

Counterpart of ``stillleben_tpu/parallel/batch.py`` (``SceneTemplate``,
``template_from_scene``, ``settle_scene``, ``render_with_poses``,
``apply_pose_delta_matrix``, ``generate_batch``, ``make_device_mesh``,
``generate_batch_sharded``, ``generate_stream``). Per scene: stack objects
-> settle (100 frames x 4 substeps, redrop) -> random camera fit -> random
light -> render -> full GT.

A batch's random numbers are drawn first and apart (``draw_scenes``), in
the order the pipeline used to draw them; ``generate_from_draws`` does the
rest. The settle runs the whole batch at once (the state carries a batch
axis); the render runs one scene after the other, because each scene's
cell list is data-dependent, in groups of ``render_sub_batch`` scenes
written into outputs allocated once. The template carries the scene's
background plane (one more slot of the render atlas) and its image-based
light map, which every scene of the batch shares.

Scale-out (``generate_batch_sharded``): every process draws the whole
batch, and each of its mesh devices runs the whole pipeline on its rows
(``distributed.shard_keys``); no collective is issued and nothing is
gathered. A scene's settle depends on the size of the batch it settles in
(the products' rounding follows the shapes), so a shard equals
``generate_from_draws`` of its rows at its own size, not its rows of the
unsharded batch.
"""

from __future__ import annotations

import contextlib
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
from ..scene.camera_fit import (
    camera_uniforms, choose_random_camera_pose, choose_random_light_direction, light_normals,
)
from . import distributed
from .distributed import Mesh, make_hybrid_mesh, shard_keys


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


def template_from_scene(scene, device="cuda", shadow_proxy_target: int = 8192,
                        cull_closedness: float = 0.98) -> SceneTemplate:
    """Build the template from a host ``scene.scene.Scene`` (batch.py:47-82):
    the background plane and the light map are carried along. The light
    map's own analytic lights are not read, as in the JAX template.
    ``shadow_proxy_target`` and ``cull_closedness`` go to
    ``build_scene_atlas`` (the JAX package's ``SL_SHADOW_PROXY`` and
    ``SL_CULL_CLOSEDNESS``)."""
    atlas, params, pairs, geom = scene._compile(device)
    all_dynamic = all(not o.static for o in scene.objects)
    bg_plane = None
    if np.any(scene.background_plane_size):
        tex = scene.background_plane_texture
        bg_plane = dict(size=scene.background_plane_size,
                        texture=tex.pixels if tex is not None else None)
    render_atlas = build_scene_atlas(scene.objects, device, background_plane=bg_plane,
                                     shadow_proxy_target=shadow_proxy_target,
                                     cull_closedness=cull_closedness)
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


class SceneDraws(NamedTuple):
    """A batch's random numbers, drawn before the work: the stack's
    orientations, the camera's uniforms and the light's normals."""

    quats: torch.Tensor  # (B, NB, 4)
    cam_u: torch.Tensor  # (B, 2)
    light_r: torch.Tensor  # (B, 3)


def draw_scenes(generator: torch.Generator, batch: int, nb: int) -> SceneDraws:
    """The numbers of ``batch`` scenes of ``nb`` bodies, on the CPU, in the
    order the pipeline consumes them: the orientations, then the camera's
    uniforms, then the light's normals."""
    quats = m.random_quaternion((batch, nb), generator)
    return SceneDraws(quats, camera_uniforms(batch, generator), light_normals(batch, generator))


def settle_draws(draws: SceneDraws, tpl: SceneTemplate, solver_cfg: SolverConfig,
                 settle_iterations: int = tt.MAX_ITERATIONS):
    """Settle the scenes of ``draws``: (poses (B, NB, 4, 4), cam_pose (B, 4,
    4), light_dir (B, 3)) on the template's device (batch.py:178-202)."""
    dev = tpl.base_z.device
    quats = draws.quats.to(dev)
    batch = quats.shape[0]
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
    cam_pose = choose_random_camera_pose(draws.cam_u, tpl.base_inputs.projection, world_corners,
                                         valid)
    light_dir = choose_random_light_direction(draws.light_r, cam_pose)
    return poses, cam_pose, light_dir


def settle_scene(
    generator: torch.Generator,
    batch: int,
    tpl: SceneTemplate,
    solver_cfg: SolverConfig,
    settle_iterations: int = tt.MAX_ITERATIONS,
    quats: torch.Tensor | None = None,
):
    """Settle B scenes drawn from ``generator``: returns (poses (B, NB, 4,
    4), cam_pose (B, 4, 4), light_dir (B, 3)). ``quats`` (B, NB, 4) replaces
    the random initial orientations (batch.py:178-202)."""
    if quats is None:
        draws = draw_scenes(generator, batch, tpl.tabletop_geom.diameter.shape[0])
    else:
        draws = SceneDraws(quats, camera_uniforms(batch, generator),
                           light_normals(batch, generator))
    return settle_draws(draws, tpl, solver_cfg, settle_iterations)


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


def _check_sub_batch(render_sub_batch: int) -> None:
    if render_sub_batch < 1:
        raise ValueError(f"render_sub_batch {render_sub_batch} < 1")


def render_batch(tpl: SceneTemplate, poses: torch.Tensor, cams: torch.Tensor,
                 lights: torch.Tensor, cfg: FrameConfig, render_sub_batch: int = 8) -> RenderedFrame:
    """Render B settled scenes in groups of ``min(render_sub_batch, B)``
    (batch.py:136-171) into outputs of shape (B, ...) allocated once; each
    group's frames are released before the next group renders, so the
    render holds the outputs and one group. The frames do not depend on
    the group size."""
    _check_sub_batch(render_sub_batch)
    B = poses.shape[0]
    sub = min(render_sub_batch, B)
    out = None
    for g0 in range(0, B, sub):
        group = [render_with_poses(tpl, poses[b], cams[b], cfg, lights[b])
                 for b in range(g0, min(g0 + sub, B))]
        if out is None:
            out = RenderedFrame(*(torch.empty((B,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                                  for x in group[0]))
        for i, frame in enumerate(group):
            for o, x in zip(out, frame):
                o[g0 + i].copy_(x)
        del group
    return out


def generate_from_draws(
    draws: SceneDraws,
    tpl: SceneTemplate,
    cfg: FrameConfig,
    solver_cfg: SolverConfig,
    settle_iterations: int = tt.MAX_ITERATIONS,
    render_sub_batch: int = 8,
) -> RenderedFrame:
    """The scenes of ``draws`` settled together and rendered in groups of
    ``render_sub_batch``; every output field gets a leading batch axis."""
    _check_sub_batch(render_sub_batch)
    poses, cams, lights = settle_draws(draws, tpl, solver_cfg, settle_iterations)
    return render_batch(tpl, poses, cams, lights, cfg, render_sub_batch)


def generate_batch(
    generator: torch.Generator,
    batch: int,
    tpl: SceneTemplate,
    cfg: FrameConfig,
    solver_cfg: SolverConfig,
    settle_iterations: int = tt.MAX_ITERATIONS,
    render_sub_batch: int = 8,
) -> RenderedFrame:
    """B complete scenes (batch.py:130-175): ``draw_scenes``, then
    ``generate_from_draws``; every output field gets a leading batch axis."""
    _check_sub_batch(render_sub_batch)
    draws = draw_scenes(generator, batch, tpl.tabletop_geom.diameter.shape[0])
    return generate_from_draws(draws, tpl, cfg, solver_cfg, settle_iterations, render_sub_batch)


class Shard(NamedTuple):
    """One device's part of a sharded batch: rows ``rows`` of the global
    batch, rendered on ``device``."""

    rows: slice
    device: torch.device
    frames: RenderedFrame


def make_device_mesh(axis: str = "scenes") -> Mesh:
    """1-D mesh over the devices of every process (batch.py:244-249): this
    process's cards (``distributed.make_hybrid_mesh``'s default), as many
    per process."""
    hybrid = make_hybrid_mesh()
    return Mesh(hybrid.devices.reshape(-1), hybrid.process_index.reshape(-1), (axis,))


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _check_device(device: torch.device) -> None:
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise ValueError(f"generate_batch_sharded: the mesh names {device}, which this "
                             "process does not have")
    elif device.type != "cpu":
        raise ValueError(f"generate_batch_sharded: unsupported device {device}")


def _to_device(x, device):
    if hasattr(x, "_fields"):
        return type(x)(*(_to_device(v, device) for v in x))
    return x.to(device) if isinstance(x, torch.Tensor) else x


_TEMPLATE_COPIES: dict = {}  # (id(template), device) -> (template, its copy)
_MAX_TEMPLATE_COPIES = 8


def template_on(tpl: SceneTemplate, device: torch.device) -> SceneTemplate:
    """``tpl`` on ``device``: itself when it lives there, else a copy made
    once per (template, device) and kept while the template is among the
    last few copied."""
    if tpl.base_z.device == device:
        return tpl
    key = (id(tpl), str(device))
    hit = _TEMPLATE_COPIES.get(key)
    if hit is None or hit[0] is not tpl:
        while len(_TEMPLATE_COPIES) >= _MAX_TEMPLATE_COPIES:
            _TEMPLATE_COPIES.pop(next(iter(_TEMPLATE_COPIES)))
        hit = _TEMPLATE_COPIES[key] = (tpl, _to_device(tpl, device))
    return hit[1]


def generate_batch_sharded(
    generator: torch.Generator,
    batch: int,
    tpl: SceneTemplate,
    cfg: FrameConfig,
    solver_cfg: SolverConfig,
    mesh: Mesh | None = None,
    settle_iterations: int = tt.MAX_ITERATIONS,
    render_sub_batch: int = 8,
) -> list[Shard]:
    """The scale-out entry (batch.py:252-321): ``batch`` scenes sharded over
    every axis of ``mesh`` (default ``make_device_mesh()``). Every process
    draws the whole batch; each of this process's devices takes its rows
    (``ceil(B / n)`` per device in mesh order, the last ones short or
    empty, no padding) and runs ``generate_from_draws`` on them with the
    template copied to it. Returns this process's shards in mesh order,
    each on its own device; a device with no rows has none. No collective
    is issued and nothing is gathered. The devices of one process run one
    after another from the calling thread: for throughput run one process
    per card (``distributed.initialize``)."""
    _check_sub_batch(render_sub_batch)
    mesh = make_device_mesh() if mesh is None else mesh
    for d, p in zip(mesh.devices.reshape(-1), mesh.process_index.reshape(-1)):
        if p == distributed.process_index():
            _check_device(d)
    draws = draw_scenes(generator, batch, tpl.tabletop_geom.diameter.shape[0])
    shards = []
    for rows, device, part in shard_keys(draws, mesh):
        if rows.stop <= rows.start:
            continue
        with _on(device):
            frames = generate_from_draws(part, template_on(tpl, device), cfg, solver_cfg,
                                         settle_iterations, render_sub_batch)
        shards.append(Shard(rows, device, frames))
    return shards


def _to_host(out: dict, stream) -> tuple[dict, object]:
    """Queue the copy of each tensor of ``out`` to host memory: on CUDA
    into pinned buffers on ``stream``, after the work queued so far on the
    current stream of the tensors' device; returns (host tensors, the
    copy's end event or None)."""
    first = next(iter(out.values()))
    if first.device.type != "cuda":
        return {k: v.clone() for k, v in out.items()}, None
    with torch.cuda.device(first.device):
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
    mesh: Mesh | None = None,
    render_sub_batch: int = 8,
    prefetch: int = 2,
    gt_fields: tuple[str, ...] | None = None,
    settle_iterations: int = tt.MAX_ITERATIONS,
):
    """Yields ``n_batches`` (None: without end) batches of ``batch`` scenes
    as numpy arrays (batch.py:324-409): batch k is ``generate_batch`` on one
    ``torch.Generator`` seeded with ``seed``, after batches 0..k-1. With
    ``mesh`` it is ``generate_batch_sharded`` instead, and the batch holds
    this process's rows (``distributed.local_batch_slice``), its shards
    copied to the host and concatenated in row order.

    ``gt_fields``: the ``RenderedFrame`` fields to read back (None: all,
    yielded as a ``RenderedFrame``). With it each batch is a dict of numpy
    arrays, and float32 fields are narrowed to float16 on the device before
    the copy (uint8, uint16, int32 and bool fields pass unchanged); an
    unknown field raises ``ValueError``.

    Batch k + ``prefetch`` is issued before batch k is read back. Issuing a
    batch runs its settle and render on the host's side too (the settle
    loop and the compactions read sizes from the device), so what overlaps
    the next batches' device work is batch k's narrowing and its copy to
    pinned host memory on a copy stream of each device."""
    if gt_fields is not None:
        bad = set(gt_fields) - set(RenderedFrame._fields)
        if bad:
            raise ValueError(f"unknown gt_fields {sorted(bad)}")
    generator = torch.Generator().manual_seed(seed)
    streams: dict = {}  # device -> its copy stream
    pending: deque = deque()

    def issue(frames: RenderedFrame):
        """Narrow and queue one device's frames for the host: (host
        tensors, the copy's end event, the device tensors)."""
        if gt_fields is None:
            out = frames._asdict()
        else:
            out = {}
            for f in gt_fields:
                x = getattr(frames, f)
                out[f] = x.to(torch.float16) if x.dtype == torch.float32 else x
        dev = frames.rgb.device
        if dev.type == "cuda" and dev not in streams:
            streams[dev] = torch.cuda.Stream(dev)
        return (*_to_host(out, streams.get(dev)), out)

    def fetch(parts):
        for _, done, _ in parts:  # the device tensors stay referenced until here
            if done is not None:
                done.synchronize()
        arrays = {k: np.concatenate([host[k].numpy() for host, _, _ in parts])
                  if len(parts) > 1 else parts[0][0][k].numpy() for k in parts[0][0]}
        return arrays if gt_fields is not None else RenderedFrame(**arrays)

    for _ in range(n_batches) if n_batches is not None else count():
        if mesh is None:
            parts = [issue(generate_batch(generator, batch, tpl, cfg, solver_cfg,
                                          settle_iterations, render_sub_batch))]
        else:
            shards = generate_batch_sharded(generator, batch, tpl, cfg, solver_cfg, mesh,
                                            settle_iterations, render_sub_batch)
            if not shards:
                raise ValueError(f"generate_stream: a batch of {batch} leaves this process no rows")
            parts = [issue(sh.frames) for sh in shards]
        pending.append(parts)
        if len(pending) > prefetch:
            yield fetch(pending.popleft())
    while pending:
        yield fetch(pending.popleft())
