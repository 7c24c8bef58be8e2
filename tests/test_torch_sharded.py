"""The port's scale-out datagen (``stillleben_tpu_torch/parallel/batch.py``:
``draw_scenes``, ``generate_from_draws``, ``render_sub_batch``,
``generate_batch_sharded``, ``generate_stream(mesh=...)``) on the CPU.

- ``draw_scenes`` + ``generate_from_draws`` is bitwise what
  ``generate_batch`` was before the draws were split from the work (a copy
  of that body is kept here as the reference), through either raster.
- ``render_sub_batch`` 1, 3 and 8 give equal frames; 0 raises.
- On a (1, 4) CPU mesh a batch of 8 or 16 gives shards of the sizes the
  JAX package's addressable shards have for the same batch and mesh; an
  uneven batch of 6 gives 2, 2, 2 and skips the empty fourth device. Each
  shard is bitwise equal to ``generate_from_draws`` of its rows at its own
  size (a scene's settle depends on the size of the batch it settles in:
  ROADMAP C-17).
- ``generate_stream(mesh=...)``'s batch k is ``generate_batch_sharded``
  called k-th on the same seed, its shards concatenated in row order.
- A mesh device the process does not have raises before any draw; there
  is no default mesh without a card.
- The launch guard (C-16): with ``nvcc.load`` stubbed, each kernel
  wrapper loads and launches with the tensor's device current, whatever
  device the thread had current.
"""

import numpy as np
import pytest
import torch

import torch_port_scene  # noqa: F401  (one thread per xdist worker)
from stillleben_tpu_torch.core import math as m
from stillleben_tpu_torch.parallel import batch as pb
from stillleben_tpu_torch.parallel import distributed as pdist
from stillleben_tpu_torch.physics import tabletop as tt
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import RenderedFrame
from stillleben_tpu_torch.scene.camera_fit import fit_camera_position, random_camera_rotation
from test_torch_distributed import _jax_shard_sizes
from torch_port_dist import assert_frames_equal, shard_config
from torch_port_scene import build_meshes, port_template

CFG = shard_config()
SOLVER = default_config()
ITERATIONS = 2


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    return port_template(build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                      native_decomp=False))


def cpu_mesh(n):
    return pdist.make_hybrid_mesh(devices=["cpu"] * n)


def rows_of(draws, rows):
    return pb.SceneDraws(*(x[rows] for x in draws))


def old_generate_batch(generator, batch, tpl, cfg, solver_cfg, settle_iterations):
    """``generate_batch`` before the draws were split from the work: the
    orientations drawn, the settle, then the camera's uniforms and the
    light's normals drawn from the same generator; one scene rendered after
    the other and the frames stacked."""
    dev = tpl.base_z.device
    nb = tpl.tabletop_geom.diameter.shape[0]
    quats = m.random_quaternion((batch, nb), generator).to(dev)
    state = tt.stack_objects(tpl.tabletop_geom, tpl.base_z, quats)
    state = tt.settle(tpl.hull_atlas, tpl.body_params, state, tpl.floor, tpl.pairs,
                      tpl.tabletop_geom, solver_cfg, iterations=settle_iterations)
    poses = state.pose_matrix()
    n_phys = tpl.bbox_corners.shape[0]
    world_corners = (
        torch.einsum("bnij,ncj->bnci", poses[:, :n_phys, :3, :3], tpl.bbox_corners)
        + poses[:, :n_phys, None, :3, 3]
    ).reshape(batch, -1, 3)
    valid = torch.ones(world_corners.shape[:2], dtype=torch.bool, device=dev)
    R = random_camera_rotation(batch, generator, dev)
    fallback = torch.einsum("bij,j->bi", R, torch.tensor([0.0, 0.0, -1.0], device=dev))
    pos = torch.where(valid.any(dim=1, keepdim=True),
                      fit_camera_position(R, tpl.base_inputs.projection, world_corners, valid),
                      fallback)
    cams = m.make_transform(R, pos)
    r = torch.randn((batch, 3), generator=generator, dtype=torch.float32).to(dev)
    d = m.normalize(torch.stack([r[:, 0], -r[:, 1].abs(), -r[:, 2].abs()], dim=-1))
    lights = torch.einsum("bij,bj->bi", cams[:, :3, :3], -d)
    frames = [pb.render_with_poses(tpl, poses[b], cams[b], cfg, lights[b]) for b in range(batch)]
    return RenderedFrame(*(torch.stack(fs) for fs in zip(*frames)))


@pytest.mark.parametrize("raster,batch", [("cells", 2), ("classic", 3)])
def test_generate_batch_is_what_it_was(tpl, raster, batch):
    cfg = CFG._replace(raster=raster)
    want = old_generate_batch(torch.Generator().manual_seed(7), batch, tpl, cfg, SOLVER, ITERATIONS)
    got = pb.generate_batch(torch.Generator().manual_seed(7), batch, tpl, cfg, SOLVER, ITERATIONS)
    assert_frames_equal(got, want)
    draws = pb.draw_scenes(torch.Generator().manual_seed(7), batch, 3)
    assert_frames_equal(pb.generate_from_draws(draws, tpl, cfg, SOLVER, ITERATIONS), want)


def test_render_sub_batch_does_not_change_the_frames(tpl):
    draws = pb.draw_scenes(torch.Generator().manual_seed(8), 5, 3)
    poses, cams, lights = pb.settle_draws(draws, tpl, SOLVER, ITERATIONS)
    ref = pb.render_batch(tpl, poses, cams, lights, CFG, 1)
    assert (ref.valid.flatten(1).sum(1) > 0).all(), "a scene without object pixels"
    for sub in (3, 8):
        assert_frames_equal(pb.render_batch(tpl, poses, cams, lights, CFG, sub), ref)
    assert_frames_equal(pb.generate_from_draws(draws, tpl, CFG, SOLVER, ITERATIONS, 3), ref)
    gen = torch.Generator().manual_seed(8)
    state = gen.get_state()
    for call in (lambda: pb.generate_batch(gen, 5, tpl, CFG, SOLVER, ITERATIONS, 0),
                 lambda: pb.generate_batch_sharded(gen, 5, tpl, CFG, SOLVER, cpu_mesh(2),
                                                   ITERATIONS, 0),
                 lambda: pb.render_batch(tpl, poses, cams, lights, CFG, 0)):
        with pytest.raises(ValueError, match="render_sub_batch"):
            call()
    assert torch.equal(gen.get_state(), state), "a refused call drew numbers"


@pytest.mark.parametrize("batch", [8, 16])
def test_shards_have_jax_sizes_and_equal_their_rows(tpl, batch):
    shards = pb.generate_batch_sharded(torch.Generator().manual_seed(3), batch, tpl, CFG, SOLVER,
                                       cpu_mesh(4), ITERATIONS, render_sub_batch=3)
    assert [s.frames.rgb.shape[0] for s in shards] == _jax_shard_sizes(batch, 4)
    draws = pb.draw_scenes(torch.Generator().manual_seed(3), batch, 3)
    stop = 0
    for s in shards:
        assert s.rows.start == stop and s.device == torch.device("cpu")
        stop = s.rows.stop
        assert_frames_equal(s.frames, pb.generate_from_draws(rows_of(draws, s.rows), tpl, CFG,
                                                             SOLVER, ITERATIONS))
    assert stop == batch


def test_an_uneven_batch_skips_the_empty_device(tpl):
    shards = pb.generate_batch_sharded(torch.Generator().manual_seed(4), 6, tpl, CFG, SOLVER,
                                       cpu_mesh(4), ITERATIONS)
    assert [(s.rows.start, s.rows.stop) for s in shards] == [(0, 2), (2, 4), (4, 6)]
    assert [s.frames.rgb.shape[0] for s in shards] == [2, 2, 2]
    draws = pb.draw_scenes(torch.Generator().manual_seed(4), 6, 3)
    last = shards[-1]
    assert_frames_equal(last.frames, pb.generate_from_draws(rows_of(draws, last.rows), tpl, CFG,
                                                            SOLVER, ITERATIONS))


@pytest.mark.parametrize("gt_fields", [None, ("rgb", "depth", "instance_index")])
def test_stream_over_a_mesh_equals_generate_batch_sharded(tpl, gt_fields):
    mesh = cpu_mesh(2)
    got = list(pb.generate_stream(tpl, CFG, SOLVER, batch=3, n_batches=2, seed=5, mesh=mesh,
                                  settle_iterations=ITERATIONS, gt_fields=gt_fields))
    gen = torch.Generator().manual_seed(5)
    assert len(got) == 2
    for batch in got:
        shards = pb.generate_batch_sharded(gen, 3, tpl, CFG, SOLVER, mesh, ITERATIONS)
        assert [(s.rows.start, s.rows.stop) for s in shards] == [(0, 2), (2, 3)]
        for name in gt_fields or RenderedFrame._fields:
            want = torch.cat([getattr(s.frames, name) for s in shards])
            if gt_fields is not None and want.dtype == torch.float32:
                want = want.to(torch.float16)
            have = batch[name] if gt_fields is not None else getattr(batch, name)
            assert have.dtype == want.numpy().dtype
            np.testing.assert_array_equal(have, want.numpy(), err_msg=name)


def test_a_missing_device_raises_before_drawing(tpl):
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    mesh = pdist.make_hybrid_mesh(devices=["cpu", "cuda:7"])
    with pytest.raises(ValueError, match="cuda:7"):
        pb.generate_batch_sharded(gen, 4, tpl, CFG, SOLVER, mesh, ITERATIONS)
    assert torch.equal(gen.get_state(), state)
    if not torch.cuda.is_available():  # no default mesh without a card
        with pytest.raises(ValueError, match="no devices"):
            pb.make_device_mesh()


def test_template_is_copied_once_per_device(tpl):
    meta = torch.device("meta")
    assert pb.template_on(tpl, torch.device("cpu")) is tpl
    copy = pb.template_on(tpl, meta)
    assert copy.base_z.device == meta and copy.render_atlas.faces.device == meta
    assert pb.template_on(tpl, meta) is copy
    other = tpl._replace(base_z=tpl.base_z.clone())
    assert pb.template_on(other, meta) is not copy


class _Fake:
    """A CPU tensor that says it lives on ``cuda:1``: enough of a tensor
    for the wrappers' checks and their ctypes calls."""

    device = torch.device("cuda", 1)
    requires_grad = False

    def __init__(self, t):
        self._t = t
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return True

    def numel(self):
        return self._t.numel()

    def data_ptr(self):
        return 0


def test_wrappers_launch_on_the_tensors_device(monkeypatch):
    from stillleben_tpu_torch.ops import cell_raster as cr
    from stillleben_tpu_torch.ops import fine_raster as fr
    from stillleben_tpu_torch.ops import nvcc, smoke

    current = [torch.device("cuda", 0)]  # the thread's current device
    seen = []

    class Guard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                seen.append((name, current[-1]))
                return 0
            return entry

    def load(source, symbol, argtypes):
        seen.append(("load " + source, current[-1]))
        return Lib()

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(nvcc, "load", load)
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(torch, "empty_like", lambda x, **k: real_empty(x.shape, dtype=x.dtype))

    f32, i32 = torch.float32, torch.int32
    LT = _Fake(torch.zeros((5, cr.FIELDS), dtype=f32))
    cr.cell_raster(LT, _Fake(torch.zeros((2, 4), dtype=i32)), _Fake(torch.zeros(2, dtype=i32)),
                   None, 0.1, 10.0, 1, 16, 1)
    fr.fine_raster(LT, _Fake(torch.zeros((1, 1, 4), dtype=i32)),
                   _Fake(torch.zeros((1, 256), dtype=f32)), 0.1, 10.0, 4, 1)
    smoke.double(_Fake(torch.zeros((8, 128), dtype=f32)))
    smoke.empty_launch("cuda:1")
    assert [name for name, _ in seen] == [
        "load cell_raster.cu", "sl_cell_raster", "load fine_raster.cu", "sl_fine_raster",
        "load smoke.cu", "sl_smoke", "load smoke.cu", "sl_empty"]
    assert all(device == torch.device("cuda", 1) for _, device in seen), seen
    assert current == [torch.device("cuda", 0)]
