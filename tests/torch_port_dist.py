"""Spawn helper of the port's multi-process tests (and of ``chip_smoke.py``'s
two-process phase): ``torch.multiprocessing`` starts each worker by
importing it, so the worker lives in a module of its own.

``run_processes(job, n, directory)`` saves ``job`` (a dict: ``template`` on
the CPU, ``cfg``, ``solver``, ``seed``, ``batch``, ``iterations``,
``render_sub_batch`` and ``device``, the device every process drives),
starts ``n`` processes that join a ``gloo`` group on a free local port,
and returns what each saved: its ``local_batch_slice`` and its shards of
``generate_batch_sharded`` over an ``(n, 1)`` mesh, moved to the CPU. No
``torch.distributed`` collective may run during the batch: each one raises
there. A worker that fails makes ``run_processes`` raise.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
    "all_to_all_single", "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "gather_object", "irecv", "isend", "monitored_barrier", "recv", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
)


@contextlib.contextmanager
def no_collectives():
    """Every ``torch.distributed`` collective raises inside the block."""
    import torch.distributed as dist

    saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"torch.distributed.{name} was called")
        return call

    for name in saved:
        setattr(dist, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, address: str, directory: str) -> None:
    import torch.distributed as dist

    from stillleben_tpu_torch.parallel import distributed
    from stillleben_tpu_torch.parallel.batch import generate_batch_sharded

    torch.set_num_threads(1)
    job = torch.load(os.path.join(directory, "job.pt"), weights_only=False)
    device = torch.device(job["device"])
    if not distributed.initialize(address, world, rank, timeout_s=120):
        raise RuntimeError("initialize: no process group")
    try:
        mesh = distributed.make_hybrid_mesh(devices=[device])
        rows = distributed.local_batch_slice(job["batch"], mesh)
        t0 = time.perf_counter()
        with no_collectives():
            shards = generate_batch_sharded(
                torch.Generator().manual_seed(job["seed"]), job["batch"], job["template"],
                job["cfg"], job["solver"], mesh, job["iterations"], job["render_sub_batch"],
            )
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        torch.save(dict(
            rows=(rows.start, rows.stop), mesh_shape=mesh.devices.shape, seconds=seconds,
            shards=[((s.rows.start, s.rows.stop), str(s.device),
                     type(s.frames)(*(x.cpu() for x in s.frames))) for s in shards],
        ), os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_processes(job: dict, n: int, directory: str) -> list[dict]:
    os.makedirs(directory, exist_ok=True)
    torch.save(job, os.path.join(directory, "job.pt"))
    address = f"127.0.0.1:{free_port()}"
    torch.multiprocessing.spawn(_worker, args=(n, address, directory), nprocs=n, join=True)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def shard_config():
    """The sharded tests' frame: 24 x 24, flat, no shadow, through the
    classic raster, whose plain fine stage is the cheapest on the CPU
    (sharding does not depend on the raster; ``test_torch_sharded.py``
    also runs the cell raster once)."""
    from stillleben_tpu_torch.render.frame import FrameConfig

    return FrameConfig(width=24, height=24, shading="flat", shadow_mode="off", max_lights=1,
                       ssao=False, sample_textures=False, sample_stickers=False,
                       raster="classic")


def assert_frames_equal(a, b) -> None:
    """Every field of two ``RenderedFrame`` batches bitwise equal."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
