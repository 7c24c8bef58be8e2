"""Multi-process orchestration: the process group and the device mesh.

Counterpart of ``stillleben_tpu/parallel/distributed.py`` (the four names
of its ``__all__``). The reference has no distributed layer; the JAX
package adds one, and so does the port, over ``torch.distributed``:

- :func:`initialize` joins the process group, one process per card (or per
  host and its cards). It reads torch's launcher environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, as ``torchrun`` sets them) where the JAX package reads
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
  The group carries only the rendezvous, the process count and the
  process index: no tensor crosses processes, so its backend is ``gloo``
  on the CPU and on the card alike.
- :func:`make_hybrid_mesh` lays the devices out as ``(processes, devices
  per process)``, the JAX package's ``(dcn, ici)`` mesh.
- :func:`shard_keys` gives each of this process's devices its rows of a
  batch of per-scene draws (the port's counterpart of a PRNG key batch),
  moved to that device; :func:`local_batch_slice` gives the rows of this
  process. Both follow the JAX package's arithmetic: ``ceil(B / n)`` rows
  per device, in the mesh's flat order.

One process over its local cards needs no :func:`initialize`.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "make_hybrid_mesh", "shard_keys", "local_batch_slice"]

_local_devices: list[torch.device] | None = None  # named by initialize()


class Mesh(NamedTuple):
    """A device mesh: ``devices`` an object array of ``torch.device`` of
    shape (processes, devices per process), ``process_index`` the owning
    process of each entry, ``axis_names`` one name per axis."""

    devices: np.ndarray
    process_index: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)


def process_index() -> int:
    """This process's index in the group (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    timeout_s: float = 300.0,
) -> bool:
    """Join the process group (one call per process, before the first
    batch). ``coordinator_address`` is ``host:port`` of process 0;
    arguments default from ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. ``local_device_ids`` (an int or a list), else ``LOCAL_RANK``,
    names the cards this process drives (``make_hybrid_mesh``'s default).

    Returns False when there is nothing to coordinate (no coordinator and
    at most one process), True once the group exists; a group that exists
    already is kept. A coordinator that cannot be reached within
    ``timeout_s`` raises."""
    global _local_devices
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if local_device_ids is None and "LOCAL_RANK" in env:
        local_device_ids = [int(env["LOCAL_RANK"])]
    if local_device_ids is not None:
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        _local_devices = [torch.device("cuda", i) for i in ids]
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"initialize: {num_processes} processes need a coordinator address")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs num_processes and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def _default_devices() -> list[torch.device]:
    if _local_devices is not None:
        return list(_local_devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_hybrid_mesh(dcn_axis: str = "hosts", ici_axis: str = "scenes", devices=None) -> Mesh:
    """``(processes, devices per process)`` mesh; one process gives
    ``(1, n)``. ``devices``: this process's devices (default: the cards
    named by ``initialize``, else every visible card); they may be CPU
    devices. A process sees only its own devices, so the rows of the
    others repeat this process's names: every process is taken to drive as
    many devices, as the JAX package's ``create_hybrid_device_mesh``
    assumes, and only this process's row is ever used for its devices."""
    devices = _default_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_hybrid_mesh: no devices")
    n_proc = process_count()
    row = np.empty(len(devices), dtype=object)
    row[:] = devices
    grid = np.stack([row] * n_proc)
    owner = np.repeat(np.arange(n_proc), len(devices)).reshape(n_proc, len(devices))
    return Mesh(grid, owner, (dcn_axis, ici_axis))


def _local_flat_ids(mesh: Mesh) -> np.ndarray:
    return np.nonzero(mesh.process_index.reshape(-1) == process_index())[0]


def local_batch_slice(batch_size: int, mesh: Mesh) -> slice:
    """The [start, stop) rows of the global batch this process owns, by the
    JAX package's arithmetic: ``ceil(B / n)`` rows per device, from this
    process's first device's flat index to past its last. The stop may
    pass ``batch_size``; slicing clips it."""
    per_dev = -(-batch_size // mesh.size)
    ids = _local_flat_ids(mesh)
    if len(ids) == 0:
        return slice(0, 0)
    return slice(int(ids[0]) * per_dev, (int(ids[-1]) + 1) * per_dev)


def _rows(x, rows: slice, device):
    if hasattr(x, "_fields"):
        return type(x)(*(_rows(v, rows, device) for v in x))
    return x[rows].to(device)


def shard_keys(draws, mesh: Mesh) -> list:
    """[(rows, device, draws[rows] on device)] for each of this process's
    devices in mesh order: the rows ``local_batch_slice``'s arithmetic
    gives that device, clipped to the batch (possibly none). ``draws`` is a
    tensor or a NamedTuple of tensors with the scene axis first."""
    first = draws[0] if hasattr(draws, "_fields") else draws
    B = first.shape[0]
    per_dev = -(-B // mesh.size)
    flat = mesh.devices.reshape(-1)
    out = []
    for i in _local_flat_ids(mesh):
        rows = slice(min(int(i) * per_dev, B), min((int(i) + 1) * per_dev, B))
        out.append((rows, flat[i], _rows(draws, rows, flat[i])))
    return out
