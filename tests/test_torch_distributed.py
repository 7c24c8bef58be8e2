"""``parallel/distributed.py`` against the JAX package's
(``stillleben_tpu/parallel/distributed.py``), and the sharded batch in two
processes.

The layout is the JAX package's to the row: ``local_batch_slice`` on
JAX's own ``make_hybrid_mesh()`` (shape (1, 8) on the 8 CPU devices of
``tests/conftest.py``) and, for process 1 of (2, 4) and (4, 2) meshes, on
a stand-in mesh with ``jax.process_index`` patched (JAX's function reads
only ``.devices.size``, ``.flat`` and each device's ``.process_index``);
``shard_keys`` gives each device as many rows as JAX's ``shard_keys``
gives its addressable shards. ``initialize`` returns False with nothing to
coordinate, as JAX's does, refuses several processes without a
coordinator, and raises when the coordinator cannot be reached. Two
``gloo`` processes on a (2, 1) CPU mesh each get their rows of a batch of
4, bitwise equal to ``generate_from_draws`` of those rows at their size,
and call no ``torch.distributed`` collective (each raises around the
batch)."""

import jax
import numpy as np
import pytest
import torch

import torch_port_scene  # noqa: F401  (one thread per xdist worker)
from stillleben_tpu.parallel import distributed as jdist
from stillleben_tpu_torch.parallel import distributed as pdist
from stillleben_tpu_torch.parallel.batch import SceneDraws, draw_scenes, generate_from_draws
from stillleben_tpu_torch.physics.types import default_config
from torch_port_dist import assert_frames_equal, free_port, run_processes, shard_config
from torch_port_scene import build_meshes, port_template

LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "TPU_WORKER_HOSTNAMES")


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(pdist, "_local_devices", None)


def test_initialize_without_a_coordinator_is_false(no_launcher):
    assert jdist.initialize() is False
    assert pdist.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_processes_without_a_coordinator(no_launcher):
    with pytest.raises(ValueError, match="coordinator"):
        pdist.initialize(num_processes=2, process_id=0)


def test_initialize_raises_on_an_unreachable_coordinator(no_launcher):
    # process 1 of 2 waits for process 0's store, which nothing serves
    with pytest.raises(RuntimeError):
        pdist.initialize(f"127.0.0.1:{free_port()}", 2, 1, timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_make_hybrid_mesh_matches_jax(no_launcher):
    jm = jdist.make_hybrid_mesh()
    pm = pdist.make_hybrid_mesh(devices=["cpu"] * 8)
    assert pm.axis_names == tuple(jm.axis_names) == ("hosts", "scenes")
    assert pm.devices.shape == jm.devices.shape == (1, 8)
    assert pm.size == 8 and (pm.process_index == 0).all()
    if not torch.cuda.is_available():  # the cards by default, never the CPU
        with pytest.raises(ValueError, match="no devices"):
            pdist.make_hybrid_mesh()


@pytest.mark.parametrize("batch", [8, 16, 6])
def test_local_batch_slice_matches_jax(no_launcher, batch):
    assert (pdist.local_batch_slice(batch, pdist.make_hybrid_mesh(devices=["cpu"] * 8))
            == jdist.local_batch_slice(batch, jdist.make_hybrid_mesh()))


class _Device:
    """A device of a stand-in mesh: its owning process only."""

    def __init__(self, process_index):
        self.process_index = process_index


class _StandInMesh:
    def __init__(self, shape):
        flat = np.empty(shape[0] * shape[1], dtype=object)
        flat[:] = [_Device(p) for p in range(shape[0]) for _ in range(shape[1])]
        self.devices = flat.reshape(shape)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("batch", [8, 16, 6])
def test_local_batch_slice_of_process_1_matches_jax(monkeypatch, shape, batch):
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    want = jdist.local_batch_slice(batch, _StandInMesh(shape))
    monkeypatch.setattr(pdist, "process_index", lambda: 1)
    monkeypatch.setattr(pdist, "process_count", lambda: shape[0])
    mesh = pdist.make_hybrid_mesh(devices=["cpu"] * shape[1])
    assert mesh.devices.shape == shape
    assert pdist.local_batch_slice(batch, mesh) == want
    # this process's devices take their rows of it, clipped to the batch
    rows = [r for r, _, _ in pdist.shard_keys(torch.zeros(batch, 1), mesh)]
    assert rows[0].start == min(want.start, batch) and rows[-1].stop == min(want.stop, batch)


def _jax_shard_sizes(batch, n):
    mesh = jdist.make_hybrid_mesh(devices=jax.devices()[:n])
    keys = jdist.shard_keys(jax.random.split(jax.random.PRNGKey(0), batch), mesh)
    shards = sorted(keys.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [s.data.shape[0] for s in shards]


@pytest.mark.parametrize("batch", [8, 16])
def test_shard_keys_match_jax(no_launcher, batch):
    draws = draw_scenes(torch.Generator().manual_seed(0), batch, 3)
    parts = pdist.shard_keys(draws, pdist.make_hybrid_mesh(devices=["cpu"] * 4))
    assert [p.quats.shape[0] for _, _, p in parts] == _jax_shard_sizes(batch, 4)
    for rows, device, part in parts:
        assert device == torch.device("cpu")
        for got, full in zip(part, draws):
            assert torch.equal(got, full[rows])


def test_shard_keys_of_an_uneven_batch(no_launcher):
    parts = pdist.shard_keys(torch.arange(6), pdist.make_hybrid_mesh(devices=["cpu"] * 4))
    assert [(r.start, r.stop) for r, _, _ in parts] == [(0, 2), (2, 4), (4, 6), (6, 6)]
    assert [p.tolist() for _, _, p in parts] == [[0, 1], [2, 3], [4, 5], []]


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    return port_template(build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                      native_decomp=False))


def test_two_processes_equal_their_rows(tpl, tmp_path):
    cfg, solver = shard_config(), default_config()
    job = dict(template=tpl, cfg=cfg, solver=solver, seed=11, batch=4, iterations=5,
               render_sub_batch=8, device="cpu")
    out = run_processes(job, 2, str(tmp_path))
    draws = draw_scenes(torch.Generator().manual_seed(11), 4, tpl.tabletop_geom.diameter.shape[0])
    for rank, got in enumerate(out):
        assert got["rows"] == (2 * rank, 2 * rank + 2) and got["mesh_shape"] == (2, 1)
        ((rows, device, frames),) = got["shards"]
        assert rows == got["rows"] and device == "cpu"
        part = SceneDraws(*(x[rows[0]:rows[1]] for x in draws))
        assert_frames_equal(frames, generate_from_draws(part, tpl, cfg, solver, 5))
        assert (frames.valid.flatten(1).sum(1) > 0).all(), "a scene without object pixels"
