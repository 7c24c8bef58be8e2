"""``generate_stream``, the port's counterpart of the JAX package's
host-pipelined datagen loop (``stillleben_tpu/parallel/batch.py:324-409``):
batch k equals ``generate_batch`` called k-th on a generator seeded with
the same seed; with ``gt_fields`` each batch is a dict of numpy arrays whose
float32 fields were narrowed to float16 and whose integer and boolean
fields pass unchanged; without it, a ``RenderedFrame`` of numpy arrays; the
stream yields ``n_batches`` batches whatever ``prefetch`` is; an unknown
field raises ``ValueError``."""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.parallel.batch import generate_batch, generate_stream
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig, RenderedFrame
from torch_port_scene import H, SHADOW_SIZE, W, build_meshes, port_template

CFG = FrameConfig(width=W, height=H, max_lights=1, shadow_size=SHADOW_SIZE, ssao=False,
                  sample_textures=False, sample_stickers=False)
SOLVER = default_config()
FIELDS = ("rgb", "instance_index", "class_index", "depth", "valid", "vertex_indices")
KW = dict(batch=2, seed=9, settle_iterations=2)


@pytest.fixture(scope="module")
def tpl(tmp_path_factory):
    return port_template(build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True,
                                      native_decomp=False))


@pytest.fixture(scope="module")
def reference(tpl):
    """Three batches of ``generate_batch`` on one generator seeded 9."""
    gen = torch.Generator().manual_seed(KW["seed"])
    return [generate_batch(gen, KW["batch"], tpl, CFG, SOLVER, KW["settle_iterations"])
            for _ in range(3)]


def test_stream_batches_equal_generate_batch(tpl, reference):
    got = list(generate_stream(tpl, CFG, SOLVER, n_batches=3, prefetch=2, gt_fields=FIELDS, **KW))
    assert len(got) == 3
    assert not np.array_equal(got[0]["rgb"], got[1]["rgb"]), "two batches alike"
    for batch, ref in zip(got, reference):
        assert set(batch) == set(FIELDS)
        for f in FIELDS:
            x = getattr(ref, f)
            want = (x.to(torch.float16) if x.dtype == torch.float32 else x).numpy()
            assert batch[f].dtype == want.dtype, f
            np.testing.assert_array_equal(batch[f], want, err_msg=f)
    assert got[0]["depth"].dtype == np.float16 and got[0]["rgb"].dtype == np.uint8
    assert got[0]["instance_index"].dtype == np.uint16 and got[0]["valid"].dtype == np.bool_
    assert got[0]["vertex_indices"].dtype == np.int32


def test_stream_full_frames(tpl, reference):
    got = list(generate_stream(tpl, CFG, SOLVER, n_batches=2, prefetch=0, **KW))
    assert len(got) == 2
    for batch, ref in zip(got, reference):
        assert isinstance(batch, RenderedFrame)
        for f in RenderedFrame._fields:
            assert isinstance(getattr(batch, f), np.ndarray)
            np.testing.assert_array_equal(getattr(batch, f), getattr(ref, f).numpy(), err_msg=f)


@pytest.mark.parametrize("prefetch", [0, 1, 5])
def test_stream_yields_every_batch(tpl, prefetch):
    got = list(generate_stream(tpl, CFG, SOLVER, n_batches=2, prefetch=prefetch,
                               gt_fields=("rgb",), **KW))
    assert len(got) == 2 and all(b["rgb"].shape == (2, H, W, 4) for b in got)


def test_stream_refuses_unknown_fields(tpl):
    with pytest.raises(ValueError, match="unknown gt_fields"):
        next(generate_stream(tpl, CFG, SOLVER, n_batches=1, gt_fields=("rgb", "albedo"), **KW))
