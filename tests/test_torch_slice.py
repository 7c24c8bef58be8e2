"""The datagen slice of the port end to end on the CPU: its own template
construction against the JAX package's, each from its own loader of the
same mesh files (the JAX side cooking hulls with its Python decomposition,
the port's one algorithm), and ``generate_batch`` through either raster
producing every ``RenderedFrame`` field with the JAX package's shapes and
dtypes."""

import numpy as np
import pytest
import torch

from stillleben_tpu_torch.parallel.batch import SceneTemplate, generate_batch
from stillleben_tpu_torch.physics.types import default_config
from stillleben_tpu_torch.render.frame import FrameConfig
from stillleben_tpu_torch.render.shading import INVALID
from torch_port_scene import H, SHADOW_SIZE, W, build_meshes, jax_template, port_template, to_numpy


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The port's own meshes."""
    return build_meshes(str(tmp_path_factory.mktemp("meshes")), port=True)


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    return build_meshes(str(tmp_path_factory.mktemp("jax_meshes")), native_decomp=False)


def _leaves(tree, prefix=""):
    """(path, value) for every array leaf of nested NamedTuples."""
    if hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{prefix}{name}.")
    else:
        yield prefix.rstrip("."), tree


def test_template_from_scene_matches_jax(meshes, jax_meshes):
    rng = np.random.default_rng(7)
    mr = [(float(rng.random()), float(rng.random())) for _ in meshes]
    jt = to_numpy(jax_template(jax_meshes, metallic_roughness=mr))
    pt = port_template(meshes, metallic_roughness=mr)
    compared = 0
    for path, value in _leaves(pt):
        if value is None:
            continue
        ref = jt
        for part in path.split("."):
            ref = getattr(ref, part)
        if isinstance(value, int):
            assert value == int(ref), path
            continue
        got = value.numpy()
        ref = np.asarray(ref)
        assert got.shape == ref.shape, path
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=path)
        compared += 1
    assert compared >= 40


def test_generate_batch_end_to_end_on_cpu(meshes):
    check_generate_batch(meshes, FrameConfig(width=W, height=H, max_lights=1,
                                             shadow_size=SHADOW_SIZE))


def test_generate_batch_classic_end_to_end_on_cpu(meshes):
    check_generate_batch(meshes, FrameConfig(width=W, height=H, max_lights=1,
                                             shadow_size=SHADOW_SIZE, raster="classic"))


def test_frame_config_rejects_unknown_choices():
    with pytest.raises(ValueError):
        FrameConfig(width=W, height=H, raster="scanline").check()
    with pytest.raises(ValueError):
        FrameConfig(width=W, height=H, raster="classic", fine_tiles_per_cell=3).check()
    FrameConfig(width=W, height=H, raster="classic", fine_tiles_per_cell=8).check()


def check_generate_batch(meshes, cfg):
    tpl = port_template(meshes)
    assert isinstance(tpl, SceneTemplate)
    frames = generate_batch(torch.Generator().manual_seed(0), 2, tpl, cfg, default_config(),
                            settle_iterations=3)
    want = dict(
        rgb=((2, H, W, 4), torch.uint8), hdr=((2, H, W, 4), torch.float32),
        object_coordinates=((2, H, W, 4), torch.float32),
        cam_coordinates=((2, H, W, 4), torch.float32),
        class_index=((2, H, W), torch.uint16), instance_index=((2, H, W), torch.uint16),
        normals=((2, H, W, 4), torch.float32), vertex_indices=((2, H, W, 3), torch.int32),
        barycentric_coeffs=((2, H, W, 3), torch.float32), depth=((2, H, W), torch.float32),
        valid=((2, H, W), torch.bool),
    )
    assert set(frames._fields) == set(want)
    for name, (shape, dtype) in want.items():
        x = getattr(frames, name)
        assert tuple(x.shape) == shape and x.dtype == dtype, name
        if dtype == torch.float32:
            assert torch.isfinite(x).all(), name
    valid = frames.valid
    inst = frames.instance_index.to(torch.int32)
    assert ((inst > 0) == valid).all()
    assert valid.flatten(1).any(1).all(), "a scene without any object pixel"
    assert (frames.cam_coordinates[~valid] == INVALID).all()
    assert (frames.object_coordinates[~valid] == INVALID).all()
    assert (frames.vertex_indices[valid] > 0).all()
    assert frames.rgb.float().std() > 1
