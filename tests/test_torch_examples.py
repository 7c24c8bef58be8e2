"""The port's examples (``stillleben_tpu_torch/examples``: ``pbr``, ``viewer``,
``ycb``) on the CPU at a small size, each through its ``main()`` or
entry function with ``device="cpu"``: the settle cut to 5 frames (a wrap of
``tabletop.simulate_tabletop``; the examples run the full 100 on the card).

- ``pbr``: the procedural blob heap, written as JPEG by the port's encoder,
  which Pillow opens to the array the port's decoder reads;
- ``viewer``: the headless dashboard PNG of the settled scene;
- ``ycb``: ``run`` without a YCB path (primitives) writes a JPEG that
  Pillow opens; ``run_stream`` writes each scene's RGB as PNG and JPEG and
  its instance mask as 16-bit PNG, all of which read back through the
  port's codec (the PNGs bitwise to what Pillow reads).
"""

import functools
import os

import numpy as np
import pytest

import stillleben_tpu_torch as sl
from stillleben_tpu_torch.assets import image
from stillleben_tpu_torch.examples import pbr, viewer, ycb
from stillleben_tpu_torch.physics import tabletop
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def short_settle(monkeypatch, tmp_path):
    monkeypatch.setattr(tabletop, "simulate_tabletop",
                        functools.partial(tabletop.simulate_tabletop, iterations=5))
    monkeypatch.setenv("STILLLEBEN_TPU_MESH_CACHE", str(tmp_path / "mesh_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)
    yield
    sl.init(device="cpu")


def assert_pillow_reads_as_port(path, shape):
    ref = np.asarray(Image.open(path).convert("RGBA"))
    assert ref.shape == shape
    np.testing.assert_array_equal(image.read_image(path), ref)


def test_pbr(tmp_path, monkeypatch):
    out = str(tmp_path / "pbr.jpeg")
    monkeypatch.setenv("PBR_OBJECTS", "2")  # the JAX example's variable
    monkeypatch.delenv("PBR_FULL", raising=False)
    monkeypatch.delenv("PBR_IBL", raising=False)
    assert pbr.main(["--device", "cpu", "--size", "96", "72", "--subdiv", "2",
                     "--out", out]) == out
    assert Image.open(out).format == "JPEG"
    assert_pillow_reads_as_port(out, (72, 96, 4))


def test_viewer(tmp_path):
    out = str(tmp_path / "dash.png")
    scene = viewer.main(["--device", "cpu", "--size", "96", "72", "--objects", "2",
                         "--subdiv", "2", "--out", out])
    assert len(scene.objects) == 2
    dash = image.read_image(out)
    assert dash.shape[2] == 4 and dash.shape[:2] == (144, 192)
    assert_pillow_reads_as_port(out, dash.shape)


def test_ycb_run(tmp_path):
    out = str(tmp_path / "rgb.jpeg")
    assert ycb.run(out=out, device="cpu", objects=3, resolution=(96, 72)) == out
    assert Image.open(out).format == "JPEG"
    assert_pillow_reads_as_port(out, (72, 96, 4))


def test_ycb_run_stream(tmp_path):
    out_dir = str(tmp_path / "stream")
    written = ycb.run_stream(n_batches=1, batch=2, out_dir=out_dir, width=64, height=48,
                             device="cpu", shadow_size=256, settle_iterations=5)
    assert sorted(os.listdir(out_dir)) == sorted(os.path.basename(p) for p in written)
    assert len(written) == 6
    for path in written:
        if path.endswith("_mask.png"):
            png = image.read_png_samples(path)
            assert png.bit_depth == 16 and png.samples.shape == (48, 64, 1)
            np.testing.assert_array_equal(png.samples[..., 0], np.asarray(Image.open(path)))
        else:
            assert_pillow_reads_as_port(path, (48, 64, 4))
    rgb_png = image.read_image(written[0])
    rgb_jpg = image.read_image(written[1])
    assert np.abs(rgb_png[..., :3].astype(int) - rgb_jpg[..., :3].astype(int)).mean() < 8
