"""The port's ``ImageSaver`` against the JAX package's (which hands every
path to Pillow 12.1.0): for each array and path, both savers with one
thread, the same base name in two directories, and what each leaves on
disk compared: the same bytes, or no file (or, where a file was there
before and Pillow had opened it, the same empty file).

The cases: arrays Pillow makes no image of ((4, 5, 1), (4, 5, 2), (4, 5,
5) and (4,) uint8), extensions Pillow does not know (``.exr``, ``.xyz``,
none), extensions Pillow knows but cannot write or refuses the modes for,
the modes QOI, PCX, SGI and DDS refuse, and every extension of QOI, SGI,
PCX, IM and DDS in every mode (L, RGB, RGBA, I;16). ``save()`` itself
raises only for the dtype, a uint16 array that is not 2-D, and an
extension Pillow writes that the port does not encode yet.
"""

import os

import numpy as np
import pytest

from stillleben_tpu_torch.assets import image_saver
from stillleben_tpu_torch.assets.image_saver import ImageSaver
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

jax_saver = pytest.importorskip("stillleben_tpu.assets.image_saver")
pytest.importorskip("PIL.Image")

SLICE_EXTS = (".qoi", ".sgi", ".rgb", ".rgba", ".bw", ".pcx", ".im", ".dds")


def arrays() -> dict:
    rng = np.random.default_rng(20)
    return {"L": rng.integers(0, 256, (4, 5)).astype(np.uint8),
            "RGB": rng.integers(0, 256, (4, 5, 3)).astype(np.uint8),
            "RGBA": rng.integers(0, 256, (4, 5, 4)).astype(np.uint8),
            "I;16": rng.integers(0, 65536, (4, 5)).astype(np.uint16),
            "451": rng.integers(0, 256, (4, 5, 1)).astype(np.uint8),
            "452": rng.integers(0, 256, (4, 5, 2)).astype(np.uint8),
            "455": rng.integers(0, 256, (4, 5, 5)).astype(np.uint8),
            "4": rng.integers(0, 256, (4,)).astype(np.uint8)}


def left_on_disk(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def run_both(tmp_path, jobs, existing: bytes | None = None):
    """Save ``jobs`` [(key, array, file name)] with both savers into their
    own directories (the file names kept, so SGI and IM write the same base
    name); with ``existing``, each file is there beforehand with those
    bytes. Returns what each directory holds."""
    dirs = {}
    for who, cls in (("jax", jax_saver.ImageSaver), ("port", ImageSaver)):
        d = tmp_path / who
        d.mkdir()
        if existing is not None:
            for _, _, name in jobs:
                (d / name).write_bytes(existing)
        with cls(num_threads=1) as saver:
            for _, a, name in jobs:
                saver.save(a, str(d / name))
        dirs[who] = left_on_disk(d)
    return dirs["jax"], dirs["port"]


@pytest.mark.parametrize("ext", SLICE_EXTS)
def test_every_mode_of_the_slice(ext, tmp_path, capsys):
    """Each extension of the slice in L, RGB, RGBA and I;16: Pillow's bytes,
    or, where Pillow refuses the mode, a printed failure and no file."""
    jobs = [(k, a, f"{k.replace(';', '')}_x{ext}") for k, a in arrays().items()
            if k in ("L", "RGB", "RGBA", "I;16")]
    ref, ours = run_both(tmp_path, jobs)
    assert ours == ref
    refused = 4 - len(ref)
    out = capsys.readouterr().out
    assert out.count("ImageSaver: failed to write") == 2 * refused


def test_what_pillow_refuses(tmp_path, capsys):
    """Arrays Pillow makes no image of, unknown and unwritable extensions,
    and the modes the slice's formats refuse: printed, nothing written."""
    a = arrays()
    jobs = [(k, a[k], f"{k}_x{ext}") for k in ("451", "452", "455", "4")
            for ext in (".png", ".qoi", ".dds", ".exr", "")]
    jobs += [("RGB", a["RGB"], f"RGB_x{ext}") for ext in (".exr", ".xyz", "", ".psd", ".blp")]
    jobs += [(k, a[k], f"{k.replace(';', '')}_y{ext}") for k, ext in (
        ("L", ".qoi"), ("I;16", ".qoi"), ("RGBA", ".pcx"), ("I;16", ".pcx"), ("I;16", ".sgi"),
        ("I;16", ".dds"), ("RGBA", ".jpg"), ("I;16", ".bmp"))]
    ref, ours = run_both(tmp_path, jobs)
    assert ref == ours == {}
    assert capsys.readouterr().out.count("ImageSaver: failed to write") == 2 * len(jobs)


def test_failures_over_existing_files(tmp_path, capsys):
    """Where a file was there: Pillow empties it when it had opened it for
    a known format whose writer then refused, and leaves it otherwise."""
    a = arrays()
    jobs = [(k, a[k], f"{k.replace(';', '')}_{i}{ext}") for i, (k, ext) in enumerate((
        ("L", ".qoi"), ("I;16", ".pcx"), ("I;16", ".sgi"), ("RGBA", ".jpg"), ("RGB", ".blp"),
        ("RGB", ".exr"), ("RGB", ".psd"), ("455", ".qoi"), ("4", ".png"), ("RGB", ".qoi"),
        ("L", ".pcx")))]
    ref, ours = run_both(tmp_path, jobs, existing=b"previous")
    assert ours == ref
    assert ref["L_0.qoi"] == b"" and ref["RGB_5.exr"] == b"previous"
    capsys.readouterr()


def test_save_raises_only_where_the_jax_saver_does(tmp_path):
    """``save()`` raises for the dtype and for 3-D uint16 in both savers;
    the port also raises for an extension Pillow writes that it does not
    encode yet (the JAX saver writes it)."""
    port, ref = ImageSaver(num_threads=1), jax_saver.ImageSaver(num_threads=1)
    try:
        for saver in (port, ref):
            with pytest.raises(TypeError):
                saver.save(np.zeros((4, 5), np.float32), str(tmp_path / "x.png"))
            with pytest.raises(ValueError):
                saver.save(np.zeros((4, 5, 3), np.uint16), str(tmp_path / "x.png"))
        for ext in image_saver.NOT_PORTED:
            with pytest.raises(NotImplementedError, match=ext.replace(".", r"\.")):
                port.save(np.zeros((4, 5, 3), np.uint8), str(tmp_path / f"x{ext}"))
        port.save(np.zeros((4, 5, 5), np.uint8), str(tmp_path / "odd.ico"))  # queued: it fails
    finally:
        port.close()
        ref.close()
    assert not os.listdir(tmp_path)
