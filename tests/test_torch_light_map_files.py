"""``LightMap(path)`` of the port against the JAX package's, on the same
files: sIBL ``.ibl`` descriptors and bare images.

- the panorama reader (``_load_hdr_image``) on Radiance and PNG files,
  every conversion of the JAX reader: BGR to RGB, grey stacked, alpha
  dropped, ``(x / 255) ** 2.2`` only for a .png / .jpg / .jpeg whose
  maximum exceeds 10 (a dark 8-bit PNG stays unscaled, a 16-bit one is
  divided by 255): exact;
- ``LightMap("sky.ibl")`` (the sky ``.hdr`` with the bench's sun as
  ``[Sun]``) and an ``.ibl`` whose ``REFfile`` is a PNG, with gamma,
  multiplier and ``[Light1]``: directions and colours within 1e-7, the
  ``LightMapData`` within the tolerances of ``test_torch_light_map.py``
  (1e-4 relative, 1e-4 of the cubemap's peak);
- a bare ``.hdr``: the same panorama as the ``.ibl``'s, no lights;
- the quirky descriptor of ``tests/test_ibl.py`` and the missing
  ``[Reflection]`` error.
"""

import os
import shutil

import numpy as np
import pytest

from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets.image import encode_png, encode_png_samples
from stillleben_tpu_torch.assets.procedural import sky_equirect, write_loader_fixtures
from stillleben_tpu_torch.render import light_map as plm
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lightmaps")
    paths = write_loader_fixtures(str(d), subdiv=1)
    sky = sky_equirect()
    png = np.clip(np.round(sky / sky.max() ** 0.5 * 255), 0, 255).astype(np.uint8)
    (d / "sky.png").write_bytes(encode_png(png))
    (d / "sky_png.ibl").write_text(
        "[Reflection]\nREFfile = \"sky.png\"\nREFgamma = 1.1\nREFmulti = 2.5\n"
        "[Light1]\nLIGHTcolor = 200,180,160\nLIGHTmulti = 0.5\nLIGHTu = 0.25\nLIGHTv = 0.6\n"
    )
    paths["png_ibl"] = str(d / "sky_png.ibl")
    rng = np.random.default_rng(4)
    extra = {
        "bright.png": encode_png(rng.integers(0, 256, (8, 16, 3)).astype(np.uint8)),
        "dark.png": encode_png(rng.integers(0, 11, (8, 16, 3)).astype(np.uint8)),
        "grey.png": encode_png(rng.integers(0, 256, (8, 16)).astype(np.uint8)),
        "rgba.png": encode_png(rng.integers(0, 256, (8, 16, 4)).astype(np.uint8)),
        "deep.png": encode_png_samples(rng.integers(0, 65536, (8, 16, 3)).astype(np.uint16), 2, 16),
        "palette.png": encode_png_samples(rng.integers(0, 4, (8, 16)).astype(np.uint8), 3, 2,
                                          rng.integers(0, 256, (4, 3)).astype(np.uint8)),
    }
    for name, data in extra.items():
        (d / name).write_bytes(data)
        paths[name] = str(d / name)
    return paths


@pytest.mark.parametrize("name", ["hdr", "bright.png", "dark.png", "grey.png", "rgba.png",
                                  "deep.png", "palette.png"])
def test_panorama_reader_matches_jax(files, name):
    got, ref = plm._load_hdr_image(files[name]), jlm._load_hdr_image(files[name])
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _assert_light_map(port, ref):
    np.testing.assert_allclose(port.light_directions, ref.light_directions, rtol=0, atol=1e-7)
    np.testing.assert_allclose(port.light_colors, ref.light_colors, rtol=0, atol=1e-7)
    peak = float(np.abs(np.asarray(ref.data.cubemap)).max())
    for name in plm.LightMapData._fields:
        got, want = getattr(port.data, name).numpy(), np.asarray(getattr(ref.data, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * peak, err_msg=name)


@pytest.mark.parametrize("name", ["ibl", "png_ibl"])
def test_light_map_matches_jax(files, name):
    port = plm.LightMap(files[name], device="cpu")
    ref = jlm.LightMap(files[name])
    assert port.path == ref.path == files[name]
    assert port.light_directions.shape == (1, 3)
    _assert_light_map(port, ref)


def test_bare_hdr_matches_jax(files):
    """A bare ``.hdr``: no lights, and the panorama the ``.ibl`` above reads
    (REFgamma and REFmulti 1), so its ``LightMapData`` is that case's."""
    img, lights = plm._load_source(files["hdr"])
    ref_img, ref_lights = jlm.LightMap()._load_source(files["hdr"])
    assert lights == ref_lights == []
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(img, plm._load_source(files["ibl"])[0])


def test_descriptor_quirks(files, tmp_path):
    """The descriptor of ``tests/test_ibl.py::test_ibl_descriptor_quirks``
    (UTF-8 BOM, CRLF, ``%`` in a value, a duplicate key, mixed-case keys,
    an unknown section): the same panorama and sun as the JAX reader's."""
    body = (
        "[Header]\r\nName = 100% Quirky Env\r\nAuthor = someone ; inline note\r\n"
        "[Reflection]\r\nREFFILE = env.hdr\r\nREFgamma = 1.0\r\nREFgamma = 1.0\r\n"
        "REFmulti = 1.0\r\n[Sun]\r\nSUNcolor = 255,255,255\r\nSUNmulti = 1.0\r\n"
        "SUNu = 0.0\r\nSUNv = 0.25\r\n[Unknown Extra]\r\nweird=1\r\n"
    )
    path = str(tmp_path / "quirky.ibl")
    with open(path, "wb") as f:
        f.write(b"\xef\xbb\xbf" + body.encode())
    shutil.copy(files["hdr"], str(tmp_path / "env.hdr"))
    img, lights = plm._load_source(path)
    ref_img, ref_lights = jlm.LightMap()._load_source(path)
    np.testing.assert_array_equal(img, ref_img)
    assert len(lights) == len(ref_lights) == 1
    for (d, c), (rd, rc) in zip(lights, ref_lights):
        np.testing.assert_allclose(d, rd, rtol=0, atol=1e-7)
        np.testing.assert_allclose(c, rc, rtol=0, atol=1e-7)


def test_missing_reflection_section(tmp_path):
    bad = str(tmp_path / "bad.ibl")
    with open(bad, "w") as f:
        f.write("[Header]\nName=x\n")
    with pytest.raises(ValueError, match="Reflection") as port_err:
        plm.LightMap(bad, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jlm.LightMap(bad)
    assert str(port_err.value) == str(jax_err.value)
    assert os.path.exists(bad)
