"""The port's asset layer against the JAX package's on the same JPEG, BMP,
TGA, GIF and TIFF files (the JAX package reads them through Pillow and
OpenCV, the port through its own codec):

- ``Texture(path)``: the same pixels;
- an OBJ whose ``.mtl`` names a ``.jpg`` and a GLB with an embedded JPEG
  (``procedural.write_image_fixtures``): the same documents, field for
  field, and the same scene atlas;
- ``ImageLoader`` over a folder of every format, one thread, one seed: the
  same textures in the same order;
- the light map's panorama reader on each format (exact; a TGA through the
  JAX package's Pillow fallback), and ``LightMap`` from an ``.ibl`` whose
  ``REFfile`` is a JPEG, at ``test_torch_light_map_files.py``'s tolerances;
- ``ImageSaver`` writing ``.jpg .bmp .tga .tif``: the same bytes, and the
  same files missing where Pillow refuses the mode.
"""

import io
import os

import numpy as np
import pytest

import stillleben_tpu as jsl
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.image_saver import ImageSaver as JaxImageSaver
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu.render.atlas import build_scene_atlas as jax_build_scene_atlas
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.image_saver import ImageSaver
from stillleben_tpu_torch.assets.mesh import Mesh
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_image_fixtures
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.render import light_map as plm
from stillleben_tpu_torch.scene.scene import Object
from test_torch_light_map_files import _assert_light_map
from test_torch_loaders import assert_same
from torch_image_fixtures import smooth
from torch_port_scene import to_numpy

Image = pytest.importorskip("PIL.Image")

FORMATS = {  # file name: how Pillow writes it
    "a.jpg": dict(format="JPEG"), "b.bmp": dict(format="BMP"), "c.tga": dict(format="TGA"),
    "d.gif": dict(format="GIF"), "e.tif": dict(format="TIFF", compression="tiff_lzw"),
    "f.jpeg": dict(format="JPEG", progressive=True, quality=90),
    "g.tiff": dict(format="TIFF", compression="tiff_adobe_deflate"),
}


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    paths = {}
    for k, (name, kw) in enumerate(FORMATS.items()):
        a = smooth(29 + k, 41 + 2 * k, 3, k)
        img = Image.fromarray(a).quantize(64) if kw["format"] == "GIF" else Image.fromarray(a)
        img.save(str(d / name), **kw)
        paths[name] = str(d / name)
    return paths


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    return write_image_fixtures(str(tmp_path_factory.mktemp("scene")), subdiv=2)


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_texture_matches_jax(images, name):
    got, ref = Texture(images[name]).pixels, jsl.Texture(images[name]).pixels
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["obj_jpg", "glb_jpeg"])
def test_document_matches_jax(scene_files, name):
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    assert port.images[0].shape == (256, 256, 4)


def test_glb_jpeg_atlas_matches_jax(scene_files):
    port = Object(Mesh(scene_files["glb_jpeg"], physics=False))
    ref = jsl.Object(jsl.Mesh(scene_files["glb_jpeg"], physics=False))
    pa = patlas.build_scene_atlas([port], "cpu")
    ja = to_numpy(jax_build_scene_atlas([ref]))
    for name in pa._fields:
        got, want = getattr(pa, name), getattr(ja, name)
        if name == "num_objects":
            assert got == int(want) == 1
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (pa.mat_base_tex >= 0).sum() == 1


def test_image_loader_matches_jax(images, tmp_path):
    for name, path in images.items():
        (tmp_path / name).write_bytes(open(path, "rb").read())
    port = ImageLoader(str(tmp_path), seed=3, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=3, num_threads=1)
    try:
        for _ in range(12):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_panorama_reader_matches_jax(images, name):
    got, ref = plm._load_hdr_image(images[name]), jlm._load_hdr_image(images[name])
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_light_map_from_jpeg_ibl_matches_jax(scene_files):
    path = scene_files["ibl_jpg"]
    port, ref = plm.LightMap(path, device="cpu"), jlm.LightMap(path)
    assert port.light_directions.shape == (1, 3)
    _assert_light_map(port, ref)


ARRAYS = {
    "rgb": lambda: smooth(31, 45, 3, 1), "rgba": lambda: smooth(31, 45, 4, 2),
    "grey": lambda: smooth(31, 45, 1, 3)[..., 0],
    "depth": lambda: smooth(31, 45, 1, 4)[..., 0].astype(np.uint16) * 257,
}


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".bmp", ".tga", ".tif", ".tiff"])
def test_image_saver_matches_jax(ext, tmp_path, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    with ImageSaver(num_threads=2) as port, JaxImageSaver(num_threads=2) as ref:
        for name, make in ARRAYS.items():
            port.save(make(), str(tmp_path / "port" / f"{name}{ext}"))
            ref.save(make(), str(tmp_path / "jax" / f"{name}{ext}"))
    written = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == written
    for name in written:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    refused = {f"{n}{ext}" for n in ARRAYS} - set(written)
    out = capsys.readouterr().out
    for name in refused:  # both packages report each refused mode, once each
        assert out.count(f"{name}: cannot write mode") == 2, out
    assert {".jpg": 2, ".jpeg": 2, ".bmp": 1, ".tga": 1}.get(ext, 0) == len(refused)


def test_pillow_reads_back_port_jpeg(tmp_path):
    """A JPEG the port wrote opens in Pillow as the port's own decoder reads it."""
    a = smooth(64, 48, 3, 7)
    path = str(tmp_path / "x.jpg")
    with ImageSaver(num_threads=1) as saver:
        saver.save(a, path)
    ref = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(Texture(path).pixels, ref)
    assert Image.open(io.BytesIO(open(path, "rb").read())).format == "JPEG"
