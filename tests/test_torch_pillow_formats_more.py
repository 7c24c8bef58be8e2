"""Pillow's rarer formats through the JAX package's entry points on the CPU,
against the port's counterparts on the same files.

- ``load_gltf``: a GLB whose base colour is an embedded BLP2 DXT5 and a
  ``.gltf`` whose image is an external XPM; the OBJ loader with ``map_Kd``
  textures in the new formats (``stillleben_tpu/assets/objfile.py``);
  the documents equal field for field, the pixels bitwise.
- The light map's panorama: a Sun raster (OpenCV's reading) and an XBM
  and a FITS file (OpenCV reads neither: Pillow's ``convert("RGB")``),
  exact (an RGB XPM with a ``None`` colour too, which only
  ``convert("RGB")`` reads), and the whole ``LightMap`` of the Sun raster
  and of the FITS panorama within 1e-5 of the JAX package's (relative,
  and of the cubemap's peak).
"""

import os
import shutil

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image import read_image
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_fixtures import rare_formats as rf
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_pillow_format_scene_fixtures
from stillleben_tpu_torch.assets.writers import write_gltf
from stillleben_tpu_torch.render import light_map as plm
from test_torch_loaders import assert_same

pytest.importorskip("PIL.Image")
pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
# the OBJ textures: one file of each kind the blob's map_Kd names
MAP_KD = ("dxt5.blp", "dxt1.ftc", "rle24.ras", "frame.xbm", "palette.xpm", "lins.msp",
          "brush_rgba.gbr", "int16.fits", "brun.flc", "float_be.spi", "area2.mcidas", "frame.pxr",
          "thumb.xv", "band.iim")


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rare_scene"))
    paths = write_pillow_format_scene_fixtures(d, subdiv=1)
    shutil.copyfile(fixture("palette.xpm"), os.path.join(d, "tex.xpm"))
    blob = load_obj(paths["obj_png"]).meshes[0][0]
    paths["gltf_xpm"] = os.path.join(d, "blob_xpm.gltf")
    write_gltf(paths["gltf_xpm"], blob, "blob_xpm.bin", image_uri="tex.xpm")
    with open(paths["obj_rare"]) as f:
        obj = f.read()
    mtl = os.path.splitext(paths["obj_rare"])[0] + ".mtl"
    with open(mtl) as f:
        mtl_text = f.read()
    for name in MAP_KD:
        stem = "kd_" + name.replace(".", "_")
        shutil.copyfile(fixture(name), os.path.join(d, name))
        with open(os.path.join(d, stem + ".mtl"), "w") as f:
            f.write(mtl_text.replace("blob_basecolor_dxt5.blp", name))
        with open(os.path.join(d, stem + ".obj"), "w") as f:
            f.write(obj.replace(os.path.basename(mtl), stem + ".mtl"))
        paths[stem] = os.path.join(d, stem + ".obj")
    return paths


@pytest.mark.parametrize("name", ("glb_rare", "gltf_xpm", "obj_rare"))
def test_gltf_and_obj_match_jax(scene_files, name):
    """The JAX loaders and the port's read the same documents, the BLP and
    XPM base colours bitwise (and the BLP's equal to its PNG twin's)."""
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    assert port.images and port.images[0].ndim == 3
    if name != "gltf_xpm":
        twin = scene_files[name.split("_")[0] + "_png"]
        twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
        np.testing.assert_array_equal(port.images[0], twin_doc.images[0])
    else:
        np.testing.assert_array_equal(port.images[0], read_image(fixture("palette.xpm")))


@pytest.mark.parametrize("name", MAP_KD)
def test_obj_map_kd_matches_jax(scene_files, name):
    """``map_Kd`` in each new format: the JAX OBJ loader's document."""
    path = scene_files["kd_" + name.replace(".", "_")]
    port, ref = load_obj(path), jax_obj(path)
    assert_same(port, ref)
    assert port.images[0].shape[:2] == read_image(fixture(name)).shape[:2]


@pytest.fixture(scope="module")
def panoramas(tmp_path_factory):
    d = tmp_path_factory.mktemp("rare_panoramas")
    rgb = rf.integer_image(24, 48, 3, 70)
    grey = rgb[..., 0]
    files = {"sky.ras": rf.sun_raster(rgb, 24), "sky_grey.ras": rf.sun_raster(
        grey, 8, palette=np.repeat(np.arange(256)[:, None], 3, 1)),
        "sky.xbm": rf.xbm((grey > 100).astype(np.uint8)), "sky.fits": rf.fits(grey, 8),
        # over 256 colours and a None one: convert("RGBA") fails, "RGB" reads
        "sky_none.xpm": rf.xpm(grey.astype(np.int64) + 1, rf.integer_image(300, 1, 3, 71)[:, 0],
                               chars=2, transparent=0)}
    paths = {}
    for name, data in files.items():
        (d / name).write_bytes(data)
        paths[name] = str(d / name)
    return paths


@pytest.mark.parametrize("name", ("sky.ras", "sky_grey.ras", "sky.xbm", "sky.fits",
                                  "sky_none.xpm"))
def test_panorama_matches_jax(panoramas, name):
    """OpenCV's reading of a Sun raster (BGR, and a grey palette as one
    channel stacked), Pillow's ``convert("RGB")`` of what OpenCV does not
    read (an RGB XPM with a ``None`` colour among them, which
    ``convert("RGBA")`` refuses): the JAX panorama reader's floats,
    exactly."""
    got, ref = plm._load_hdr_image(panoramas[name]), jlm._load_hdr_image(panoramas[name])
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ("sky.ras", "sky.fits"))
def test_light_map_matches_jax(panoramas, name):
    """The whole light map of a Sun raster and of a FITS panorama: no
    lights, the ``LightMapData`` within 1e-5 (relative, and of the
    cubemap's peak) of the JAX package's."""
    port = plm.LightMap(panoramas[name], device="cpu")
    ref = jlm.LightMap(panoramas[name])
    assert port.light_directions.shape == np.asarray(ref.light_directions).shape
    peak = float(np.abs(np.asarray(ref.data.cubemap)).max())
    assert peak > 0
    for field in plm.LightMapData._fields:
        got, want = getattr(port.data, field).numpy(), np.asarray(getattr(ref.data, field))
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * peak, err_msg=field)
