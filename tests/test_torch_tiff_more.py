"""TIFF through the JAX package's entry points on the CPU, against the
port's counterparts on the same files.

- ``load_gltf``: GLBs whose base colour is an embedded JPEG-in-TIFF, CMYK
  or Group 4 file; the OBJ loader with those as ``map_Kd``
  (``stillleben_tpu/assets/objfile.py``); the documents equal field for
  field, the pixels bitwise.
- The light map's panorama (``_load_hdr_image``): float32 and int32 TIFF
  (OpenCV's reading, unscaled), an LZMA one (OpenCV reads nothing: Pillow's
  ``convert("RGB")`` to the power 2.2) and BigTIFF, exactly; and the whole
  ``LightMap`` of the float32 TIFF ``.ibl`` within 1e-5 of the JAX
  package's (relative, and of the cubemap's peak), equal to the port's own
  from the ``.hdr`` twin.
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
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_tiff_scene_fixtures
from stillleben_tpu_torch.assets.writers import write_glb
from stillleben_tpu_torch.render import light_map as plm
from test_torch_loaders import assert_same

pytest.importorskip("PIL.Image")
pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
TEXTURES = ("jpeg_ycbcr.tif", "jpeg_tiles_ycbcr.tif", "cmyk_lzw.tif", "g4.tif", "g3_2d_fill2.tif",
            "lab.tif")


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiff_scene"))
    paths = write_tiff_scene_fixtures(d, subdiv=1)
    blob = load_obj(paths["obj_png"]).meshes[0][0]
    with open(paths["obj_tif"]) as f:
        obj = f.read()
    mtl = os.path.splitext(paths["obj_tif"])[0] + ".mtl"
    with open(mtl) as f:
        mtl_text = f.read()
    for name in TEXTURES:
        stem = "kd_" + name.replace(".", "_")
        shutil.copyfile(fixture(name), os.path.join(d, name))
        with open(os.path.join(d, stem + ".mtl"), "w") as f:
            f.write(mtl_text.replace("blob_basecolor_jpeg.tif", name))
        with open(os.path.join(d, stem + ".obj"), "w") as f:
            f.write(obj.replace(os.path.basename(mtl), stem + ".mtl"))
        paths[stem] = os.path.join(d, stem + ".obj")
        with open(fixture(name), "rb") as f:
            write_glb(os.path.join(d, stem + ".glb"), blob, f.read(), mime="image/tiff")
        paths[stem + "_glb"] = os.path.join(d, stem + ".glb")
    return paths


@pytest.mark.parametrize("name", ("glb_tif", "obj_tif"))
def test_scene_textures_match_jax(scene_files, name):
    """The scene's blob (a JPEG-in-TIFF base colour) through the JAX loaders
    and the port's: the documents equal, the pixels bitwise, and equal to
    the PNG twin's."""
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    twin = scene_files[name.split("_")[0] + "_png"]
    twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
    np.testing.assert_array_equal(port.images[0], twin_doc.images[0])


@pytest.mark.parametrize("name", TEXTURES)
@pytest.mark.parametrize("kind", ("obj", "glb"))
def test_textures_match_jax(scene_files, name, kind):
    """JPEG-in-TIFF (strips and YCbCr tiles), CMYK, Group 4, 2-D Group 3 and
    CIELab as ``map_Kd`` and as a GLB's embedded image."""
    stem = "kd_" + name.replace(".", "_")
    path = scene_files[stem] if kind == "obj" else scene_files[stem + "_glb"]
    port, ref = (load_obj(path), jax_obj(path)) if kind == "obj" else (load_gltf(path),
                                                                        jax_gltf(path))
    assert_same(port, ref)
    np.testing.assert_array_equal(port.images[0], read_image(fixture(name)))


@pytest.mark.parametrize("name", ("cv2_float_rgb.tif", "cv2_float_rgb_pred3.tif", "sky_float.tif",
                                  "cv2_int32.tif", "mode_f.tif", "lzma_rgb.tif", "zstd_rgb.tif",
                                  "bigtiff_rgb.tif", "bigtiff_be.tif", "pred3_float.tif"))
def test_panorama_matches_jax(name):
    """OpenCV's reading (float32 and int32 unscaled, BigTIFF), or Pillow's
    ``convert("RGB")`` where OpenCV reads nothing (LZMA, ZSTD): the JAX
    panorama reader's floats, exactly."""
    got, ref = plm._load_hdr_image(fixture(name)), jlm._load_hdr_image(fixture(name))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_float_tiff_light_map_matches_jax(scene_files):
    """The whole light map of the float32 TIFF ``.ibl`` (the sky and its sun):
    within 1e-5 of the JAX package's, and the port's equal to its own from
    the ``.hdr`` twin, whose equirect is the same float32 values."""
    port = plm.LightMap(scene_files["ibl_tif"], device="cpu")
    ref = jlm.LightMap(scene_files["ibl_tif"])
    twin = plm.LightMap(scene_files["ibl_hdr"], device="cpu")
    np.testing.assert_array_equal(port.light_directions, np.asarray(ref.light_directions))
    peak = float(np.abs(np.asarray(ref.data.cubemap)).max())
    assert peak > 0
    for field in plm.LightMapData._fields:
        got, want = getattr(port.data, field).numpy(), np.asarray(getattr(ref.data, field))
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * peak, err_msg=field)
        np.testing.assert_array_equal(got, getattr(twin.data, field).numpy(), err_msg=field)
