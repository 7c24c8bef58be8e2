"""AVIF in the port's codec (``assets/avif.py`` over the native AV1 decoder
``csrc/sl_av1.cpp``) against Pillow 12.1.0 (libavif 1.3.0, dav1d 1.5.1),
OpenCV 5.0.0 (libavif 1.4.2) and the JAX package.

- Every committed fixture to the digests of Pillow's and OpenCV's readings
  (the card's host checks the same); a few against the libraries here,
  with dtype and shape.
- Seeded round trips: Pillow writes small images of seeded sizes, contents
  and qualities, and the port reads each as Pillow and OpenCV do, bitwise.
- The JAX package on the same files: ``Texture``, ``ImageLoader``, the
  light map's panorama reader (unscaled: the names end in neither .png nor
  .jpg), and the documents and scene atlas of a blob textured from AVIF.
"""

import hashlib
import io
import shutil

import numpy as np
import pytest

import stillleben_tpu as jsl
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu.render.atlas import build_scene_atlas as jax_build_scene_atlas
from stillleben_tpu_torch.assets import avif, image
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image_fixtures import AVIF_FILES, digests
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.mesh import Mesh
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_avif_fixtures
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.render import light_map as plm
from stillleben_tpu_torch.scene.scene import Object
from test_torch_loaders import assert_same
from torch_image_fixtures import smooth
from torch_port_scene import to_numpy

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def read(name: str) -> bytes:
    with open(fixture(name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", AVIF_FILES)
def test_fixture_readings(name):
    """Each fixture's bytes, and the port's readings against the digests of
    Pillow's and OpenCV's."""
    data = read(name)
    assert sha(data) == digests.AVIF_FILE[name]
    assert sha(image.read_image(fixture(name)).tobytes()) == digests.AVIF_DECODE[name]
    assert sha(image.read_image_cv2(fixture(name)).tobytes()) == digests.AVIF_DECODE_CV2[name]


@pytest.mark.parametrize("name", ("frame_rgba.avif", "grey.avif", "depth16.avif", "tiny_3x5.avif",
                                  "few_480x640.avif", "rot.avif", "tools_smooth.avif"))
def test_readings_match_the_libraries(name):
    """The same against Pillow and OpenCV here, with dtype and shape (an
    EXIF orientation stays an orientation: the pixels are as stored)."""
    ref = np.asarray(Image.open(fixture(name)).convert("RGBA"))
    got = image.read_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    ref = cv2.imread(fixture(name), CV2_FLAGS)
    got = image.read_image_cv2(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_container_refusals():
    """What the container parser refuses by name, or as not AVIF at all."""
    data = read("frame.avif")
    assert avif.is_avif(data) and not avif.is_avif(b"\0\0\0\x0cjP  \r\n\x87\n")
    meta = data.index(b"meta") - 4
    no_meta = data[:meta] + b"\0\0\0\x08free" + data[meta + 8:]
    with pytest.raises(ValueError, match="meta"):
        avif.decode_avif(no_meta)
    avis = data[:8] + b"avis" + data[12:]
    with pytest.raises(NotImplementedError, match="sequence"):
        avif.decode_avif(avis[:meta] + b"\0\0\0\x08free" + avis[meta + 8:])
    grid = data.replace(b"av01", b"grid", 1)
    with pytest.raises(NotImplementedError, match="grid"):
        avif.decode_avif(grid)


# ---------------------------------------------------------------------------
# seeded round trips through Pillow's writer
# ---------------------------------------------------------------------------

ROUND_TRIPS = 16


@pytest.fixture(scope="module")
def pillow_files(tmp_path_factory):
    """Pillow's AVIF ``save`` (its defaults but the quality) of seeded
    images: sizes up to 96 a side, random, smooth, few-colour or constant
    content, RGB or RGBA, quality 30 to 94 (the range the fixtures cover)."""
    d = tmp_path_factory.mktemp("avif")
    rng = np.random.default_rng(2100)
    out = []
    for i in range(ROUND_TRIPS):
        h, w = (int(v) for v in rng.integers(1, 97, 2))
        c = 4 if i % 4 == 3 else 3
        kind = i % 4
        if kind == 0:
            a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        elif kind == 1:
            a = smooth(h, w, c, 2100 + i)
        elif kind == 2:
            pal = rng.integers(0, 256, (3, c))
            a = pal[rng.integers(0, 3, (h // 4 + 1, w // 4 + 1))].repeat(4, 0).repeat(4, 1)
            a = a[:h, :w].astype(np.uint8)
        else:
            a = np.broadcast_to(rng.integers(0, 256, c), (h, w, c)).astype(np.uint8)
        p = str(d / f"rt{i}.avif")
        Image.fromarray(a).save(p, quality=int(rng.integers(30, 95)))
        out.append(p)
    return out


@pytest.mark.parametrize("i", range(ROUND_TRIPS))
def test_seeded_round_trip(pillow_files, i):
    p = pillow_files[i]
    np.testing.assert_array_equal(image.read_image(p), np.asarray(Image.open(p).convert("RGBA")))
    np.testing.assert_array_equal(image.read_image_cv2(p), cv2.imread(p, CV2_FLAGS))


# ---------------------------------------------------------------------------
# the JAX package on the same files
# ---------------------------------------------------------------------------

JAX_READ = ("frame.avif", "frame_rgba.avif", "grey.avif", "depth16.avif", "odd_65x130.avif",
            "few_480x640.avif")


@pytest.mark.parametrize("name", JAX_READ)
def test_texture_and_panorama_match_jax(name):
    """``Texture(path)`` and the light map's panorama reader (OpenCV's
    reading, C-18's unscaled 8-bit values in both: the names end in
    neither .png nor .jpg)."""
    np.testing.assert_array_equal(Texture(fixture(name)).pixels, jsl.Texture(fixture(name)).pixels)
    got, ref = plm._load_hdr_image(fixture(name)), jlm._load_hdr_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape and ref.max() > 10
    np.testing.assert_array_equal(got, ref)


def test_image_loader_matches_jax(tmp_path):
    """A folder of AVIF files under names the loaders take (both read a
    file by its bytes; neither scans for .avif): one thread, one seed, the
    same textures."""
    for i, name in enumerate(JAX_READ):
        shutil.copyfile(fixture(name), tmp_path / f"{i}_{name.replace('.', '_')}.png")
    port = ImageLoader(str(tmp_path), seed=9, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=9, num_threads=1)
    try:
        for _ in range(8):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    return write_avif_fixtures(str(tmp_path_factory.mktemp("avif_scene")), subdiv=2)


@pytest.mark.parametrize("name", ("obj_avif", "glb_avif"))
def test_document_matches_jax(scene_files, name):
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    twin = scene_files[name.split("_")[0] + "_png"]
    twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
    np.testing.assert_array_equal(port.images[0], twin_doc.images[0])


def test_atlas_matches_jax(scene_files):
    """The scene atlas of the AVIF-textured blob and GLB is the JAX
    package's, bitwise; the AVIF plane is its twin's."""
    meshes = [scene_files["obj_avif"], scene_files["glb_avif"]]
    pa = patlas.build_scene_atlas([Object(Mesh(p, physics=False)) for p in meshes], "cpu")
    ja = to_numpy(jax_build_scene_atlas([jsl.Object(jsl.Mesh(p, physics=False)) for p in meshes]))
    for field in pa._fields:
        got, want = getattr(pa, field), getattr(ja, field)
        if field == "num_objects":
            assert got == int(want) == 2
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    plane = Texture(scene_files["plane_avif"]).pixels
    np.testing.assert_array_equal(plane, jsl.Texture(scene_files["plane_avif"]).pixels)
    np.testing.assert_array_equal(plane, Texture(scene_files["plane_png"]).pixels)
    assert sha(image.read_image(scene_files["plane_avif"]).tobytes()) == \
        digests.AVIF_DECODE["checker.avif"]
