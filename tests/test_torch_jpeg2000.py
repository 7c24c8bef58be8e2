"""JPEG 2000 in the port's codec (``assets/jpeg2000.py`` over the native
``csrc/sl_j2k.cpp``) against Pillow 12.1.0 (OpenJPEG 2.5.4), OpenCV 5.0.0
and the JAX package.

- Writing: ``encode_jpeg2000`` is Pillow's ``save`` byte for byte in L,
  RGB, RGBA and I;16, as a codestream (``.j2k``) and as JP2, at 1x1,
  1x640, 2x2, 3x5, 31x40, 33x33, 64x64, 65x130 and 480x640, of random,
  smooth and constant content; the committed encode fixtures from their
  sources; the saver's 640x480 files to the digests of Pillow's.
- Reading: every committed fixture to the digests of Pillow's and
  OpenCV's readings (the card's host checks the same), those of Pillow's
  other settings among them (the 9/7 wavelet and the ICT, quality layers,
  precincts, the five progression orders, tiles and offsets, signed
  samples, the cinema profiles); the streams the decoder does not read
  refused by name; ICNS with JPEG 2000 entries; seeded round trips of the
  port's own files and of Pillow's at its settings, 1x1 to 480x640.
- The JAX package on the same files: ``Texture``, ``ImageLoader``, the
  light map's panorama reader, and the documents and scene atlas of a blob
  textured from JP2 files and from files of the other settings.
"""

import hashlib
import io
import os
import shutil
import struct

import numpy as np
import pytest

import stillleben_tpu as jsl
import torch_image_fixtures as tif
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu.render.atlas import build_scene_atlas as jax_build_scene_atlas
from stillleben_tpu_torch.assets import image, jpeg2000
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image_fixtures import (JPEG2000_ENCODE_FILES, JPEG2000_READ_FILES,
                                                        JPEG2000_REFUSALS, JPEG2000_SETTINGS_FILES,
                                                        digests, jpeg2000_saver_sources,
                                                        jpeg2000_sources)
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.mesh import Mesh
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import (write_jpeg2000_fixtures,
                                                    write_jpeg2000_settings_fixtures)
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

SIZES = ((1, 1), (1, 640), (2, 2), (3, 5), (31, 40), (33, 33), (64, 64), (65, 130), (480, 640))
ALL_FILES = JPEG2000_ENCODE_FILES + JPEG2000_READ_FILES + JPEG2000_SETTINGS_FILES


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def read(name: str) -> bytes:
    with open(fixture(name), "rb") as f:
        return f.read()


def pillow_bytes(a: np.ndarray, kind: str) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG2000", no_jp2=kind == "j2k")
    return b.getvalue()


def content(mode: str, kind: str, h: int, w: int, seed: int) -> np.ndarray:
    c = {"L": 1, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    hi = 65536 if mode == "I;16" else 256
    if kind == "random":
        a = np.random.default_rng(seed).integers(0, hi, (h, w, c))
    elif kind == "smooth":
        a = smooth(h, w, c, seed).astype(np.int64) * (257 if mode == "I;16" else 1)
    else:
        a = np.full((h, w, c), (hi // 3, hi // 5, hi // 7, hi - 1)[:c])
    a = a.astype(np.uint16 if mode == "I;16" else np.uint8)
    return a[..., 0] if c == 1 else a


def jp2_codestream(data: bytes) -> bytes:
    at = data.index(b"jp2c") + 4
    assert struct.unpack_from(">I", data, at - 8)[0] == len(data) - at + 8
    return data[at:]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("random", "smooth", "constant"))
@pytest.mark.parametrize("mode", ("L", "RGB", "RGBA", "I;16"))
def test_encode_matches_pillow(mode, kind):
    """Both kinds at every size; at 480x640 Pillow writes the JP2 only, and
    the codestream is its ``jp2c`` box (as it is Pillow's .j2k below)."""
    for i, (h, w) in enumerate(SIZES):
        a = content(mode, kind, h, w, i)
        ref = pillow_bytes(a, "jp2")
        assert jpeg2000.encode_jpeg2000(a, "jp2") == ref, (h, w)
        j2k = jpeg2000.encode_jpeg2000(a, "j2k")
        assert j2k == jp2_codestream(ref), (h, w)
        if h * w < 10000:
            assert j2k == pillow_bytes(a, "j2k"), (h, w)


def test_encode_fixtures_regenerate():
    """The committed files are Pillow's (``make_jpeg2000_fixtures``), and
    the port re-encodes the encode fixtures from their sources."""
    made = tif.make_jpeg2000_fixtures()
    assert sorted(made) == sorted(ALL_FILES)
    for name in ALL_FILES:
        assert made[name] == read(name), name
    for name, a in jpeg2000_sources().items():
        kind = "j2k" if name.endswith(".j2k") else "jp2"
        assert jpeg2000.encode_jpeg2000(a, kind) == read(name), name


@pytest.mark.parametrize("name", [n for n in jpeg2000_saver_sources() if n[-4:] in (".jp2", ".j2k")])
def test_saver_digests(name):
    """The saver's 640x480 JP2 and codestreams: the digests of Pillow's files."""
    kind = "j2k" if name.endswith(".j2k") else "jp2"
    assert sha(jpeg2000.encode_jpeg2000(jpeg2000_saver_sources()[name], kind)) == (
        digests.JPEG2000_ENCODE[name])


def test_encode_refuses_other_arrays():
    for a in (np.zeros((4, 5, 2), np.uint8), np.zeros((4, 5, 3), np.uint16),
              np.zeros((4, 5), np.float32), np.zeros((0, 5), np.uint8)):
        with pytest.raises(ValueError):
            jpeg2000.encode_jpeg2000(a)
    with pytest.raises(ValueError, match="kind"):
        jpeg2000.encode_jpeg2000(np.zeros((4, 5), np.uint8), "jpx")


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL_FILES)
def test_fixture_readings(name):
    """Each fixture's bytes, and the port's readings against the digests of
    Pillow's and OpenCV's; the refused ones raise ``NotImplementedError``
    naming what they need (Pillow reads them)."""
    data = read(name)
    assert sha(data) == digests.JPEG2000_FILE[name]
    if name in JPEG2000_REFUSALS:
        with pytest.raises(NotImplementedError, match=JPEG2000_REFUSALS[name]):
            image.decode_image(data, name)
        assert len(digests.JPEG2000_DECODE[name]) == 64  # Pillow reads it
        return
    assert sha(image.decode_image(data, name).tobytes()) == digests.JPEG2000_DECODE[name]
    p = fixture(name)
    cv = image.read_image_cv2(p)
    assert ("None" if cv is None else sha(cv.tobytes())) == digests.JPEG2000_DECODE_CV2[name]


@pytest.mark.parametrize("name", JPEG2000_ENCODE_FILES[:8] + (
    "rct.jp2", "la.jp2", "la.j2k", "i97_rgba.j2k", "i97_i16.jp2", "ict_rgba.jp2", "order_pcrl.j2k",
    "tiles_col1.j2k", "signed_i16.j2k", "cinema4k24_48x64.j2k", "frame_tiles.j2k"))
def test_readings_match_the_libraries(name):
    """The same against Pillow and OpenCV here, with dtype and shape."""
    data = read(name)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data, name), ref)
    ref = cv2.imread(fixture(name), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    got = jpeg2000.decode_jpeg2000_cv2(data, name)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_decode_is_lossless():
    """Seeded shapes, modes and both kinds: the decode is the source; a
    Pillow stream with the colour transform too."""
    rng = np.random.default_rng(40)
    for i in range(24):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        mode = ("L", "RGB", "RGBA", "I;16")[i % 4]
        a = content(mode, ("random", "smooth")[i % 2], h, w, 100 + i)
        back = jpeg2000.decode_samples(jpeg2000.encode_jpeg2000(a, ("j2k", "jp2")[i % 3 == 0]))
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
    a = content("RGBA", "random", 37, 53, 7)
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG2000", mct=1)
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(b.getvalue()), a)


@pytest.mark.parametrize("start", range(0, 120, 20))
def test_settings_round_trips(start):
    """Twenty seeded cases each: the port reads Pillow's file of each as
    Pillow reads it, and raises where Pillow raises (a precinct exponent of
    0 above the lowest resolution); files Pillow's ``save`` refuses to
    write are skipped."""
    read_ = 0
    for i in range(start, start + 20):
        a, kw = tif.jpeg2000_sweep_case(i)
        name = ("x.j2k", "x.jp2")[i % 2]
        try:
            data = tif.pillow_file(a, name, **kw)
        except (OSError, ValueError):  # a tile grid that misses the image, an encoder error
            continue
        try:
            ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        except OSError:
            with pytest.raises((OSError, ValueError)):
                jpeg2000.decode_jpeg2000(data, name)
            continue
        np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data, name), ref,
                                      err_msg=str((i, kw)))
        read_ += 1
    assert read_ >= 12


@pytest.mark.parametrize("name", ("signed_l.j2k", "signed_i16.j2k"))
def test_signed_samples(name):
    """``decode_samples`` gives a signed file's samples as int8 or int16;
    Pillow's L or I;16 holds each plus half the range."""
    data = read(name)
    s = jpeg2000.decode_samples(data, name)
    ref = np.asarray(Image.open(io.BytesIO(data))).astype(np.int32)
    assert s.dtype == (np.int8 if name == "signed_l.j2k" else np.int16)
    np.testing.assert_array_equal(s.astype(np.int32) + (128 if s.dtype == np.int8 else 32768), ref)


def test_refusals_by_name(tmp_path):
    """Each refusal names its parameter (the fixtures cover the rest);
    damaged streams raise, none gives an image. A SIZ patched to a signed
    first component is read as Pillow reads it (RGB), and OpenCV reads
    nothing of it."""
    data = read("frame.j2k")
    siz = data.index(b"\xff\x51")
    signed = bytearray(data)
    signed[siz + 40] |= 0x80
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(bytes(signed)),
                                  np.asarray(Image.open(io.BytesIO(bytes(signed))).convert("RGBA")))
    (tmp_path / "signed.j2k").write_bytes(bytes(signed))
    flags = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
    assert cv2.imread(str(tmp_path / "signed.j2k"), flags) is None
    assert jpeg2000.decode_jpeg2000_cv2(bytes(signed)) is None
    cod = data.index(b"\xff\x52")
    end_cod = cod + 2 + struct.unpack_from(">H", data, cod + 2)[0]
    coc = b"\xff\x53\x00\x09\x00\x00\x05\x04\x04\x00\x01"  # component 0: COD's own values
    with pytest.raises(NotImplementedError, match="COC"):
        jpeg2000.decode_jpeg2000(data[:end_cod] + coc + data[end_cod:])
    qcd = data.index(b"\xff\x5c")
    derived = bytearray(data)
    derived[qcd + 4] = (derived[qcd + 4] & 0xe0) | 1
    with pytest.raises(NotImplementedError, match="derived quantisation"):
        jpeg2000.decode_jpeg2000(bytes(derived))
    poc = b"\xff\x5f\x00\x09\x00\x00\x00\x01\x01\x03\x00"  # resolution 0 alone, LRCP
    with pytest.raises(NotImplementedError, match="progression order changes"):
        jpeg2000.decode_jpeg2000(data[:end_cod] + poc + data[end_cod:])
    twelve = bytearray(data)
    for c in range(3):
        twelve[siz + 40 + 3 * c] = 11
    with pytest.raises(NotImplementedError, match="12 bits"):
        jpeg2000.decode_jpeg2000(bytes(twelve))
    cod = data.index(b"\xff\x52")
    sop = bytearray(data)
    sop[cod + 4] |= 2
    with pytest.raises(NotImplementedError, match="SOP/EPH"):
        jpeg2000.decode_jpeg2000(bytes(sop))
    for cut in (len(data) // 2, 100, 10):
        with pytest.raises((OSError, ValueError)):
            jpeg2000.decode_jpeg2000(data[:cut])
    with pytest.raises(ValueError, match="not a JPEG 2000"):
        jpeg2000.decode_jpeg2000(b"\x00" * 20)


def test_icns_entries():
    """ICNS whose 128^2 entry is a JP2, a 9/7 codestream or a layered 9/7
    JP2 read as Pillow reads them; one whose entry's code-block style is
    not 0 is refused naming the ICNS entry and the style; an entry of a
    size the file's sizes do not give fails as in Pillow."""
    for name in ("j2k_entry.icns", "j2k_97.icns", "j2k_layers.icns"):
        assert sha(image.decode_image(read(name)).tobytes()) == digests.JPEG2000_DECODE[name]
    with pytest.raises(NotImplementedError, match="ICNS entry in JPEG 2000.*code-block style"):
        image.decode_image(read("j2k_style.icns"))
    odd = tif.icns_file([(b"ic07", tif.pillow_file(smooth(40, 56, 4, 35), "x.jp2"))])
    with pytest.raises(ValueError, match="not one of the allowed sizes") as ref:
        Image.open(io.BytesIO(odd)).convert("RGBA")
    with pytest.raises(ValueError) as ours:
        image.decode_image(odd)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the JAX package on the same files
# ---------------------------------------------------------------------------

JAX_READ = ("frame.jp2", "frame_rgba.j2k", "grey.jp2", "depth16.j2k", "la.jp2", "rct.jp2",
            "cblk32.j2k", "ict_rgba.jp2", "order_pcrl.j2k", "tiles_col1.j2k", "i97_i16.jp2",
            "signed_rgb.jp2")
# the kinds of Pillow's other settings among them, each a blob's texture
JAX_SETTINGS = JAX_READ[7:]


@pytest.mark.parametrize("name", JAX_READ)
def test_texture_and_panorama_match_jax(name):
    """``Texture(path)`` and the light map's panorama reader (OpenCV's
    reading, unscaled: the names end in neither .png nor .jpg)."""
    np.testing.assert_array_equal(Texture(fixture(name)).pixels, jsl.Texture(fixture(name)).pixels)
    got, ref = plm._load_hdr_image(fixture(name)), jlm._load_hdr_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_image_loader_matches_jax(tmp_path):
    """A folder of JPEG 2000 files under names the loaders take (both read
    a file by its bytes): one thread, one seed, the same textures."""
    for i, name in enumerate(JAX_READ):
        shutil.copyfile(fixture(name), tmp_path / f"{i}_{name.replace('.', '_')}.png")
    port = ImageLoader(str(tmp_path), seed=8, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=8, num_threads=1)
    try:
        for _ in range(10):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    return write_jpeg2000_fixtures(str(tmp_path_factory.mktemp("j2k")), subdiv=2)


@pytest.fixture(scope="module")
def settings_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("j2k_settings"))


@pytest.mark.parametrize("name", ("obj_jp2", "glb_jp2"))
def test_document_matches_jax(scene_files, name):
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    twin = scene_files[name.split("_")[0] + "_png"]
    twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
    np.testing.assert_array_equal(port.images[0], twin_doc.images[0])


def test_atlas_matches_jax(scene_files):
    """The scene atlas of the JP2-textured blob and GLB is the JAX
    package's, bitwise; the codestream plane and the JP2 panorama are their
    twins'."""
    meshes = [scene_files["obj_jp2"], scene_files["glb_jp2"]]
    pa = patlas.build_scene_atlas([Object(Mesh(p, physics=False)) for p in meshes], "cpu")
    ja = to_numpy(jax_build_scene_atlas([jsl.Object(jsl.Mesh(p, physics=False)) for p in meshes]))
    for field in pa._fields:
        got, want = getattr(pa, field), getattr(ja, field)
        if field == "num_objects":
            assert got == int(want) == 2
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    plane = Texture(scene_files["plane_j2k"]).pixels
    np.testing.assert_array_equal(plane, jsl.Texture(scene_files["plane_j2k"]).pixels)
    np.testing.assert_array_equal(plane, Texture(scene_files["plane_png"]).pixels)
    d = os.path.dirname(scene_files["ibl_jp2"])
    sky = plm._load_hdr_image(os.path.join(d, "sky.jp2"))
    np.testing.assert_array_equal(sky, jlm._load_hdr_image(os.path.join(d, "sky.jp2")))
    np.testing.assert_array_equal(sky, plm._load_hdr_image(os.path.join(d, "sky_jp2.bmp")))


@pytest.mark.parametrize("name", JAX_SETTINGS)
def test_settings_atlas_matches_jax(settings_dir, name):
    """The blob textured (.mtl) from each kind of Pillow's other settings
    (9/7 + ICT RGBA, layered PCRL, tiled with offsets, 16-bit 9/7, signed):
    the scene atlas is the JAX package's, bitwise, and its texture the PNG
    twin's."""
    fx = write_jpeg2000_settings_fixtures(settings_dir, subdiv=2, base_color=name)
    pa = patlas.build_scene_atlas([Object(Mesh(fx["obj_j2k"], physics=False))], "cpu")
    ja = to_numpy(jax_build_scene_atlas([jsl.Object(jsl.Mesh(fx["obj_j2k"], physics=False))]))
    for field in pa._fields:
        if field != "num_objects":
            np.testing.assert_array_equal(getattr(pa, field).numpy(), getattr(ja, field),
                                          err_msg=field)
    twin = patlas.build_scene_atlas([Object(Mesh(fx["obj_png"], physics=False))], "cpu")
    np.testing.assert_array_equal(pa.tex_combo.numpy(), twin.tex_combo.numpy())


def test_settings_scene_matches_jax(settings_dir):
    """Phase 25's scene textures: the layered 9/7 + ICT blob (.mtl and GLB)
    and the tiled checker plane, as the JAX package reads them and as
    their PNG twins hold them."""
    fx = write_jpeg2000_settings_fixtures(settings_dir, subdiv=2)
    for key in ("obj_j2k", "glb_j2k"):
        port = load_obj(fx[key]) if key.startswith("obj") else load_gltf(fx[key])
        ref = jax_obj(fx[key]) if key.startswith("obj") else jax_gltf(fx[key])
        assert_same(port, ref)
        twin = fx[key.split("_")[0] + "_png"]
        twin_doc = load_obj(twin) if key.startswith("obj") else load_gltf(twin)
        np.testing.assert_array_equal(port.images[0], twin_doc.images[0])
    plane = Texture(fx["plane_j2k"]).pixels
    np.testing.assert_array_equal(plane, jsl.Texture(fx["plane_j2k"]).pixels)
    np.testing.assert_array_equal(plane, Texture(fx["plane_png"]).pixels)
