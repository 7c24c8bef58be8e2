"""AVIF beyond Pillow's defaults in the port's reading (``assets/avif.py``
over the native AV1 decoder, ``csrc/sl_av1.cpp`` with its CDEF and loop
restoration in ``csrc/sl_av1_post.h``) against Pillow 12.1.0 (libavif
1.3.0, dav1d 1.5.1), OpenCV 5.0.0 (libavif 1.4.2) and the JAX package.

- Every fixture of ``image_fixtures.AVIF_TOOL_FILES`` (loop restoration at
  speeds 0 to 4, CDEF, 4:4:4 and 4:2:2, lossless, BT.709 and the identity
  matrix, a limited-range alpha) to the digests of Pillow's and OpenCV's
  readings (the card's host checks the same), and to the libraries here.
- The decoder's counts (``native_image.av1_decode_counts``) over those
  fixtures: each of these tools is reached.
- Seeded round trips through Pillow's writer at speeds 0 to 6, 4:2:0, 4:2:2
  and 4:4:4, qualities 30 to 100, RGB and RGBA, each read as Pillow and
  OpenCV read it, bitwise.
- The JAX package on the new kinds: ``Texture``, the light map's panorama
  reader, ``ImageLoader``, and the documents of a blob whose base colour
  is a speed-4 4:4:4 AVIF.
"""

import hashlib
import shutil

import numpy as np
import pytest

import stillleben_tpu as jsl
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets import avif, image, native_image
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image_fixtures import AVIF_TOOL_FILES, digests, patch_colr
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_avif_fixtures
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import light_map as plm
from test_torch_loaders import assert_same
from torch_image_fixtures import smooth

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def read(name: str) -> bytes:
    with open(fixture(name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", AVIF_TOOL_FILES)
def test_tool_fixture_readings(name):
    """Each fixture's bytes, and the port's readings against the digests of
    Pillow's and OpenCV's."""
    assert sha(read(name)) == digests.AVIF_FILE[name]
    assert sha(image.read_image(fixture(name)).tobytes()) == digests.AVIF_DECODE[name]
    assert sha(image.read_image_cv2(fixture(name)).tobytes()) == digests.AVIF_DECODE_CV2[name]


@pytest.mark.parametrize("name", AVIF_TOOL_FILES)
def test_tool_fixtures_match_the_libraries(name):
    """The same against Pillow and OpenCV here, with dtype and shape."""
    ref = np.asarray(Image.open(fixture(name)).convert("RGBA"))
    got = image.read_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    ref = cv2.imread(fixture(name), CV2_FLAGS)
    got = image.read_image_cv2(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# what the fixtures reach in the decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def counts():
    """``av1_decode_counts`` of every AV1 item (colour and alpha) of the
    tool fixtures, by (file, item)."""
    out = {}
    for name in AVIF_TOOL_FILES:
        items = avif.parse_avif(read(name), name)
        for item, obus in (("color", items.color), ("alpha", items.alpha)):
            if obus is not None:
                out[name, item] = native_image.av1_decode_counts(obus, name)
    return out


def _any(counts, test):
    return [k for k, c in counts.items() if test(c)]


# each tool of loop restoration, CDEF, 4:4:4, 4:2:2 and lossless frames, and
# how a decode's counts show it
REACHED = {
    "Wiener units": lambda c: c["wiener_y"] and c["wiener_u"] and c["wiener_v"],
    "self-guided units": lambda c: c["sgrproj_y"] and c["sgrproj_u"] and c["sgrproj_v"],
    "a switchable frame": lambda c: 3 in (c["lr_type_y"], c["lr_type_u"], c["lr_type_v"]),
    "lr_unit_shift 0": lambda c: c["lr_unit_shift"] == 0,
    "lr_unit_shift 1": lambda c: c["lr_unit_shift"] == 1,
    "lr_unit_shift 2": lambda c: c["lr_unit_shift"] == 2,
    "a self-guided set with r0 = 0 or r1 = 0": lambda c: c["sgr_sets"] & 0xFC00,
    "CDEF luma primary": lambda c: c["cdef_y_pri"],
    "CDEF luma secondary": lambda c: c["cdef_y_sec"],
    "CDEF chroma primary": lambda c: c["cdef_uv_pri"],
    "CDEF chroma secondary": lambda c: c["cdef_uv_sec"],
    "CDEF before luma Wiener": lambda c: c["cdef_y_pri"] and c["wiener_y"],
    "CDEF before luma self-guided": lambda c: c["cdef_y_pri"] and c["sgrproj_y"],
    "4:2:2 CfL": lambda c: c["subsampling"] == 2 and c["cfl"],
    "4:4:4 CfL": lambda c: c["subsampling"] == 0 and c["cfl"],
    "4:2:2 chroma palettes": lambda c: c["subsampling"] == 2 and c["palette_uv"],
    "4:4:4 chroma palettes": lambda c: c["subsampling"] == 0 and c["palette_uv"],
    "4:2:2 chroma transforms 4x8 and 8x16": lambda c: c["subsampling"] == 2 and (
        c["uv_tx_sizes"] >> 5) & 1 and (c["uv_tx_sizes"] >> 7) & 1,
    "4:4:4 chroma transforms 32x32": lambda c: c["subsampling"] == 0 and (c["uv_tx_sizes"] >> 3) & 1,
    "lossless 4:2:0 blocks": lambda c: c["subsampling"] == 3 and c["lossless"],
    "lossless 4:2:2 blocks": lambda c: c["subsampling"] == 2 and c["lossless"],
    "lossless 4:4:4 blocks": lambda c: c["subsampling"] == 0 and c["lossless"],
}


@pytest.mark.parametrize("tool", REACHED)
def test_fixtures_reach_each_tool(counts, tool):
    if tool == "lossless 4:2:0 blocks":  # lossless.avif, one of AVIF_FILES
        counts = {("lossless.avif", "color"): native_image.av1_decode_counts(
            avif.parse_avif(read("lossless.avif")).color)}
    assert _any(counts, REACHED[tool]), tool


def test_counts_of_a_plain_frame():
    """Pillow's default file (speed 6) restores nothing and has no CDEF."""
    c = native_image.av1_decode_counts(avif.parse_avif(read("frame.avif")).color)
    assert c["lr_unit_shift"] == -1 and c["cdef_bits"] == -1 and c["subsampling"] == 3
    assert not any(c[k] for k in ("wiener_y", "sgrproj_y", "cdef_y_pri", "lossless"))


def _spec_wiener(plane, taps, inter_range):
    """The Wiener filter of the AV1 specification (7.17.4) for 8-bit
    samples, written out: the horizontal filter, its intermediate rounded
    by InterRound0 = 3 and clipped to ``inter_range``, the vertical filter
    rounded by InterRound1 = 11; the plane's edges repeat."""
    h, w = plane.shape

    def taps7(c):
        return (c[0], c[1], c[2], 128 - 2 * sum(c), c[2], c[1], c[0])

    vf, hf = taps7(taps[:3]), taps7(taps[3:])
    pad = np.pad(plane.astype(np.int64), 3, mode="edge")
    inter = sum(hf[t] * pad[:, t:t + w] for t in range(7))
    inter = np.clip((inter + 4) >> 3, *inter_range)
    out = sum(vf[t] * inter[t:t + h] for t in range(7))
    return np.clip((out + 1024) >> 11, 0, 255).astype(np.uint8)


# the intermediate's range at 8 bits: -offset to limit - offset, offset
# 1 << 11, limit (1 << 13) - 1
SPEC_INTER = (-(1 << 11), (1 << 13) - 1 - (1 << 11))
WIENER_MIN, WIENER_MAX = (-5, -23, -17), (10, 8, 46)


@pytest.mark.parametrize("case", ("dark centre", "bright centre", "seeded"))
def test_wiener_clips_its_intermediate_as_the_specification(case):
    """The port's Wiener filter equals the specification's arithmetic on
    planes whose horizontal pass leaves the intermediate's range, on both
    sides, with taps at the ends of their legal ranges; the cases are such
    that a wider clip (-8192 to 8191) gives other pixels."""
    rng = np.random.default_rng(2317)
    if case == "dark centre":  # -2104 clipped to -2048, the rows around it 4080
        planes = [np.full((7, 7), 255, np.uint8)]
        planes[0][3, 3] = 0
        taps = [(0, 0, 46, -5, -23, -5)]
    elif case == "bright centre":  # 6184 clipped to 6143
        planes = [np.zeros((7, 9), np.uint8)]
        planes[0][3, 4] = 255
        planes[0][2, 3:6] = planes[0][4, 3:6] = (255, 0, 255)
        taps = [(-5, -23, 46, -5, -23, -5)]
    else:
        planes = [rng.choice(np.array((0, 255), np.uint8), (9, 11)) for _ in range(200)]
        taps = [tuple(int(rng.integers(WIENER_MIN[i % 3], WIENER_MAX[i % 3] + 1)) for i in range(6))
                for _ in planes]
    wider = 0
    for plane, t in zip(planes, taps):
        want = _spec_wiener(plane, t, SPEC_INTER)
        np.testing.assert_array_equal(native_image.av1_wiener(plane, t), want, err_msg=str(t))
        wider += not np.array_equal(_spec_wiener(plane, t, (-8192, 8191)), want)
    assert wider, "no case where the intermediate's clip changes a pixel"


def test_conversion_refusals_by_name():
    """The conversions libavif refuses or the port does not make: the
    identity matrix on subsampled or limited-range colour, and matrix
    coefficients other than 0, 1, 2, 5 and 6."""
    y = np.zeros((4, 4), np.uint8)
    with pytest.raises(NotImplementedError, match="identity matrix on 4:2:0"):
        native_image.yuv_to_rgba(y, y[:2, :2], y[:2, :2], (1, 1), 0, True)
    with pytest.raises(NotImplementedError, match="limited-range identity"):
        native_image.yuv_to_rgba(y, y, y, (0, 0), 0, False)
    data = patch_colr(read("lr_speed4.avif"), 9, True)
    with pytest.raises(NotImplementedError, match="matrix coefficients 9"):
        avif.decode_avif(data)


# ---------------------------------------------------------------------------
# seeded round trips through Pillow's writer
# ---------------------------------------------------------------------------

ROUND_TRIPS = 21
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4")


def _round_trip_cases():
    """(array, save options) of each seeded round trip: speeds 0 to 6 in
    turn, each subsampling, random, smooth or few-colour content, RGB or
    RGBA, quality 30 to 100, CDEF on in every fourth, up to 96 a side (48
    at speed 0)."""
    rng = np.random.default_rng(2300)
    out = []
    for i in range(ROUND_TRIPS):
        speed = i % 7
        top = 49 if speed == 0 else 97
        h, w = (int(v) for v in rng.integers(1, top, 2))
        c = 4 if i % 2 else 3
        kind = i % 3
        if kind == 0:
            a = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        elif kind == 1:
            a = smooth(h, w, c, 2300 + i)
        else:
            pal = rng.integers(0, 256, (4, c))
            a = pal[rng.integers(0, 4, (h // 4 + 1, w // 4 + 1))].repeat(4, 0).repeat(4, 1)
            a = a[:h, :w].astype(np.uint8)
        kw = {"speed": speed, "subsampling": SUBSAMPLINGS[i % 3],
              "quality": int(rng.integers(30, 101))}
        if i % 4 == 1:
            kw["advanced"] = {"enable-cdef": "1"}
        out.append((a, kw))
    return out


@pytest.fixture(scope="module")
def pillow_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("avif_tools")
    out = []
    for i, (a, kw) in enumerate(_round_trip_cases()):
        p = str(d / f"rt{i}.avif")
        Image.fromarray(a).save(p, **kw)
        out.append(p)
    return out


@pytest.mark.parametrize("i", range(ROUND_TRIPS))
def test_seeded_round_trip(pillow_files, i):
    p = pillow_files[i]
    np.testing.assert_array_equal(image.read_image(p), np.asarray(Image.open(p).convert("RGBA")))
    np.testing.assert_array_equal(image.read_image_cv2(p), cv2.imread(p, CV2_FLAGS))


def test_round_trips_cover_the_options():
    cases = [kw for _, kw in _round_trip_cases()]
    assert {kw["speed"] for kw in cases} == set(range(7))
    assert {kw["subsampling"] for kw in cases} == set(SUBSAMPLINGS)
    q = [kw["quality"] for kw in cases]
    assert min(q) < 40 and max(q) > 90
    assert {a.shape[2] for a, _ in _round_trip_cases()} == {3, 4}


# ---------------------------------------------------------------------------
# the JAX package on the new kinds
# ---------------------------------------------------------------------------

JAX_READ = ("lr_speed0.avif", "lr_rgba.avif", "cdef_q30.avif", "yuv444_s4_q60_rgba.avif",
            "yuv422_s6_q30.avif", "lossless_444.avif", "bt709_limited.avif", "identity_444.avif",
            "alpha_limited.avif")


@pytest.mark.parametrize("name", JAX_READ)
def test_texture_and_panorama_match_jax(name):
    """``Texture(path)`` and the light map's panorama reader (OpenCV's
    reading, unscaled 8-bit values in both: the names end in neither .png
    nor .jpg)."""
    np.testing.assert_array_equal(Texture(fixture(name)).pixels, jsl.Texture(fixture(name)).pixels)
    got, ref = plm._load_hdr_image(fixture(name)), jlm._load_hdr_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape and ref.max() > 10
    np.testing.assert_array_equal(got, ref)


def test_image_loader_matches_jax(tmp_path):
    """A folder of the new kinds under names the loaders take: one thread,
    one seed, the same textures."""
    for i, name in enumerate(JAX_READ):
        shutil.copyfile(fixture(name), tmp_path / f"{i}_{name.replace('.', '_')}.png")
    port = ImageLoader(str(tmp_path), seed=23, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=23, num_threads=1)
    try:
        for _ in range(10):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    return write_avif_fixtures(str(tmp_path_factory.mktemp("avif_tools_scene")), subdiv=2,
                               base_color="blob_basecolor_444_s4.avif", plane="checker_cdef.avif")


@pytest.mark.parametrize("name", ("obj_avif", "glb_avif"))
def test_document_matches_jax(scene_files, name):
    """The blob whose base colour is a speed-4 4:4:4 AVIF (restored), as
    OBJ and as a GLB with the AVIF embedded, against the JAX loaders and
    the PNG twin."""
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    twin = scene_files[name.split("_")[0] + "_png"]
    twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
    np.testing.assert_array_equal(port.images[0], twin_doc.images[0])


def test_plane_matches_jax(scene_files):
    """The CDEF checker plane as a texture, against the JAX package's and
    its PNG twin."""
    plane = Texture(scene_files["plane_avif"]).pixels
    np.testing.assert_array_equal(plane, jsl.Texture(scene_files["plane_avif"]).pixels)
    np.testing.assert_array_equal(plane, Texture(scene_files["plane_png"]).pixels)
