"""AVIF as OpenCV writes it and what the port's AV1 decoder reads beyond
8-bit colour: quantizer matrices, monochrome colour items, 10- and 12-bit
samples and film grain (``assets/avif.py`` over ``csrc/sl_av1.cpp``),
against Pillow 12.1.0 (libavif 1.3.0, dav1d 1.5.1), OpenCV 5.0.0 (libavif
1.4.2, aom) and the JAX package.

- The tables header ``csrc/sl_av1_tables_hbd.h`` at its digest, and made
  again from the two installed libraries.
- Every fixture of ``AVIF_CV2_FILES`` to the digests of Pillow's and
  OpenCV's readings (the card's host checks the same), and against both
  libraries here with dtype and shape; the quantizer matrix levels and
  transform sizes and the film grain they exercise.
- libavif's conversions to RGB (Pillow's 8-bit RGB and RGBA, OpenCV's RGB
  at the image's depth) on random planes of each depth, subsampling,
  range and matrix, through ctypes into both libraries.
- A seeded sweep of OpenCV's and Pillow's writers (``torch_image_fixtures.
  avif_cv2_sweep_case``).
- The 8-bit files and the encoder the reconstruction shares with the
  decoder: unchanged digests.
- ``Texture`` and the light map's panorama reader against the JAX package.
"""

import ctypes
import hashlib

import numpy as np
import pytest

import stillleben_tpu as jsl
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets import avif, image, native_image
from stillleben_tpu_torch.assets.image_fixtures import (AVIF_CV2_FILES, AVIF_FILES,
                                                        AVIF_TOOL_FILES, QM_LEVEL_FILES,
                                                        av1_tables, avif_write_sources, digests)
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import light_map as plm
from torch_image_fixtures import AVIF_FORMATS, libavif_image, libavif_library

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def read(name: str) -> bytes:
    with open(fixture(name), "rb") as f:
        return f.read()


def test_tables_header_digest():
    with open(av1_tables.HEADER, "rb") as f:
        assert sha(f.read()) == av1_tables.HEADER_SHA256


def test_tables_header_from_the_libraries():
    """Both libraries' copies agree, sit where the module says, and give the
    committed header byte for byte."""
    tables = av1_tables.read_tables()
    assert tables["qm"].shape == (15, 2, 3344) and tables["gauss"].shape == (2048,)
    assert av1_tables.qm_offsets()[:4] == [0, 16, 80, 336]
    with open(av1_tables.HEADER) as f:
        assert av1_tables.header_text(tables) == f.read()


@pytest.mark.parametrize("name", AVIF_CV2_FILES)
def test_fixture_readings(name):
    """Each fixture's bytes, and the port's readings against the digests of
    Pillow's and OpenCV's ("None" where OpenCV reads nothing)."""
    data = read(name)
    assert sha(data) == digests.AVIF_FILE[name]
    assert sha(image.read_image(fixture(name)).tobytes()) == digests.AVIF_DECODE[name]
    cv = image.read_image_cv2(fixture(name))
    assert ("None" if cv is None else sha(cv.tobytes())) == digests.AVIF_DECODE_CV2[name]


@pytest.mark.parametrize("name", AVIF_CV2_FILES)
def test_readings_match_the_libraries(name):
    """The same against Pillow and OpenCV here, with dtype and shape: uint16
    BGR at 10 and 12 bits and a (H, W) luma plane for a monochrome item in
    OpenCV's reading, 8-bit RGBA in Pillow's."""
    ref = np.asarray(Image.open(fixture(name)).convert("RGBA"))
    got = image.read_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    ref = cv2.imread(fixture(name), CV2_FLAGS)
    got = image.read_image_cv2(fixture(name))
    if ref is None:
        assert got is None
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_what_the_fixtures_exercise():
    """Quantizer matrices at every level 0-14, weighing every transform size
    (64-sized ones reading the 32-sized weights); OpenCV's defaults take
    them; film grain at 8, 10 and 12 bits in every subsampling; 10- and
    12-bit and monochrome items."""
    levels, tx, grain, kinds = set(), 0, set(), set()
    for name in AVIF_CV2_FILES:
        color = avif.parse_avif(read(name), name).color
        info = native_image.av1_info(color, name)
        if info["using_qmatrix"]:
            levels.add(info["qm_y"])
            tx |= native_image.av1_decode_counts(color, name)["qm_tx_sizes"]
        sub = "4:0:0" if info["monochrome"] else ("4:4:4", "4:4:0", "4:2:2", "4:2:0")[
            info["subsampling_x"] * 2 + info["subsampling_y"]]
        kinds.add((info["bit_depth"], sub))
        if info["apply_grain"]:
            grain.add((info["bit_depth"], sub))
    assert levels == set(range(15)) and tx == (1 << 19) - 1
    assert [native_image.av1_info(avif.parse_avif(read(n)).color)["qm_y"]
            for n in QM_LEVEL_FILES] == list(range(15))
    assert native_image.av1_info(avif.parse_avif(read("cv2_bgr.avif")).color)["using_qmatrix"]
    assert {d for d, _ in grain} == {8, 10, 12}
    assert {s for _, s in grain} == {"4:2:0", "4:2:2", "4:4:4", "4:0:0"}
    assert {(10, "4:0:0"), (12, "4:0:0"), (8, "4:0:0"), (10, "4:2:0"), (12, "4:2:0")} <= kinds


def test_refusals_by_name():
    """What the port still refuses among these readings, by name: the
    identity matrix on subsampled 10-bit colour or on a monochrome item (a
    patched ``colr``; libavif refuses the first too)."""
    from stillleben_tpu_torch.assets.image_fixtures import patch_colr

    for name, what in (("cv2_bgr10.avif", "identity matrix on 4:2:0"),
                       ("cv2_grey.avif", "identity matrix on monochrome")):
        data = patch_colr(read(name), 0, True)
        for decode in (avif.decode_avif, avif.decode_avif_cv2):
            with pytest.raises(NotImplementedError, match=what):
                decode(data, name)


# ---------------------------------------------------------------------------
# libavif's conversions, through ctypes into both libraries
# ---------------------------------------------------------------------------

SUBSAMPLING = {"4:4:4": (0, 0), "4:2:2": (1, 0), "4:2:0": (1, 1), "4:0:0": (1, 1)}


class RGBImage(ctypes.Structure):  # avifRGBImage of libavif 1.3.0 and 1.4.2
    _fields_ = [(k, ctypes.c_uint32) for k in ("width", "height", "depth")] + [
        (k, ctypes.c_int) for k in ("format", "chromaUpsampling", "chromaDownsampling",
                                    "avoidLibYUV", "ignoreAlpha", "alphaPremultiplied", "isFloat",
                                    "maxThreads")] + [
        ("pixels", ctypes.c_void_p), ("rowBytes", ctypes.c_uint32)]


def libavif_rgb(which: str, planes: list, alpha, depth: int, fmt: str, full: bool, matrix: int,
                rgb_depth: int) -> np.ndarray:
    """libavif's ``avifImageYUVToRGB`` of the planes (and alpha) to RGB
    (without alpha) or RGBA (with it) of ``rgb_depth`` bits: Pillow's
    bundled libavif 1.3.0 (``which`` "pillow") or OpenCV's 1.4.2."""
    lib = libavif_library(which)
    img = libavif_image(lib, planes, alpha, depth, fmt, full, matrix)
    try:
        rgb = RGBImage()
        lib.avifRGBImageSetDefaults(ctypes.byref(rgb), img)
        h, w = planes[0].shape
        c = 4 if alpha is not None else 3
        rgb.format, rgb.depth = (1 if c == 4 else 0), rgb_depth
        out = np.zeros((h, w, c), np.uint8 if rgb_depth == 8 else np.uint16)
        rgb.pixels, rgb.rowBytes = out.ctypes.data, w * c * out.itemsize
        assert lib.avifImageYUVToRGB(img, ctypes.byref(rgb)) == 0
        return out
    finally:
        lib.avifImageDestroy(img)


def random_planes(rng, h: int, w: int, depth: int, fmt: str) -> list:
    sx, sy = SUBSAMPLING[fmt]
    dt = np.uint16 if depth > 8 else np.uint8
    sizes = [(h, w)] + ([] if fmt == "4:0:0" else [((h + sy) >> sy, (w + sx) >> sx)] * 2)
    return [rng.integers(0, 1 << depth, s).astype(dt) for s in sizes]


@pytest.mark.parametrize("depth", (8, 10, 12))
@pytest.mark.parametrize("fmt", tuple(AVIF_FORMATS))
def test_conversions_are_libavifs(depth, fmt):
    """Pillow's reading (8-bit RGB without alpha, RGBA with it) and OpenCV's
    (RGB at the image's depth, above 8 bits) of random planes are the
    libraries' own, sample for sample: each range, BT.601 and BT.709
    matrices (and the identity of full-range 4:4:4 above 8 bits), odd and
    tiny sizes, the alpha narrowed as Pillow's libavif narrows it."""
    rng = np.random.default_rng(depth * 10 + AVIF_FORMATS[fmt])
    for h, w in ((13, 17), (1, 1), (2, 5), (6, 1)):
        for full in (True, False):
            for matrix in (0, 1, 2, 6) if fmt == "4:4:4" and full and depth > 8 else (1, 2, 6):
                planes = random_planes(rng, h, w, depth, fmt)
                for with_alpha in (False, True):
                    a = random_planes(rng, h, w, depth, "4:0:0")[0] if with_alpha else None
                    ref = libavif_rgb("pillow", planes, a, depth, fmt, full, matrix, 8)
                    got, by_float = avif._pillow_rgba(tuple(planes), depth, SUBSAMPLING[fmt],
                                                      matrix, full, a, "x")
                    if a is not None:
                        got[..., 3] = a if depth == 8 else avif._alpha8(a, depth, by_float)
                    np.testing.assert_array_equal(got[..., :ref.shape[2]], ref,
                                                  err_msg=f"{h}x{w} {full} {matrix} {with_alpha}")
                if depth > 8 and fmt != "4:0:0":
                    ref = libavif_rgb("opencv", planes, None, depth, fmt, full, matrix, depth)
                    got = (avif._identity(tuple(planes), depth, (0, 0), True, "x", np.uint16)
                           if matrix == 0 else
                           native_image.yuv16_to_rgba(tuple(planes), depth, SUBSAMPLING[fmt],
                                                      matrix, full, native_image.YUV16_FLOAT))
                    np.testing.assert_array_equal(got[..., :3], ref)


# ---------------------------------------------------------------------------
# seeded files of OpenCV's and Pillow's writers
# ---------------------------------------------------------------------------

SWEEP = 60


@pytest.mark.parametrize("i", range(SWEEP))
def test_seeded_writers(i):
    """OpenCV's ``imwrite`` at depths 8, 10 and 12 of grey, BGR and BGRA at
    qualities 0-100, and Pillow's 4:0:0 and quantizer matrices at random
    ``qm-min`` / ``qm-max``: read as both libraries read them."""
    from torch_image_fixtures import avif_cv2_sweep_one

    assert avif_cv2_sweep_one(i) == (i, "")


# ---------------------------------------------------------------------------
# the 8-bit files and the encoder, which shares the reconstruction
# ---------------------------------------------------------------------------

def test_8bit_files_and_encoder_unchanged():
    """Every 8-bit fixture of the earlier slices reads to its digests, and
    the port's encoder writes ``avif_write_sources()`` to ``AVIF_ENCODE``:
    the 16-bit planes and the clamps of every depth left the 8-bit
    arithmetic as it was."""
    wrong = []
    for name in AVIF_FILES + AVIF_TOOL_FILES:
        data = read(name)
        if sha(image.decode_image(data, name).tobytes()) != digests.AVIF_DECODE[name]:
            wrong.append(name)
        if sha(image.read_image_cv2(fixture(name)).tobytes()) != digests.AVIF_DECODE_CV2[name]:
            wrong.append(f"OpenCV's {name}")
    for name, a in avif_write_sources().items():
        if sha(avif.encode_avif(a, name)) != digests.AVIF_ENCODE[name]:
            wrong.append(f"the encoding of {name}")
    assert not wrong


# ---------------------------------------------------------------------------
# the JAX package on the same files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("cv2_bgr.avif", "cv2_grey.avif", "cv2_bgra10.avif",
                                  "cv2_sky10.avif", "cv2_sky12.avif", "cv2_grey12.avif"))
def test_texture_and_panorama_match_jax(name):
    """``Texture(path)`` (Pillow's 8-bit RGBA) and the light map's panorama
    reader (OpenCV's reading: uint16 samples unscaled, the names end in
    neither .png nor .jpg; a grey item stacked to three channels)."""
    np.testing.assert_array_equal(Texture(fixture(name)).pixels, jsl.Texture(fixture(name)).pixels)
    got, ref = plm._load_hdr_image(fixture(name)), jlm._load_hdr_image(fixture(name))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if "10" in name or "12" in name:
        assert ref.max() > 255
