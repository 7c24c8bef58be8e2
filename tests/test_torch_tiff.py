"""The port's TIFF reading (``stillleben_tpu_torch/assets/tiff.py``, with
``lab.py`` and the native CCITT and ZSTD decoders ``csrc/sl_fax.cpp`` and
``csrc/sl_zstd.cpp``) against Pillow 12.1.0 and OpenCV 5.0.0 on the same
files, and the faults C-26 to C-29.

- Every committed file of the slice (``image_fixtures.TIFF_FILES``: JPEG,
  CCITT, LZMA, ZSTD, CMYK, YCbCr, CIELab, 32-bit float and integer,
  BigTIFF, WhiteIsZero, planar and predictor-3 files, and OpenCV's 16-bit
  and broken JPEG 2000 files): ``read_image`` bitwise equal to
  ``Image.open(p).convert("RGBA")`` or refused with Pillow's message,
  ``read_image_cv2`` equal to ``cv2.imread(p, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)`` in dtype, shape and values, or None where OpenCV
  gives None; the files remade byte-equal by their writers and their
  digests (``TIFF_FILE``, ``TIFF_DECODE``, ``TIFF_DECODE_CV2``).
- A seeded sweep (``torch_image_fixtures.tiff_sweep_case``, 360 cases):
  Pillow's writer over modes and codecs, the package's writer over
  photometric, sample type, layout, byte order, fill order, predictor and
  codec, held to both libraries. Two kinds are refused by name on the
  OpenCV path, where OpenCV reads memory it did not fill or fails only on
  some tiles: planar samples of more than 8 bits, and 8-bit tiles with
  FillOrder 2; the sweep counts them.
- Damaged files of each new codec, the codecs alone (CCITT at every width,
  ZSTD against libzstd), the colour conversions (CIELab through
  LittleCMS and through libtiff, YCbCr through libtiff) on seeded samples.
"""

import ctypes
import glob
import hashlib
import io
import os

import numpy as np
import pytest

import torch_image_fixtures as tf
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import image, jpeg2000, lab, native_image, tiff
from stillleben_tpu_torch.assets.image_fixtures import TIFF_FILES, TIFF_WRITTEN
from stillleben_tpu_torch.assets.image_fixtures import digests as D
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_fixtures.tiff_files import tiff_fixtures
from stillleben_tpu_torch.render import light_map as plm

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
# the port's refusals by name where OpenCV reads (see the module)
CV2_REFUSED = ("as interleaved samples", "bit-reversed tiles")
SWEEP_GROUPS, SWEEP_GROUP = 30, 12


def assert_reads_as_libraries(data: bytes, path: str) -> bool:
    """Pillow's and OpenCV's readings of ``data`` written at ``path`` against
    the port's; False where the port refuses OpenCV's by name."""
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = np.asarray(Image.open(path).convert("RGBA"))
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        kind = OSError if isinstance(e, OSError) else type(e)
        with pytest.raises(kind) as got:
            image.read_image(path)
        assert str(got.value) == str(e), (str(got.value), str(e))
    else:
        got = image.read_image(path)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    want = cv2.imread(path, CV2_FLAGS)
    try:
        have = image.read_image_cv2(path)
    except NotImplementedError as e:
        assert any(r in str(e) for r in CV2_REFUSED), str(e)
        return False
    if want is None:
        assert have is None
    else:
        assert have is not None and have.dtype == want.dtype and have.shape == want.shape
        np.testing.assert_array_equal(have, want)
    return True


@pytest.mark.parametrize("name", TIFF_FILES)
def test_fixture_reads_as_libraries(name, tmp_path):
    """Each committed file both ways, and to its digests."""
    with open(fixture(name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == D.TIFF_FILE[name]
    assert_reads_as_libraries(data, str(tmp_path / name))
    assert tf.port_tiff_reading(data, name) == D.TIFF_DECODE[name]
    have = image.read_image_cv2(fixture(name))
    assert ("None" if have is None else tf.array_reading(have)) == D.TIFF_DECODE_CV2[name]


def test_fixtures_remade():
    """The writers make the committed bytes again: Pillow's and OpenCV's
    files here, the package's numpy writer anywhere (the card's host remakes
    ``TIFF_WRITTEN``); the digests are the libraries' readings."""
    files = tf.make_tiff_fixtures()
    assert sorted(files) == sorted(TIFF_FILES)
    for name, data in files.items():
        with open(fixture(name), "rb") as f:
            assert _ifd_pad_cleared(f.read()) == _ifd_pad_cleared(data), name
    assert sorted(tiff_fixtures()) == sorted(TIFF_WRITTEN)
    digests = tf.tiff_digests(files)
    assert digests["TIFF_DECODE"] == D.TIFF_DECODE
    assert digests["TIFF_DECODE_CV2"] == D.TIFF_DECODE_CV2


def _ifd_pad_cleared(data: bytes) -> bytes:
    """libtiff writes the IFD at an even offset and leaves the byte before it
    unwritten where the last strip ends at an odd one: that byte zeroed."""
    if data[:4] != b"II*\x00":
        return data
    ifd = int.from_bytes(data[4:8], "little")
    _, t = tiff._tags(data, "x")
    offsets, counts = t.get(273) or t.get(324, ()), t.get(279) or t.get(325, ())
    if ifd % 2 == 0 and offsets and max(o + c for o, c in zip(offsets, counts)) == ifd - 1:
        return data[: ifd - 1] + b"\x00" + data[ifd:]
    return data


@pytest.mark.parametrize("group", range(SWEEP_GROUPS))
def test_sweep_reads_as_libraries(group, tmp_path):
    """Seeded files (``tiff_sweep_case``) both ways; the OpenCV refusals by
    name stay few."""
    refused = 0
    for i in range(group * SWEEP_GROUP, (group + 1) * SWEEP_GROUP):
        label, data = tf.tiff_sweep_case(i)
        if data:  # libtiff's encoder takes the settings
            refused += not assert_reads_as_libraries(data, str(tmp_path / f"case{i}.tif"))
    assert refused <= SWEEP_GROUP // 3


# --- the faults ------------------------------------------------------------


@pytest.mark.parametrize("name", ("cv2_rgb16.jp2", "cv2_rgba16.jp2"))
def test_c26_16bit_jp2_rounds_as_pillow(name):
    """OpenCV's 16-bit RGB and RGBA JPEG 2000: Pillow's ((s + 128) >> 8) & 255
    of every sample (the high byte would differ at about half)."""
    got = image.read_image(fixture(name))
    assert hashlib.sha256(got.tobytes()).hexdigest() == D.TIFF_DECODE[name]
    s = cv2.imread(fixture(name), cv2.IMREAD_UNCHANGED).astype(np.int64)
    s[..., :3] = s[..., 2::-1]
    np.testing.assert_array_equal(got[..., : s.shape[2]], ((s + 128) >> 8) & 255)


def test_c26_grey_alpha_16bit_rounds_too():
    """A 16-bit grey + alpha codestream (the port's encoder; neither library
    writes one): Pillow rounds its two components the same way."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 65536, (21, 17, 2)).astype(np.uint16)
    a[0, :6, 0] = (65535, 65408, 65407, 127, 128, 383)
    data = native_image.j2k_encode(a)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = jpeg2000.decode_jpeg2000(data, "la16.j2k")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[..., [0, 3]], ((a.astype(np.int64) + 128) >> 8) & 255)


@pytest.mark.parametrize("name", ("bigtiff_rgb.tif", "bigtiff_le.tif", "bigtiff_be.tif"))
def test_c27_bigtiff(name, tmp_path):
    """BigTIFF: Pillow's ``big_tiff=True`` and the writer's (LONG8 offsets, an
    SLONG8 and an IFD8 entry, both byte orders; Pillow 12.1.0 identifies no
    big-endian one, OpenCV reads both)."""
    with open(fixture(name), "rb") as f:
        data = f.read()
    assert data[:4] in (b"II+\x00", b"MM\x00+")
    assert_reads_as_libraries(data, str(tmp_path / name))
    assert image.read_image_cv2(fixture(name)) is not None
    _, tags = tiff._tags(data, name)
    if name == "bigtiff_le.tif":
        assert tags[65000] == (-5, 1 << 40) and tags[65001] == (0,)


@pytest.mark.parametrize("name, pillow, cv2_none", [
    ("cv2_float_rgb.tif", "cannot identify image file", False),
    ("cv2_float_rgb_pred3.tif", "cannot identify image file", False),
    ("cv2_float_rgba.tif", "cannot identify image file", True),
    ("lzma_rgb.tif", None, True), ("zstd_rgb.tif", None, True)])
def test_c28_refused_as_the_library(name, pillow, cv2_none):
    """Pillow identifies no mode for float32 RGB or RGBA; OpenCV's libtiff has
    no LZMA or ZSTD codec and asserts on a 4-channel float32."""
    if pillow:
        with pytest.raises(OSError, match=pillow):
            image.read_image(fixture(name))
    else:
        assert image.read_image(fixture(name)).shape[2] == 4
    assert (image.read_image_cv2(fixture(name)) is None) == cv2_none


def test_c28_light_map_takes_the_pillow_fallback():
    """An LZMA panorama: OpenCV reads nothing, so the JAX loader's Pillow
    fallback (``convert("RGB") / 255`` to the power 2.2) gives the floats."""
    got = plm._load_hdr_image(fixture("lzma_rgb.tif"))
    rgb = np.asarray(Image.open(fixture("lzma_rgb.tif")).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(got, rgb ** 2.2)


def test_c29_jp2_without_codestream():
    """The 77 bytes ``cv2.imwrite`` leaves when its encoder fails: Pillow's
    broken data stream, None for OpenCV."""
    with open(fixture("cv2_broken.jp2"), "rb") as f:
        data = f.read()
    assert len(data) == 77
    with pytest.raises(OSError, match="broken data stream when reading image file"):
        Image.open(fixture("cv2_broken.jp2")).convert("RGBA")
    with pytest.raises(OSError, match="broken data stream when reading image file"):
        image.read_image(fixture("cv2_broken.jp2"))
    assert cv2.imread(fixture("cv2_broken.jp2"), CV2_FLAGS) is None
    assert image.read_image_cv2(fixture("cv2_broken.jp2")) is None


# --- damaged files -----------------------------------------------------------

DAMAGED = ("jpeg_rgb.tif", "jpeg_tiles_ycbcr.tif", "g3.tif", "g3_2d_fill2.tif", "ccitt_rle.tif",
           "lzma_rgb.tif", "zstd_rgb.tif", "cmyk_lzw.tif", "pred3_float.tif", "bigtiff_le.tif")


def _strips(data: bytes) -> tuple[int, int]:
    """The first strip or tile's offset and byte count."""
    _, t = tiff._tags(data, "x")
    return (t.get(273) or t[324])[0], (t.get(279) or t[325])[0]


@pytest.mark.parametrize("name", DAMAGED)
def test_damaged_raises_as_pillow(name, tmp_path):
    """Each codec's first strip or tile cut short (zeroed from a seeded
    point on), its bytes changed at seeded places, and the file cut inside
    it: where Pillow raises, the port raises the same class (its message
    too, unless Pillow's names a temporary path); where Pillow reads, so
    does the port, at Pillow's size. The pixels of a broken strip are not
    held: libtiff leaves what its decoder did not write as its buffer held
    it (Group 4 after a premature end), which no reader can know."""
    with open(fixture(name), "rb") as f:
        data = f.read()
    off, n = _strips(data)
    rng = np.random.default_rng(sum(map(ord, name)))
    variants = []
    for k in range(6):
        d = bytearray(data)
        if k % 2 == 0:
            cut = off + int(rng.integers(n // 4, n))
            d[cut: off + n] = bytes(off + n - cut)
        else:
            for _ in range(int(rng.integers(1, 4))):
                d[off + int(rng.integers(0, n))] ^= int(rng.integers(1, 256))
        variants.append(bytes(d))
    variants.append(data[: off + n // 2])
    for k, d in enumerate(variants):
        p = str(tmp_path / f"{k}_{name}")
        with open(p, "wb") as f:
            f.write(d)
        try:
            ref = np.asarray(Image.open(p).convert("RGBA"))
        except Exception as e:  # noqa: BLE001  (the reading is the exception)
            with pytest.raises(OSError if isinstance(e, OSError) else type(e)) as got:
                image.read_image(p)
            assert str(got.value) == str(e), (k, str(got.value), str(e))
        else:
            assert image.read_image(p).shape == ref.shape, k


# --- the codecs alone --------------------------------------------------------


@pytest.mark.parametrize("width", (1, 7, 8, 31, 64, 65, 200, 1729, 2561))
def test_ccitt_widths(width, tmp_path):
    """Group 3 (1-D and 2-D, fill order 1 and 2), Group 4 and modified
    Huffman at widths that reach every run-length code, through libtiff's
    encoder and the port's decoder."""
    rng = np.random.default_rng(width)
    rows = []
    for y in range(9):  # runs of every length: short, make-up and extended
        run = rng.integers(1, min(width, 64 if y % 3 else 2600) + 1, 64)
        v = np.repeat(np.arange(64) % 2, run)[:width]
        rows.append(np.pad(v, (0, width - len(v)), constant_values=v[-1]))
    px = (np.array(rows, np.uint8) ^ (rng.random((9, 1)) < 0.5)) * 255
    for comp, info in (("group3", {}), ("group3", {292: 1}), ("group3", {292: 5, 266: 2}),
                       ("group4", {}), ("group4", {266: 2}), ("tiff_ccitt", {})):
        d = tf.pillow_tiff(px, "1", compression=comp, tiffinfo=info)
        assert d, (comp, info)
        assert_reads_as_libraries(d, str(tmp_path / f"{comp}.tif"))


def _libzstd():
    lib = glob.glob(os.path.join(os.path.dirname(Image.__file__), "..", "pillow.libs",
                                 "libzstd*"))
    if not lib:
        pytest.skip("Pillow's bundled libzstd is not here")
    z = ctypes.CDLL(lib[0])
    z.ZSTD_createCCtx.restype = ctypes.c_void_p
    z.ZSTD_CCtx_setParameter.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    z.ZSTD_compress2.restype = ctypes.c_size_t
    z.ZSTD_compress2.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_size_t)
    z.ZSTD_isError.argtypes = (ctypes.c_size_t,)
    return z


def test_zstd_against_libzstd():
    """Seeded data at levels -5 to 19, with and without the checksum (one
    damaged checksum raises), through Pillow's libzstd and the port."""
    z = _libzstd()
    rng = np.random.default_rng(8)
    for i in range(60):
        n = int(rng.integers(1, 200000))
        kind = i % 4
        if kind == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            data = rng.integers(0, 4, n, dtype=np.uint8).tobytes()
        elif kind == 2:
            wave = np.sin(np.arange(n) / rng.uniform(1, 50)) * 100 + 100
            data = wave.astype(np.uint8).tobytes()
        else:
            data = np.repeat(rng.integers(0, 256, n // 7 + 1, dtype=np.uint8), 7)[:n].tobytes()
        cctx = z.ZSTD_createCCtx()
        z.ZSTD_CCtx_setParameter(cctx, 100, int(rng.integers(-5, 20)))  # ZSTD_c_compressionLevel
        z.ZSTD_CCtx_setParameter(cctx, 201, i % 2)  # ZSTD_c_checksumFlag
        buf = ctypes.create_string_buffer(n + n // 2 + 1024)
        size = z.ZSTD_compress2(cctx, buf, len(buf), data, n)
        assert not z.ZSTD_isError(size)
        frame = buf.raw[:size]
        assert native_image.zstd_decompress(frame, n) == data, i
        if i % 2:
            bad = frame[:-1] + bytes([frame[-1] ^ 1])
            with pytest.raises(ValueError, match="checksum"):
                native_image.zstd_decompress(bad, n)
    dict_frame = b"\x28\xb5\x2f\xfd\x01\x00\x2a\x01\x00\x00\x41"  # a dictionary ID in the header
    with pytest.raises(NotImplementedError, match="dictionary"):
        native_image.zstd_decompress(dict_frame, 1)


def test_lab_as_littlecms_and_libtiff(tmp_path):
    """CIELab samples: Pillow's ``convert("RGBA")`` (LittleCMS) and OpenCV's
    reading (libtiff's RGBA reader) of a seeded 256 x 512 file, and the
    grid's corners."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, (256, 512, 3)).astype(np.uint8)
    s[0, :8] = [[0, 0, 0], [255, 0, 0], [255, 255, 255], [0, 128, 128], [255, 127, 127],
                [128, 0, 255], [1, 2, 3], [254, 253, 252]]
    d = tf.tiff(s, 8)
    p = str(tmp_path / "lab.tif")
    assert_reads_as_libraries(d, p)
    np.testing.assert_array_equal(lab.lab_to_rgba(s), np.asarray(Image.open(p).convert("RGBA")))


def test_ycbcr_reference_black_white(tmp_path):
    """libtiff's YCbCr to RGB with other coefficients and ReferenceBlackWhite
    (Pillow's compressed reading and OpenCV's)."""
    rng = np.random.default_rng(10)
    s = rng.integers(0, 256, (40, 50, 3)).astype(np.uint8)
    tags = {529: (5, ((2126, 10000), (7152, 10000), (722, 10000))),
            530: (3, (1, 1)), 532: (5, ((16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                                        (240, 1)))}
    assert_reads_as_libraries(tf.tiff(s, 6, compression=8, tags=tags), str(tmp_path / "y.tif"))
