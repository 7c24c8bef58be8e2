"""The JPEG variants Pillow 12.1.0 and OpenCV 5.0.0 read (both through
libjpeg-turbo), read by the port's own decoder (``assets/jpeg.py`` over
``csrc/sl_image.cpp``) to the same bytes, and the ones they refuse refused
as they refuse them. The files come from libjpeg-turbo 3.1's own encoder
(``torch_image_fixtures.libjpeg_write``: a shim over Pillow's bundled
library), from Pillow's ``save`` (Adobe CMYK) and from
``torch_image_fixtures.lossless_jpeg`` (the lossless files libjpeg does not
write: subsampled, YCbCr):

- arithmetic coding, sequential and progressive x grey / RGB x 4:4:4 /
  4:2:2 / 4:2:0 x restarts x the default and another DAC conditioning;
- lossless (SOF3): predictors 1-7 x point transforms 0-2 x grey / RGB x
  restarts, and subsampled components (replicated, as libjpeg upsamples a
  lossless image);
- CMYK and YCCK x baseline / progressive / arithmetic x with and without
  an Adobe marker x 4:4:4 / 4:2:0 (Pillow: inverted CMYK and its
  ``cmyk2rgb``; OpenCV: its CMYK-to-BGR);
- progressive files cut after each scan, with an EOI (both libraries: the
  blocks smoothed as libjpeg smooths them) and without (OpenCV), and cut
  inside a scan (OpenCV: damaged coefficients through the IDCT as
  libjpeg-turbo's SIMD computes it);
- arithmetic files larger than the 64 KiB Pillow hands libjpeg at a time
  (Pillow: a broken stream; OpenCV reads them);
- the refusals: 12-bit and 16-bit frames and two components (Pillow's open:
  "cannot identify image file"), hierarchical and lossless arithmetic
  frames, lossless YCbCr / YCCK and MCUs of more than 10 data units
  (libjpeg: "broken data stream when reading image file"), headers that
  end before a scan; OpenCV reads none of them;
- the committed variant fixtures against their digests, and the JAX
  package's ``Texture``, ``ImageLoader`` and light-map panorama reader
  against the port's on them, failures included.
"""

import hashlib
import io
import os
import shutil

import numpy as np
import pytest

import stillleben_tpu as jsl
import torch_image_fixtures as tif
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu_torch.assets import image
from stillleben_tpu_torch.assets.image_fixtures import JPEG_VARIANT_FILES, digests
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import light_map as plm
from torch_image_fixtures import libjpeg_write, lossless_jpeg, smooth

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
SAMPLING = {"4:4:4": ((1, 1), (1, 1), (1, 1)), "4:2:2": ((2, 1), (1, 1), (1, 1)),
            "4:2:0": ((2, 2), (1, 1), (1, 1))}
RGB, GREY, CMYK = smooth(45, 61, 3, 1), smooth(45, 61, 1, 2)[..., 0], smooth(37, 53, 4, 3)


def write(tmp_path, data: bytes, name: str = "f.jpg") -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def assert_both_readings(data: bytes, tmp_path):
    """Pillow's ``convert("RGBA")`` and OpenCV's ``imread``, bytes-equal."""
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = image.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert_cv2_reading(data, tmp_path)


def assert_cv2_reading(data: bytes, tmp_path):
    p = write(tmp_path, data)
    want, have = cv2.imread(p, CV2_FLAGS), image.read_image_cv2(p)
    assert want is not None and have is not None
    assert have.dtype == want.dtype and have.shape == want.shape
    np.testing.assert_array_equal(have, want)


def assert_refused(data: bytes, tmp_path, words: str):
    """Pillow raises an ``OSError`` saying ``words``; the port raises one
    with the same message; OpenCV reads nothing, nor does the port."""
    p = write(tmp_path, data)
    with pytest.raises(OSError) as ref:
        Image.open(p).convert("RGBA")
    with pytest.raises(OSError) as got:
        image.read_image(p)
    assert words in str(ref.value) and str(got.value) == str(ref.value)
    assert not isinstance(got.value, NotImplementedError)
    assert cv2.imread(p, CV2_FLAGS) is None and image.read_image_cv2(p) is None


# ---------------------------------------------------------------------------
# arithmetic coding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dac", [(0, 1, 5), (2, 5, 20)], ids=["dac-default", "dac-2-5-20"])
@pytest.mark.parametrize("restart", [0, 3], ids=["no-rst", "rst3"])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("colour", ["rgb", "grey"])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_arithmetic(progressive, colour, sampling, restart, dac, tmp_path):
    pix = RGB if colour == "rgb" else GREY
    samp = SAMPLING[sampling] if colour == "rgb" else SAMPLING[sampling][:1]
    data = libjpeg_write(pix, arith=True, progressive=progressive, sampling=samp,
                         restart_interval=restart, dac=dac)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    assert_both_readings(data, tmp_path)


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("restart_rows", [0, 1], ids=["no-rst", "rst-row"])
@pytest.mark.parametrize("colour", ["rgb", "grey"])
@pytest.mark.parametrize("pt", [0, 1, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless(psv, pt, colour, restart_rows, tmp_path):
    data = libjpeg_write(RGB if colour == "rgb" else GREY, lossless=(psv, pt),
                         restart_rows=restart_rows)
    assert b"\xff\xc3" in data
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("sampling, kw", [
    ([(2, 1), (1, 1), (1, 1)], dict(ids=[82, 71, 66], jfif=False)),
    ([(2, 2), (1, 1), (1, 1)], dict(ids=[82, 71, 66], jfif=False, restart_interval=38)),
    ([(1, 2), (1, 1), (1, 1)], dict(ids=[82, 71, 66], jfif=False, psv=6, pt=1)),
    ([(2, 2)], dict(jfif=False, psv=7)),
    ([(2, 2), (1, 1), (1, 1), (2, 2)], dict(jfif=False, adobe=0, psv=5)),
], ids=["rgb-2x1", "rgb-2x2-rst", "rgb-1x2", "grey-2x2", "cmyk-2x2"])
def test_lossless_subsampled(sampling, kw, tmp_path):
    """Subsampled lossless components, upsampled by replication (libjpeg
    takes no fancy upsampling with one-sample data units)."""
    w, h = 75, 43
    mh, mv = max(s[0] for s in sampling), max(s[1] for s in sampling)
    planes = [smooth(-(-h * v // mv), -(-w * hs // mh), 1, k)[..., 0]
              for k, (hs, v) in enumerate(sampling)]
    kw = dict(kw)
    if "restart_interval" in kw:
        kw["restart_interval"] = 2 * -(-w // mh)
    assert_both_readings(lossless_jpeg(planes, sampling, w, h, **kw), tmp_path)


# ---------------------------------------------------------------------------
# CMYK and YCCK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("adobe", [True, False], ids=["adobe", "no-adobe"])
@pytest.mark.parametrize("space", ["CMYK", "YCCK"])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic", "arith-progressive"])
def test_four_components(kind, space, adobe, sampling, tmp_path):
    """Without its Adobe marker a YCCK file is read as CMYK by both."""
    samp = ((1, 1),) * 4 if sampling == "4:4:4" else ((2, 2), (1, 1), (1, 1), (2, 2))
    data = libjpeg_write(CMYK, colorspace=space, sampling=samp, adobe=adobe,
                         progressive="progressive" in kind, arith="arith" in kind)
    assert (b"Adobe" in data) == adobe
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("kw", [{}, {"progressive": True}, {"subsampling": 0}],
                         ids=["baseline", "progressive", "4:4:4"])
def test_pillow_cmyk(kw, tmp_path):
    """Adobe CMYK as Pillow writes it (stored inverted)."""
    assert_both_readings(tif.pillow_cmyk_jpeg(RGB, **kw), tmp_path)


# ---------------------------------------------------------------------------
# progressive files that stop early: libjpeg's block smoothing
# ---------------------------------------------------------------------------

PROGRESSIVE = {
    "rgb": lambda: libjpeg_write(smooth(61, 83, 3, 4), progressive=True),
    "grey": lambda: libjpeg_write(smooth(53, 70, 1, 5)[..., 0], progressive=True),
    "arith": lambda: libjpeg_write(smooth(61, 83, 3, 6), progressive=True, arith=True),
    "cmyk": lambda: libjpeg_write(smooth(37, 53, 4, 7), progressive=True),
}
CUTS = [(kind, k) for kind, n in (("rgb", 10), ("grey", 6), ("arith", 10), ("cmyk", 18))
        for k in range(1, n)]


@pytest.mark.parametrize("kind, k", CUTS, ids=[f"{a}-{k}" for a, k in CUTS])
def test_cut_after_scan(kind, k, tmp_path):
    """The first k scans and an EOI: both libraries smooth the blocks whose
    low coefficients are not final (libjpeg-turbo 3.1's 5x5 DC window)."""
    data = PROGRESSIVE[kind]()
    assert len(tif.jpeg_scans(data)) > k
    assert_both_readings(tif.jpeg_cut_after_scan(data, k), tmp_path)


@pytest.mark.parametrize("kind, k", CUTS, ids=[f"{a}-{k}" for a, k in CUTS])
def test_cut_after_scan_no_eoi(kind, k, tmp_path):
    """The first k scans and nothing after: Pillow refuses the file (as
    truncated, or where the arithmetic decoder reads on past the end of the
    data, as a broken stream); OpenCV reads it as libjpeg decodes it
    (smoothed)."""
    data = tif.jpeg_cut_after_scan(PROGRESSIVE[kind](), k, eoi=False)
    with pytest.raises(OSError) as ref:
        Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(OSError) as got:
        image.decode_image(data)
    words = next(r for r in tif.PILLOW_REFUSALS if r in str(ref.value))
    assert words in str(got.value)
    assert_cv2_reading(data, tmp_path)


def _noise(h: int, w: int) -> np.ndarray:
    return np.random.default_rng(h * w).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _padded(data: bytes, pad: int) -> bytes:
    """``data`` with APP3 segments of ``pad`` zero bytes after its SOI."""
    segs = b""
    while pad > 0:
        k = min(pad, 65000)
        segs += b"\xff\xe3" + (k + 2).to_bytes(2, "big") + bytes(k)
        pad -= k
    return data[:2] + segs + data[2:]


WINDOWS = {
    "sequential 64 KB": lambda: libjpeg_write(_noise(300, 400), arith=True),
    "sequential 70 KB": lambda: libjpeg_write(_noise(330, 400), arith=True),
    "progressive 63 KB": lambda: libjpeg_write(_noise(300, 400), arith=True, progressive=True),
    "progressive 69 KB": lambda: libjpeg_write(_noise(330, 400), arith=True, progressive=True),
    "restarts 70 KB": lambda: libjpeg_write(_noise(300, 400), arith=True, restart_interval=7),
    **{f"progressive after {pad} bytes of APP3": (
        lambda pad=pad: _padded(libjpeg_write(smooth(200, 300, 3, 1), arith=True,
                                              progressive=True), pad))
       for pad in (60000, 65000, 70000, 130000)},
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_pillow_block_window(name, tmp_path):
    """Pillow hands libjpeg 64 KiB at a time and the arithmetic decoder
    cannot wait for more: a scan whose data reaches past the bytes of the
    call that read its header is a broken stream in Pillow's reading, and
    decodes in OpenCV's. The port reads both as they do."""
    data = WINDOWS[name]()
    try:
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except OSError as e:
        assert "broken data stream" in str(e)
        with pytest.raises(OSError, match="broken data stream when reading image file"):
            image.decode_image(data)
    else:
        np.testing.assert_array_equal(image.decode_image(data), ref)
    assert_cv2_reading(data, tmp_path)


TRUNCATED = {
    "progressive": lambda: libjpeg_write(smooth(97, 131, 3, 1), progressive=True),
    "progressive-rst": lambda: libjpeg_write(smooth(97, 131, 3, 1), progressive=True,
                                             restart_interval=5),
    "arith-sequential": lambda: libjpeg_write(smooth(97, 131, 3, 1), arith=True),
    "arith-progressive": lambda: libjpeg_write(smooth(97, 131, 3, 1), arith=True,
                                               progressive=True),
    "lossless": lambda: libjpeg_write(smooth(97, 131, 3, 1), lossless=(4, 0), restart_rows=3),
    "cmyk-progressive": lambda: libjpeg_write(smooth(50, 60, 4, 1), progressive=True),
}


@pytest.mark.parametrize("kind", sorted(TRUNCATED))
def test_cut_inside_scan(kind, tmp_path):
    """Cut at 24 seeded places past the headers, with no EOI: Pillow's
    reading raises; OpenCV's is libjpeg's (the rest of a Huffman segment
    left as it is, arithmetic data taken as zeros past the end, the
    damaged coefficients through libjpeg-turbo's SIMD IDCT, smoothing by
    the last iMCU row decoded before the data ran out, a table cut short
    read on through the fake EOI markers); where OpenCV reads nothing,
    neither does the port."""
    data = TRUNCATED[kind]()
    rng = np.random.default_rng(len(data))
    first = tif.jpeg_scans(data)[0] + 16
    for cut in sorted(set(rng.integers(first, len(data) - 2, 24).tolist())):
        p = write(tmp_path, data[:cut])
        with pytest.raises(OSError):
            image.decode_image(data[:cut])
        want, have = cv2.imread(p, CV2_FLAGS), image.read_image_cv2(p)
        assert (want is None) == (have is None), cut
        if want is not None:
            np.testing.assert_array_equal(have, want, err_msg=f"cut at {cut}")


@pytest.mark.parametrize("k", [2, 5, 8])
def test_cut_between_scans(k, tmp_path):
    """Cut at every byte from the last 40 of scan k's data through the next
    scan's header (its Huffman table between them): Pillow's reading raises;
    OpenCV's libjpeg reads a cut table on through the fake EOI markers its
    file source supplies, and reads the image or nothing as that table
    parses; the port does the same."""
    data = PROGRESSIVE["rgb"]()
    start = tif.jpeg_scans(data)[k]
    for cut in range(start - 40, start + 14):
        p = write(tmp_path, data[:cut])
        with pytest.raises(OSError):
            image.decode_image(data[:cut])
        want, have = cv2.imread(p, CV2_FLAGS), image.read_image_cv2(p)
        assert (want is None) == (have is None), cut
        if want is not None:
            np.testing.assert_array_equal(have, want, err_msg=f"cut at {cut}")


# ---------------------------------------------------------------------------
# what both libraries refuse
# ---------------------------------------------------------------------------


def _two_components() -> bytes:
    data = libjpeg_write(GREY)
    i = data.index(b"\xff\xc0")
    length = int.from_bytes(data[i + 2: i + 4], "big") + 3
    return (data[: i + 2] + length.to_bytes(2, "big") + data[i + 4: i + 9] + b"\x02" +
            data[i + 10: i + 13] + bytes([2, 0x11, 0]) + data[i + 13:])


REFUSED = {
    "12-bit sequential": (lambda: libjpeg_write(RGB.astype(np.uint16) * 16, precision=12),
                          "cannot identify image file"),
    "12-bit progressive": (lambda: libjpeg_write(RGB.astype(np.uint16) * 16, precision=12,
                                                 progressive=True), "cannot identify image file"),
    "12-bit arithmetic": (lambda: libjpeg_write(RGB.astype(np.uint16) * 16, precision=12,
                                                arith=True), "cannot identify image file"),
    "12-bit lossless": (lambda: libjpeg_write(RGB.astype(np.uint16) * 16, precision=12,
                                              lossless=(1, 0)), "cannot identify image file"),
    "16-bit lossless": (lambda: libjpeg_write(RGB.astype(np.uint16) * 257, precision=16,
                                              lossless=(1, 0)), "cannot identify image file"),
    "2 components": (_two_components, "cannot identify image file"),
    **{f"SOF{m - 0xC0}": ((lambda m=m: tif.jpeg_patch_marker(libjpeg_write(RGB), 0xC0, m)),
                          "broken data stream when reading image file")
       for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)},
    "SOF11": (lambda: tif.jpeg_patch_marker(libjpeg_write(RGB, lossless=(1, 0)), 0xC3, 0xCB),
              "broken data stream when reading image file"),
    "lossless YCbCr": (lambda: lossless_jpeg([RGB[..., k] for k in range(3)], [(1, 1)] * 3,
                                             61, 45), "broken data stream when reading image file"),
    "lossless YCCK": (lambda: lossless_jpeg([CMYK[..., k] for k in range(4)], [(1, 1)] * 4, 53,
                                            37, jfif=False, adobe=2),
                      "broken data stream when reading image file"),
    "12 samples an MCU": (lambda: lossless_jpeg([RGB[..., k] for k in range(3)], [(2, 2)] * 3, 61,
                                                45, ids=[82, 71, 66], jfif=False),
                          "broken data stream when reading image file"),
    "11 samples an MCU": (lambda: lossless_jpeg(
        [RGB[..., 0], RGB[::3, ::3, 1].copy(), RGB[::3, ::3, 2].copy()], [(3, 3), (1, 1), (1, 1)],
        61, 45, ids=[82, 71, 66], jfif=False), "broken data stream when reading image file"),
    "no scan": (lambda: (lambda d: d[: d.index(b"\xff\xda")])(libjpeg_write(RGB)),
                "cannot identify image file"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused(name, tmp_path):
    make, words = REFUSED[name]
    assert_refused(make(), tmp_path, words)


# ---------------------------------------------------------------------------
# the committed fixtures, and the JAX package on them
# ---------------------------------------------------------------------------


def test_fixtures_regenerate():
    """``make_jpeg_variant_fixtures`` writes the committed files again."""
    files = tif.make_jpeg_variant_fixtures()
    assert sorted(files) == sorted(JPEG_VARIANT_FILES)
    for name, data in files.items():
        with open(fixture(name), "rb") as f:
            assert f.read() == data, name


@pytest.mark.parametrize("name", JPEG_VARIANT_FILES)
def test_fixture_digests(name):
    """The port reads each committed variant to the digests of Pillow's and
    OpenCV's readings (the card's host checks the same), and so do the
    libraries here."""
    with open(fixture(name), "rb") as f:
        data = f.read()
    want, want_cv2 = digests.JPEG_VARIANT_DECODE[name], digests.JPEG_VARIANT_DECODE_CV2[name]
    assert tif.pillow_reading(data) == want and tif.cv2_reading(data) == want_cv2
    try:
        got = hashlib.sha256(image.decode_image(data, name).tobytes()).hexdigest()
    except OSError as e:
        got = "refused: " + next(r for r in tif.PILLOW_REFUSALS if r in str(e))
    assert got == want
    have = image.read_image_cv2(fixture(name))
    have = "None" if have is None else hashlib.sha256(have.tobytes()).hexdigest()
    assert have == want_cv2


def _jax_or_error(fn, *args):
    try:
        return fn(*args)
    except OSError as e:
        return e


@pytest.mark.parametrize("name", JPEG_VARIANT_FILES)
def test_texture_matches_jax(name):
    """``Texture(path)``: the same pixels, or the same ``OSError``."""
    got, ref = (_jax_or_error(lambda p, T=T: T(p).pixels, fixture(name))
                for T in (Texture, jsl.Texture))
    if isinstance(ref, Exception):
        assert isinstance(got, OSError) and not isinstance(got, NotImplementedError)
        words = next(r for r in tif.PILLOW_REFUSALS if r in str(ref))
        assert words in str(got)
        if words != "image file is truncated":
            assert str(got) == str(ref)
        return
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", JPEG_VARIANT_FILES)
def test_panorama_reader_matches_jax(name):
    """The light map's reader: OpenCV's reading, linearised, or the Pillow
    fallback where OpenCV reads nothing (which raises on a refused file in
    both packages)."""
    got, ref = (_jax_or_error(m._load_hdr_image, fixture(name)) for m in (plm, jlm))
    if isinstance(ref, Exception):
        assert isinstance(got, OSError) and str(got) == str(ref)
        return
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_image_loader_matches_jax(tmp_path):
    """A folder of CMYK, YCCK, arithmetic, lossless and smoothed photos and
    two the libraries refuse: one thread, one seed, the same textures in the
    same order (the refused files are failures in both)."""
    names = ("cmyk.jpg", "ycck_arith.jpg", "arith.jpg", "arith_prog.jpg", "lossless.jpg",
             "lossless_sub.jpg", "smoothed.jpg", "blob_cmyk.jpg", "bits12.jpg",
             "hierarchical.jpg")
    for name in names:
        shutil.copyfile(fixture(name), tmp_path / name)
    port = ImageLoader(str(tmp_path), seed=5, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=5, num_threads=1)
    try:
        for _ in range(16):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()
    assert len(os.listdir(tmp_path)) == len(names)
