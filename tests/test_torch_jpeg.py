"""The port's JPEG codec (``assets/jpeg.py`` over ``csrc/sl_image.cpp``)
against the libraries the JAX package reads and writes JPEG with, Pillow
12.1.0 (libjpeg-turbo) and OpenCV 5.0.0, on the same bytes:

- decode: bitwise equal to ``Image.open(f).convert("RGBA")`` and to
  ``cv2.imread(f, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` over quality {50, 75,
  95} x sampling {4:4:4, 4:2:2, 4:2:0, 4:4:0} x {baseline, progressive},
  grey, RGB (Adobe, no conversion), restart intervals, sizes off the MCU
  grid, EXIF orientations (which
  OpenCV applies and Pillow does not), truncated files (Pillow refuses
  them, OpenCV reads them as libjpeg does); a progressive file libjpeg
  smooths, smoothed as it does;
- encode: the bytes of Pillow's ``save`` for L and RGB at each quality and
  subsampling Pillow takes; RGBA and 16-bit refused with Pillow's message;
- frame headers of the variants the port once refused raise as Pillow does
  (``test_torch_jpeg_variants.py`` holds the variants' files);
- the native build: a compiler that fails raises with its message, and a
  build is found again by its hash.
"""

import io
import os
import stat
import struct

import numpy as np
import pytest

from stillleben_tpu_torch.assets import image, jpeg, native_image
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import smooth

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
SAMPLING_CV2 = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def pillow_jpeg(a, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", **kw)
    return b.getvalue()


def cv2_jpeg(a, sampling, quality=75, progressive=False, rst=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING_CV2[sampling]]
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, enc = cv2.imencode(".jpg", a[..., ::-1] if a.ndim == 3 else a, params)
    assert ok
    return enc.tobytes()


def assert_both_readings(data: bytes, tmp_path, ext=".jpg"):
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = image.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / f"f{ext}")
    with open(path, "wb") as f:
        f.write(data)
    want, have = cv2.imread(path, CV2_FLAGS), image.read_image_cv2(path)
    assert have.dtype == want.dtype and have.shape == want.shape
    np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "4:4:0"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matrix(quality, sampling, progressive, tmp_path):
    a = smooth(97, 131, 3, quality)
    if sampling == "4:4:0":  # Pillow writes no 4:4:0; OpenCV does
        data = cv2_jpeg(a, sampling, quality, progressive)
    else:
        data = pillow_jpeg(a, quality=quality, subsampling=sampling, progressive=progressive)
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (17, 9), (131, 97), (16, 16), (33, 7)])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:2:2", "4:4:0"])
def test_decode_odd_sizes(size, sampling, tmp_path):
    a = smooth(*size, 3, size[0] * 7 + size[1])
    data = cv2_jpeg(a, sampling) if sampling == "4:4:0" else pillow_jpeg(a, subsampling=sampling)
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("size", [(1, 1), (45, 71)])
def test_decode_grey(size, progressive, tmp_path):
    data = pillow_jpeg(smooth(*size, 1, 3)[..., 0], progressive=progressive)
    assert_both_readings(data, tmp_path)
    assert image.read_image_cv2(str(tmp_path / "f.jpg")).ndim == 2


@pytest.mark.parametrize("how", ["blocks 3", "rows 1", "cv2 2", "cv2 5 progressive"])
def test_decode_restart_intervals(how, tmp_path):
    a = smooth(61, 83, 3, 11)
    kind, n, *prog = how.split()
    if kind == "blocks":
        data = pillow_jpeg(a, restart_marker_blocks=int(n))
    elif kind == "rows":
        data = pillow_jpeg(a, restart_marker_rows=int(n))
    else:
        data = cv2_jpeg(a, "4:2:0", progressive=bool(prog), rst=int(n))
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("kw", [{}, {"subsampling": 0}, {"progressive": True}],
                         ids=["4:2:0", "4:4:4", "progressive"])
def test_decode_rgb_colour_space(kw, tmp_path):
    """Pillow's ``keep_rgb``: an Adobe marker with transform 0 and the
    components R, G, B, which libjpeg does not convert."""
    data = pillow_jpeg(smooth(37, 53, 3, 3), keep_rgb=True, **kw)
    assert b"Adobe" in data and native_image.jpeg_info(data)["colour_space"] == 2
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path):
    """OpenCV turns the image by its EXIF orientation; Pillow does not."""
    ex = Image.Exif()
    ex[0x0112] = orientation
    data = pillow_jpeg(smooth(13, 21, 3, orientation), exif=ex.tobytes())
    assert jpeg.exif_orientation(data) == orientation
    assert_both_readings(data, tmp_path)


@pytest.mark.parametrize("rst", [0, 2])
def test_truncated_file(rst, tmp_path):
    """Pillow raises "image file is truncated"; OpenCV reads what libjpeg
    decodes: the rest of the segment where the data ends left flat."""
    a = smooth(40, 50, 3, 5)
    data = cv2_jpeg(a, "4:2:0", rst=rst) if rst else pillow_jpeg(a)
    for cut in (2, 37, 200, 600, len(data) // 2):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data[:-cut])).convert("RGBA")
        with pytest.raises(OSError, match="truncated"):
            image.decode_image(data[:-cut])
        path = str(tmp_path / "t.jpg")
        with open(path, "wb") as f:
            f.write(data[:-cut])
        np.testing.assert_array_equal(image.read_image_cv2(path), cv2.imread(path, CV2_FLAGS))


def test_block_smoothing_refused(tmp_path):
    """A progressive file whose scans leave low coefficients unrefined (here
    its last scans cut off) is one that libjpeg smooths: the port smooths it
    as libjpeg does, in both readings (the name is the test's from when the
    port refused such a file)."""
    data = pillow_jpeg(smooth(40, 50, 3, 5), progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i: i + 2] == b"\xff\xda"]
    cut = data[: scans[2]] + b"\xff\xd9"
    assert_both_readings(cut, tmp_path)


@pytest.mark.parametrize("subsampling", [-1, 0, 1, 2, "4:2:2", "4:1:1"])
@pytest.mark.parametrize("quality", [1, 50, 75, 95, 100])
def test_encode_rgb_equals_pillow(quality, subsampling):
    a = smooth(53, 77, 3, quality)
    kw = {} if subsampling == -1 else {"subsampling": subsampling}
    assert jpeg.encode_jpeg(a, quality, subsampling) == pillow_jpeg(a, quality=quality, **kw)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_encode_grey_subsampling_equals_pillow(subsampling):
    """Pillow writes a grey image's sampling factors as asked."""
    a = smooth(41, 29, 1, subsampling)[..., 0]
    assert jpeg.encode_jpeg(a, 80, subsampling) == pillow_jpeg(a, quality=80,
                                                               subsampling=subsampling)


@pytest.mark.parametrize("size", [(1, 1), (8, 8), (17, 9), (480, 640)])
def test_encode_defaults_equal_pillow(size):
    """``save(path)`` with no arguments, as the JAX ``ImageSaver`` calls it."""
    rgb, grey = smooth(*size, 3, 1), smooth(*size, 1, 2)[..., 0]
    assert jpeg.encode_jpeg(rgb) == pillow_jpeg(rgb)
    assert jpeg.encode_jpeg(grey) == pillow_jpeg(grey)


@pytest.mark.parametrize("arr", [np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint16)],
                         ids=["RGBA", "I;16"])
def test_encode_refuses_what_pillow_refuses(arr):
    with pytest.raises(OSError) as ref:
        pillow_jpeg(arr)
    with pytest.raises(OSError) as got:
        jpeg.encode_jpeg(arr)
    assert str(got.value) == str(ref.value)


def _sof(marker: int, precision: int = 8, comps: int = 3) -> bytes:
    body = bytes([precision, 0, 8, 0, 8, comps]) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(comps))
    return b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body


@pytest.mark.parametrize("name, data", [
    ("arithmetic", _sof(0xC9)), ("arithmetic", _sof(0xCA)), ("12-bit", _sof(0xC1, 12)),
    ("12-bit", _sof(0xC2, 12)), ("lossless", _sof(0xC3)), ("CMYK", _sof(0xC0, comps=4)),
])
def test_refused_variants_raise_by_name(name, data):
    """A frame header of each variant the port once refused by name, and no
    scan: the port raises what Pillow raises (an ``OSError``), no longer
    ``NotImplementedError``. ``test_torch_jpeg_variants.py`` holds the
    variants' real files to both libraries."""
    with pytest.raises(OSError) as ref:  # the 12-bit frame, or no scan
        Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(OSError) as got:
        jpeg.decode_jpeg(data)
    assert not isinstance(got.value, NotImplementedError)
    assert "cannot identify image file" in str(ref.value)
    assert str(got.value) == "cannot identify image file '<bytes>'"


def test_decompression_bomb_refused():
    """A frame header of 65535 x 65535 pixels: Pillow refuses it before
    decoding, and so does the port, before it allocates."""
    data = bytearray(pillow_jpeg(smooth(8, 8, 3, 0)))
    sof = data.index(b"\xff\xc0")
    data[sof + 5: sof + 9] = b"\xff\xff\xff\xff"
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(data))).convert("RGBA")
    with pytest.raises(ValueError, match="decompression bomb"):
        jpeg.decode_jpeg(bytes(data))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A ``g++`` first on ``PATH`` that fails: the codec raises with its
    message, nothing is left in the build directory, and no decoder stands
    in."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'broken compiler: cannot compile' >&2\nexit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native_image, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_image, "_lib", None)
    with pytest.raises(RuntimeError, match="broken compiler: cannot compile"):
        image.decode_image(pillow_jpeg(smooth(8, 8, 3, 0)))
    assert not os.listdir(tmp_path / "build")


def test_build_is_cached_by_content(monkeypatch, tmp_path):
    monkeypatch.setattr(native_image, "BUILD_DIR", str(tmp_path))
    first = native_image.build()
    assert os.path.basename(first).startswith("libsl_image_")
    assert native_image.build() == first and os.listdir(tmp_path) == [os.path.basename(first)]
