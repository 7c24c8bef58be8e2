"""The port's image codec (``assets/image.py``) against the libraries the
JAX package reads images with, on the same files, and the port's
``ImageSaver`` / ``ImageLoader`` against the JAX package's.

- every PNG variant of ``write_loader_fixtures`` (each colour type and
  depth, with and without tRNS, plain and Adam7, every filter) decodes to
  exactly what ``PIL.Image.open(path).convert("RGBA")`` gives, and
  ``read_image_cv2`` to exactly what ``cv2.imread(path, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)`` gives (shape, dtype, values);
- Radiance ``.hdr``, flat and run-length, with and without an
  ``EXPOSURE`` line, and a file OpenCV wrote: exactly ``cv2.imread``'s;
- the encoder: files Pillow reads back to the same array;
- ``ImageSaver``: the same samples as the JAX ``ImageSaver``'s files;
  ``ImageLoader`` at one thread: the same textures in the same order;
- a file no library reads raises Pillow's ``OSError`` (and reads as None
  as OpenCV does), also through the panorama reader, as in the JAX
  package; a format of the reading queue raises ``NotImplementedError`` by
  name; a JPEG header the libraries refuse raises their ``OSError``.
"""

import os
import struct
import time

import numpy as np
import pytest

from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.image_saver import ImageSaver as JaxImageSaver
from stillleben_tpu_torch.assets import image
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.image_saver import ImageSaver
from stillleben_tpu_torch.assets.procedural import sky_equirect, write_loader_fixtures
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_loader_fixtures(str(tmp_path_factory.mktemp("codec")), subdiv=1)


def _png_names():
    from stillleben_tpu_torch.assets.procedural import _png_variants

    return sorted(_png_variants(np.random.default_rng(0)))


@pytest.mark.parametrize("name", _png_names())
def test_png_decodes_like_pillow(files, name):
    ref = np.asarray(Image.open(files[name]).convert("RGBA"))
    got = image.read_image(files[name])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", _png_names())
def test_png_decodes_like_opencv(files, name):
    ref = cv2.imread(files[name], CV2_FLAGS)
    got = image.read_image_cv2(files[name])
    assert (got.shape, got.dtype) == (ref.shape, ref.dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("exposure", [None, 2.5])
@pytest.mark.parametrize("shape", [(64, 128), (5, 6), (9, 37)])
def test_hdr_decodes_like_opencv(tmp_path, rle, exposure, shape):
    """OpenCV's RGBE rule (mantissa * 2^(e - 136), no half step; e = 0
    black), the ``EXPOSURE`` line not applied, widths under 8 flat."""
    rng = np.random.default_rng(shape[1])
    hdr = sky_equirect(*shape) if shape == (64, 128) else (rng.random(shape + (3,)) * 50)
    hdr = hdr.astype(np.float32)
    hdr[0, :3] = 0.0  # black pixels: exponent 0
    path = str(tmp_path / "x.hdr")
    with open(path, "wb") as f:
        f.write(image.encode_hdr(hdr, rle=rle, exposure=exposure))
    ref = cv2.imread(path, CV2_FLAGS)
    got = image.read_image_cv2(path)
    assert (got.shape, got.dtype) == (ref.shape, ref.dtype) == (shape + (3,), np.float32)
    np.testing.assert_array_equal(got, ref)
    # RGBE keeps 8 bits of mantissa, scaled to the pixel's largest channel
    err = np.abs(image.read_hdr(path) - hdr)
    assert (err <= hdr.max(-1, keepdims=True) * 2 ** -7).all()


def test_hdr_written_by_opencv(files, tmp_path):
    path = str(tmp_path / "cv.hdr")
    cv2.imwrite(path, sky_equirect()[..., ::-1].copy())
    np.testing.assert_array_equal(image.read_image_cv2(path), cv2.imread(path, CV2_FLAGS))
    np.testing.assert_array_equal(image.read_image_cv2(files["hdr"]),
                                  cv2.imread(files["hdr"], CV2_FLAGS))


def test_hdr_orientation_refused(tmp_path):
    path = tmp_path / "x.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n" + bytes(16))
    with pytest.raises(NotImplementedError, match=r"\+Y 2 \+X 2"):
        image.read_hdr(str(path))


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I;16"])
def test_encoder_round_trip(tmp_path, kind):
    """``encode_png`` of each mode the JAX ``ImageSaver`` writes: Pillow
    and the port's decoder read back the same samples."""
    rng = np.random.default_rng(len(kind))
    shape = {"L": (21, 34), "RGB": (21, 34, 3), "RGBA": (21, 34, 4), "I;16": (21, 34)}[kind]
    arr = rng.integers(0, 65536 if kind == "I;16" else 256, shape).astype(
        np.uint16 if kind == "I;16" else np.uint8)
    path = str(tmp_path / "x.png")
    image.write_png(path, arr)
    pil = Image.open(path)
    assert pil.mode == kind
    np.testing.assert_array_equal(np.asarray(pil), arr)
    samples = image.read_png_samples(path).samples
    np.testing.assert_array_equal(samples.reshape(arr.shape), arr)


def test_image_saver_matches_jax(tmp_path):
    """The same arrays through both savers (rgb as RGBA, RGB, a grey mask,
    a 16-bit depth map in millimetres): the files decode to the same
    samples, colour type and depth."""
    import torch

    rng = np.random.default_rng(9)
    arrays = {
        "rgba": rng.integers(0, 256, (30, 40, 4)).astype(np.uint8),
        "rgb": rng.integers(0, 256, (30, 40, 3)).astype(np.uint8),
        "mask": rng.integers(0, 256, (30, 40)).astype(np.uint8),
        "depth": rng.integers(0, 65536, (30, 40)).astype(np.uint16),
    }
    with ImageSaver(num_threads=2) as port, JaxImageSaver(num_threads=2) as ref:
        for name, arr in arrays.items():
            src = torch.from_numpy(arr.astype(np.int32)).to(torch.uint8) if name == "mask" else arr
            port.save(src, str(tmp_path / f"port_{name}.png"))
            ref.save(arr, str(tmp_path / f"jax_{name}.png"))
    for name, arr in arrays.items():
        a = image.read_png_samples(str(tmp_path / f"port_{name}.png"))
        b = image.read_png_samples(str(tmp_path / f"jax_{name}.png"))
        assert (a.color_type, a.bit_depth) == (b.color_type, b.bit_depth)
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.samples.reshape(arr.shape), arr)


def test_image_saver_refuses_in_save(tmp_path, capsys):
    saver = ImageSaver(num_threads=1)
    try:
        # AVIF, the last extension Pillow writes that the port refused, is written
        saver.save(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "x.avif"))
        with pytest.raises(ValueError, match="single-channel"):
            saver.save(np.zeros((4, 4, 3), np.uint16), str(tmp_path / "x.png"))
        # an extension Pillow does not know fails in the worker, as in the JAX saver
        saver.save(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "x.exr"))
    finally:
        saver.close()
    assert "ImageSaver: failed to write" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["x.avif"]
    assert image.read_image(str(tmp_path / "x.avif")).shape == (4, 4, 4)


def test_image_loader_matches_jax(files, tmp_path):
    """One worker each, the same seed: the same textures in the same order
    (with more workers the order depends on thread scheduling in both)."""
    d = tmp_path / "images"
    d.mkdir()
    for name in ("png_c2_d8", "png_c3_d4_trns", "png_c0_d16_adam7", "png_c6_d16"):
        (d / f"{name}.png").write_bytes(open(files[name], "rb").read())
    (d / "notes.txt").write_text("not an image")
    port, ref = ImageLoader(str(d), seed=0, num_threads=1), JaxImageLoader(str(d), seed=0, num_threads=1)
    try:
        for _ in range(8):
            a, b = port.next_texture(), ref.next_texture()
            np.testing.assert_array_equal(a.pixels, b.pixels)
        assert port.next_texture2d().pixels.shape == (19, 23, 4)
    finally:
        port.close()
        ref.close()


def test_image_loader_counts_refused_formats_as_failures(tmp_path):
    """A file the port cannot decode is a failed load, as a file Pillow
    cannot open is in the JAX package: 10 in a row warn."""
    (tmp_path / "photo.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded by the port")
    with pytest.warns(UserWarning, match="10 consecutive failures"):
        loader = ImageLoader(str(tmp_path), seed=0, num_threads=1)
        deadline = time.time() + 20
        while loader._failures < 10 and time.time() < deadline:
            time.sleep(0.01)
        loader.close()
    assert loader._out.empty()


def _sof(marker: int, precision: int = 8, comps: int = 3) -> bytes:
    """A JPEG's SOI, JFIF APP0 and a frame header of ``marker``."""
    body = bytes([precision, 0, 8, 0, 8, comps]) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(comps))
    app0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    return b"\xff\xd8" + app0 + bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body


@pytest.mark.parametrize("fmt, head, ext", [
    ("WebP", b"RIFF\x00\x00\x00\x00WEBPVP8 ", ".webp"), ("WebP", b"\x00" * 12, ".webp"),
    ("arithmetic", _sof(0xC9), ".jpg"), ("12-bit", _sof(0xC1, precision=12), ".jpg"),
    ("lossless", _sof(0xC3), ".jpg"), ("CMYK", _sof(0xC0, comps=4), ".jpg"),
    ("hierarchical", _sof(0xC5), ".jpeg"),
])
def test_refused_formats_raise_with_their_name(tmp_path, fmt, head, ext):
    """A file of zeros named ``.webp``, which no decoder claims, raises
    Pillow's ``UnidentifiedImageError`` message as an ``OSError`` and reads
    as None, as the libraries do (C-23). WebP is decoded: a file whose header names WebP
    over no valid container raises as Pillow does (``ValueError``) and reads
    as None as OpenCV does. The JPEG cases (headers of the variants the port
    once refused by name, and no scan) raise Pillow's own ``OSError`` and
    read as None, as the libraries do (``test_torch_jpeg_variants.py`` holds
    the variants' real files)."""
    path = str(tmp_path / f"x{ext}")
    with open(path, "wb") as f:
        f.write(head + bytes(64))
    if fmt == "WebP" and head.startswith(b"RIFF"):
        with pytest.raises(ValueError, match="WebP"):
            image.read_image(path)
        assert image.read_image_cv2(path) is None
        return
    with pytest.raises(OSError) as ref:
        Image.open(path).convert("RGBA")
    with pytest.raises(OSError) as got:
        image.read_image(path)
    assert not isinstance(got.value, NotImplementedError) and str(got.value) == str(ref.value)
    assert cv2.imread(path, CV2_FLAGS) is None and image.read_image_cv2(path) is None


# files neither library reads (C-23): Pillow's UnidentifiedImageError, None
# from OpenCV (whose build has no OpenEXR), and so the JAX panorama reader's
# Pillow fallback fails with the same error
UNREADABLE = {"text.png": b"a text file, not a PNG\n" * 3, "empty.jpg": b"",
              "scene.exr": b"\x76\x2f\x31\x01\x02\x00\x00\x00" + bytes(56)}


@pytest.mark.parametrize("name", sorted(UNREADABLE))
def test_unreadable_file_raises_pillows_oserror(tmp_path, name):
    from stillleben_tpu.render.light_map import _load_hdr_image as jax_panorama
    from stillleben_tpu_torch.render.light_map import _load_hdr_image as port_panorama

    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(UNREADABLE[name])
    with pytest.raises(OSError) as ref:
        Image.open(path).convert("RGBA")
    for read in (image.read_image, port_panorama):
        with pytest.raises(OSError) as got:
            read(path)
        assert not isinstance(got.value, NotImplementedError)
        assert str(got.value) == str(ref.value)
    with pytest.raises(OSError) as jax_got:
        jax_panorama(path)
    assert str(jax_got.value) == str(ref.value)
    assert cv2.imread(path, CV2_FLAGS) is None and image.read_image_cv2(path) is None


def _sun_raster(h: int = 8, w: int = 8) -> bytes:
    """An uncompressed 24-bit Sun raster (BGR rows, each padded to 16 bits)."""
    rows = np.arange(h * w * 3, dtype=np.uint8).reshape(h, w * 3)
    data = rows.tobytes() if (w * 3) % 2 == 0 else b"".join(r.tobytes() + b"\0" for r in rows)
    return struct.pack(">8I", 0x59A66A95, w, h, 24, len(data), 1, 0, 0) + data


def test_reading_queue_raises_by_name(tmp_path):
    """A file of a format ROADMAP.md queues for reading, which Pillow or
    OpenCV reads, still raises ``NotImplementedError`` by name: a JPEG
    2000 codestream of a code-block style other than 0 and a LAB PSD. A
    Sun raster, once queued, is read as both libraries read it."""
    from stillleben_tpu_torch.assets.image_fixtures import path as fixture_path
    from torch_image_fixtures import psd_file

    lab = psd_file(np.full((3, 4, 5), 128, np.uint8), 9)
    cases = {"cblk_style.j2k": (open(fixture_path("cblk_style.j2k"), "rb").read(),
                                "code-block style"),
             "lab.psd": (lab, "LAB")}
    for name, (data, what) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        Image.open(path).convert("RGBA")  # Pillow reads each
        with pytest.raises(NotImplementedError, match=what):
            image.read_image(path)
    sun = str(tmp_path / "sun.ras")
    with open(sun, "wb") as f:
        f.write(_sun_raster())
    np.testing.assert_array_equal(image.read_image(sun), np.asarray(Image.open(sun).convert("RGBA")))
    ref = cv2.imread(sun, CV2_FLAGS)
    assert ref.shape == (8, 8, 3)
    np.testing.assert_array_equal(image.read_image_cv2(sun), ref)
