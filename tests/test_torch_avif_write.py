"""AVIF written by the port's ``ImageSaver`` (``assets/avif.py::encode_avif``
over the native AV1 encoder ``csrc/sl_av1_enc.cpp``) against the JAX
``ImageSaver``'s files of the same arrays (Pillow 12.1.0: libavif 1.3.0
over aom 3.12.1, at Pillow's defaults).

The AV1 bitstream is the port's own (aom's bytes depend on the host's CPU
count, ROADMAP C-24), so each array's two files are held:

- exactly where every host agrees: Pillow opens the port's file with the
  size and mode of its reading of the JAX file; Pillow's ``convert("RGBA")``
  and the port's ``decode_avif`` of the port's file are the encoder's own
  reconstruction (through libyuv's conversion), and OpenCV's ``imread`` is
  ``decode_avif_cv2``; the HEIF boxes are libavif's box for box (only
  ``iloc``'s extents and the ``mdat`` differ), the sequence header and
  ``av1C`` aom's byte for byte, and ``base_q_idx`` and the loop filter's
  levels aom's for the colour and the alpha item;
- by rate and distortion: the RGB PSNR against the converted source (and
  the alpha's, with an alpha item) at least Pillow's less 0.5 dB, and no
  more than max(1.5 x, + 64 B) Pillow's bytes.

Also: the range coder's round trip through the decoder's symbol reader,
libavif's conversion to YUV and its tile layout, the sequence header and
brands over sizes up to level 6.0, and the committed digests of the port's
files (``AVIF_ENCODE``) at one, four and sixteen saver threads.
"""

import hashlib
import io
import os
import struct

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import avif, native_image
from stillleben_tpu_torch.assets.image_fixtures import avif_write_sources, digests, orientation_exif
from stillleben_tpu_torch.assets.image_saver import ImageSaver

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
jax_saver = pytest.importorskip("stillleben_tpu.assets.image_saver")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
SOURCES = avif_write_sources()
FILTER = ("filter_level_y0", "filter_level_y1", "filter_level_u", "filter_level_v",
          "filter_sharpness")


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def converted(arr: np.ndarray) -> np.ndarray:
    """The RGB(A) array Pillow's AVIF ``save`` encodes for the saver's
    image: L and I;16 (clamped at 255) as RGB."""
    if arr.dtype == np.uint16:
        arr = np.minimum(arr, 255).astype(np.uint8)
    return np.repeat(arr[..., None], 3, 2) if arr.ndim == 2 else arr


def boxes(data: bytes, pos: int = 0, end: int | None = None, path: str = "") -> list:
    """Every box as (path, payload): the containers opened, ``iloc`` as its
    header and each item's ID and extent count, ``mdat`` empty."""
    end = len(data) if end is None else end
    out = []
    while pos < end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        name = path + "/" + kind.decode()
        body = data[pos + 8:pos + size]
        if kind in (b"meta", b"iinf", b"iref"):
            skip = {b"meta": 4, b"iinf": 6, b"iref": 4}[kind]
            out.append((name, body[:skip]))
            out += boxes(data, pos + 8 + skip, pos + size, name)
        elif kind in (b"iprp", b"ipco"):
            out += boxes(data, pos + 8, pos + size, name)
        elif kind == b"iloc":
            n = struct.unpack(">H", body[6:8])[0]
            items = [struct.unpack(">HHH", body[8 + 14 * i:14 + 14 * i]) for i in range(n)]
            out.append((name, body[:8] + repr(items).encode()))
        elif kind == b"mdat":
            out.append((name, b""))
        else:
            out.append((name, body))
        pos += size
    return out


def sequence_header(item: bytes) -> bytes:
    """The sequence header OBU after an item's temporal delimiter."""
    assert item[:3] == b"\x12\x00\x0a"
    return item[2:4 + item[3]]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both savers' ``.avif`` of every array (one thread each)."""
    d = tmp_path_factory.mktemp("avif_write")
    for who, cls in (("jax", jax_saver.ImageSaver), ("port", ImageSaver)):
        (d / who).mkdir()
        with cls(num_threads=1) as saver:
            for name, a in SOURCES.items():
                saver.save(a, str(d / who / name))
    return d


@pytest.mark.parametrize("name", list(SOURCES))
def test_held_against_pillow(written, name):
    a = SOURCES[name]
    ours = (written / "port" / name).read_bytes()
    ref = (written / "jax" / name).read_bytes()
    data, recon = avif.encode_avif_reconstructed(a)
    assert ours == data

    # what every host agrees on, exactly
    ref_img, our_img = Image.open(io.BytesIO(ref)), Image.open(io.BytesIO(ours))
    assert (our_img.size, our_img.mode) == (ref_img.size, ref_img.mode)
    np.testing.assert_array_equal(np.asarray(our_img.convert("RGBA")), recon)
    np.testing.assert_array_equal(avif.decode_avif(ours), recon)
    np.testing.assert_array_equal(cv2.imread(str(written / "port" / name), CV2_FLAGS),
                                  avif.decode_avif_cv2(ours))
    assert boxes(ours) == boxes(ref)
    our_items, ref_items = avif.parse_avif(ours), avif.parse_avif(ref)
    assert (our_items.alpha is None) == (ref_items.alpha is None)
    pairs = [(our_items.color, ref_items.color)]
    if ref_items.alpha is not None:
        pairs.append((our_items.alpha, ref_items.alpha))
    for o, r in pairs:
        assert sequence_header(o) == sequence_header(r)
        oi, ri = native_image.av1_info(o), native_image.av1_info(r)
        assert oi["base_q_idx"] == ri["base_q_idx"]
        # the loop filter's levels are aom's pick from the quantizer, where
        # aom filters at all (it turns the filter off with intra block copy)
        if ri["filter_level_y0"] or ri["filter_level_y1"]:
            assert [oi[k] for k in FILTER] == [ri[k] for k in FILTER]

    # the rest, by rate and distortion
    src = converted(a)
    ref_rgba = np.asarray(ref_img.convert("RGBA"))
    ours_db, ref_db = psnr(recon[..., :3], src[..., :3]), psnr(ref_rgba[..., :3], src[..., :3])
    line = f"{name}: {len(ours)} B, {ours_db:.2f} dB (Pillow {len(ref)} B, {ref_db:.2f} dB)"
    assert ours_db >= ref_db - 0.5, line
    if ref_items.alpha is not None:
        ours_a, ref_a = psnr(recon[..., 3], src[..., 3]), psnr(ref_rgba[..., 3], src[..., 3])
        line += f"; alpha {ours_a:.2f} dB (Pillow {ref_a:.2f} dB)"
        assert ours_a >= ref_a - 0.5, line
    print(line)
    assert len(ours) <= max(1.5 * len(ref), len(ref) + 64), line


def test_avifs_and_opaque_alpha(written, tmp_path):
    """``.avifs`` writes what ``.avif`` does in both savers (Pillow saves one
    frame as a still image); an RGBA of all-255 alpha has no alpha item."""
    a = SOURCES["frame.avif"]
    with ImageSaver(num_threads=1) as port, jax_saver.ImageSaver(num_threads=1) as ref:
        port.save(a, str(tmp_path / "port.avifs"))
        ref.save(a, str(tmp_path / "jax.avifs"))
    assert (tmp_path / "port.avifs").read_bytes() == (written / "port" / "frame.avif").read_bytes()
    jax_avifs = Image.open(tmp_path / "jax.avifs")
    assert (jax_avifs.format, jax_avifs.size, getattr(jax_avifs, "n_frames", 1)) == ("AVIF", (64, 48), 1)
    opaque = (written / "port" / "frame_opaque.avif").read_bytes()
    assert avif.parse_avif(opaque).alpha is None
    assert opaque == (written / "port" / "frame.avif").read_bytes()


@pytest.mark.parametrize("orientation", (2, 6))
def test_orientation_exif_is_pillows(orientation):
    """``avif_sources()`` (so ``avif_write_sources()``, which the card's host
    runs) builds its EXIF options without Pillow: Pillow's bytes."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    assert orientation_exif(orientation) == exif.tobytes()


@pytest.mark.parametrize("threads", (1, 4, 16))
def test_committed_digests(tmp_path, threads):
    """The port's files of ``avif_write_sources()`` are the committed
    digests whatever the saver's thread count, more threads than cores too
    (the native encoder keeps its state per call and per thread; the card's
    host checks the same)."""
    with ImageSaver(num_threads=threads) as saver:
        for name, a in SOURCES.items():
            saver.save(a, str(tmp_path / name))
    assert {n: sha((tmp_path / n).read_bytes()) for n in SOURCES} == digests.AVIF_ENCODE


@pytest.mark.parametrize("seed", range(6))
def test_range_coder_round_trip(seed):
    """Random symbols over random CDFs (some skewed, adapting as they code;
    size 0: 8-bit literals) through the encoder's range coder, read back by
    the decoder's symbol reader: the same symbols and the same adapted CDFs."""
    rng = np.random.default_rng(2200 + seed)
    n = int(rng.integers(1, 4000))
    sizes = rng.integers(0, 17, n).astype(np.int32)
    sizes[sizes == 1] = 2
    offsets = np.zeros(n, np.int32)
    cdfs = []
    for i, N in enumerate(sizes):
        offsets[i] = len(cdfs)
        if N == 0:
            continue
        w = rng.random(N) ** (8 if rng.random() < 0.3 else 1) + 1e-4
        c = np.maximum.accumulate(np.clip(np.round(np.cumsum(w) / w.sum() * 32768), 1, 32768))
        c[-1] = 32768
        cdfs += [int(v) for v in c] + [int(rng.integers(0, 33))]
    symbols = np.array([rng.integers(0, 256) if N == 0 else rng.integers(0, N) for N in sizes],
                       np.int32)
    data, back, enc_cdfs, dec_cdfs = native_image.av1_symbols_round_trip(
        symbols, sizes, offsets, np.array(cdfs + [0], np.uint16))
    np.testing.assert_array_equal(back, symbols)
    np.testing.assert_array_equal(enc_cdfs, dec_cdfs)
    assert len(data) < 2 * n + 8


def libavif_yuv420(rgb: np.ndarray):
    """libavif's ``avifImageRGBToYUV`` of an RGB(A) array, as Pillow's save
    calls it (BT.601, full range, 4:2:0, its defaults), through Pillow's
    own libavif."""
    import ctypes
    import glob

    import PIL

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                             "pillow.libs", "libavif-*.so*"))[0])
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = (ctypes.c_uint32,) * 3 + (ctypes.c_int,)
    lib.avifImageRGBToYUV.argtypes = lib.avifRGBImageSetDefaults.argtypes = (ctypes.c_void_p,) * 2
    lib.avifImageDestroy.argtypes = (ctypes.c_void_p,)

    class RGBImage(ctypes.Structure):  # avifRGBImage of libavif 1.3.0
        _fields_ = [(k, ctypes.c_uint32) for k in ("width", "height", "depth")] + [
            (k, ctypes.c_int) for k in ("format", "chromaUpsampling", "chromaDownsampling",
                                        "avoidLibYUV", "ignoreAlpha", "alphaPremultiplied",
                                        "isFloat", "maxThreads")] + [
            ("pixels", ctypes.c_void_p), ("rowBytes", ctypes.c_uint32)]

    class YUVImage(ctypes.Structure):  # the head of avifImage
        _fields_ = [(k, ctypes.c_uint32) for k in ("width", "height", "depth")] + [
            (k, ctypes.c_int) for k in ("yuvFormat", "yuvRange", "chromaSamplePosition")] + [
            ("planes", ctypes.c_void_p * 3), ("rowBytes", ctypes.c_uint32 * 3)]

    h, w, c = rgb.shape
    img = lib.avifImageCreate(w, h, 8, 3)  # AVIF_PIXEL_FORMAT_YUV420
    try:
        rgbi = RGBImage()
        lib.avifRGBImageSetDefaults(ctypes.byref(rgbi), img)
        rgbi.format = 0 if c == 3 else 1  # AVIF_RGB_FORMAT_RGB / RGBA
        pixels = np.ascontiguousarray(rgb)
        rgbi.pixels, rgbi.rowBytes = pixels.ctypes.data, w * c
        assert lib.avifImageRGBToYUV(img, ctypes.byref(rgbi)) == 0
        yuv = YUVImage.from_address(img)
        out = []
        for i, (pw, ph) in enumerate(((w, h), ((w + 1) // 2, (h + 1) // 2), ((w + 1) // 2, (h + 1) // 2))):
            rb = yuv.rowBytes[i]
            buf = (ctypes.c_uint8 * (rb * ph)).from_address(yuv.planes[i])
            out.append(np.ctypeslib.as_array(buf).reshape(ph, rb)[:, :pw].copy())
        return out
    finally:
        lib.avifImageDestroy(img)


@pytest.mark.parametrize("shape", ((1, 1, 3), (5, 3, 4), (33, 35, 3), (48, 64, 4), (120, 161, 3)))
def test_rgb_to_yuv_is_libavifs(shape):
    """The port's conversion is libavif's, sample for sample, on random
    RGB(A) of odd and even sizes."""
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    for ours, ref in zip(native_image.rgb_to_yuv420(rgb), libavif_yuv420(rgb)):
        np.testing.assert_array_equal(ours, ref)


# (height, width): levels 2.0 to 6.0, 64 and 128 superblocks, 1 to 8 tiles
HEADER_SIZES = ((1, 1), (2, 2), (3, 5), (1, 640), (640, 1), (33, 33), (65, 130), (480, 640),
                (481, 481), (640, 480), (513, 512), (1024, 1024), (1080, 1920), (200, 4100),
                (2048, 2048), (3000, 3000))


@pytest.mark.parametrize("size", HEADER_SIZES)
def test_headers_and_tiles_by_size(size):
    """A flat image of each size: the port's ``ftyp``, ``av1C``, sequence
    header and tile counts are those of Pillow's file written with
    ``max_threads=8`` (the host libavif's tile rule reads; the port
    follows it for 8 threads on every host)."""
    a = np.full(size + (3,), (30, 160, 220), np.uint8)
    b = io.BytesIO()
    Image.fromarray(a).save(b, format="AVIF", max_threads=8)
    ref, ours = b.getvalue(), avif.encode_avif(a)
    assert boxes(ours) == boxes(ref)
    r, o = avif.parse_avif(ref).color, avif.parse_avif(ours).color
    assert sequence_header(o) == sequence_header(r)
    ri, oi = native_image.av1_info(r), native_image.av1_info(o)
    assert (oi["tile_cols"], oi["tile_rows"]) == (ri["tile_cols"], ri["tile_rows"])
