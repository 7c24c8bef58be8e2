"""The port's BMP, TGA, GIF and TIFF codecs (``assets/bmp.py``, ``tga.py``,
``gif.py``, ``tiff.py``) against Pillow 12.1.0 and OpenCV 5.0.0 on the same
bytes.

Every case is a file that Pillow or OpenCV wrote, or that a writer of
``torch_image_fixtures.py`` made for a variant neither writes. Each decodes
through ``image.decode_image`` bitwise to ``Image.open(f).convert("RGBA")``
and through ``image.read_image_cv2`` bitwise (shape, dtype, values) to
``cv2.imread(f, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` (None for TGA, which
OpenCV does not read, and wherever OpenCV reads nothing; the WhiteIsZero
TIFF and the OS/2 BMP, which the port does not read as OpenCV does, raise
by name there). Where Pillow cannot read a file, neither does the port's
Pillow reading. The encoders write Pillow's ``save``
bytes for L, RGB and RGBA (and 16-bit grey as TIFF), and refuse what Pillow
refuses with its message. A header that claims an image over Pillow's (or
OpenCV's) size limit raises in every format, as it does there. The committed fixtures (``assets/image_fixtures``)
are what ``torch_image_fixtures.make_fixtures`` regenerates with Pillow, and
the port reads them, and writes JPEG, to Pillow's recorded digests.
"""

import hashlib
import io
import os
import struct
import zlib

import numpy as np
import pytest

from stillleben_tpu_torch.assets import bmp, image, tga, tiff
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import (
    bmp as make_bmp, gif, raw_rows, rle8_bmp, smooth, tga as make_tga, tga_rle,
    tiff as make_tiff,
)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
H, W = 23, 37


def pil(a, fmt, mode=None, **kw) -> bytes:
    return pil_image(Image.fromarray(a, mode) if mode else Image.fromarray(a), fmt, **kw)


def pil_image(img, fmt, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def rgb(seed=1):
    return smooth(H, W, 3, seed)


def rgba(seed=2):
    return np.concatenate([smooth(H, W, 3, seed), smooth(H, W, 1, seed + 50)], -1)


def grey(seed=3):
    return smooth(H, W, 1, seed)[..., 0]


def index(n, seed=4):
    return np.random.default_rng(seed).integers(0, n, (H, W)).astype(np.uint8)


def palette(n, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


def quantized(colours=16):
    return Image.fromarray(rgb(6)).quantize(colours, method=Image.Quantize.MEDIANCUT)


def cv2_bytes(a, ext, params=()):
    ok, enc = cv2.imencode(ext, a[..., ::-1] if a.ndim == 3 else a, list(params))
    assert ok
    return enc.tobytes()


def _bgrx(a):
    return np.concatenate([a[..., ::-1], np.full(a.shape[:2] + (1,), 7, np.uint8)], -1)


def _bgra(a):
    return np.concatenate([a[..., 2::-1], a[..., 3:]], -1)


def _555(a, top_bit=0):
    v = (a[..., 0].astype(np.uint16) >> 3 << 10) | (a[..., 1].astype(np.uint16) >> 3 << 5) | (
        a[..., 2].astype(np.uint16) >> 3)
    return (v | (top_bit << 15)).astype("<u2")


def _565(a):
    return ((a[..., 0].astype(np.uint16) >> 3 << 11) | (a[..., 1].astype(np.uint16) >> 2 << 5)
            | (a[..., 2].astype(np.uint16) >> 3)).astype("<u2")


BMP = {
    "pillow L": lambda: pil(grey(), "BMP"),
    "pillow RGB": lambda: pil(rgb(), "BMP"),
    "pillow RGBA": lambda: pil(rgba(), "BMP"),
    "pillow P": lambda: pil_image(quantized(), "BMP"),
    "opencv RGB": lambda: cv2_bytes(rgb(), ".bmp"),
    "1-bit palette": lambda: make_bmp(raw_rows(index(2), 1), W, H, 1, palette=palette(2)),
    "1-bit black and white": lambda: make_bmp(raw_rows(index(2), 1), W, H, 1,
                                              palette=np.array([[0] * 3, [255] * 3])),
    "4-bit palette": lambda: make_bmp(raw_rows(index(16), 4), W, H, 4, palette=palette(16)),
    "4-bit grey ramp": lambda: make_bmp(raw_rows(index(16), 4), W, H, 4,
                                        palette=np.repeat(np.arange(16)[:, None], 3, 1)),
    "8-bit 200 colours": lambda: make_bmp(raw_rows(index(200), 8), W, H, 8, palette=palette(200)),
    "RLE8": lambda: rle8_bmp(np.repeat(index(6), 3, axis=1)[:, :W], palette(6)),
    "RLE8 noisy": lambda: rle8_bmp(index(40), palette(40)),
    "RLE4": lambda: rle8_bmp(np.repeat(index(9), 2, axis=1)[:, :W], palette(9), rle4=True),
    "16-bit 5-5-5": lambda: make_bmp(raw_rows(_555(rgb()).view(np.uint8).reshape(H, W, 2), 16),
                                     W, H, 16),
    "16-bit 5-6-5 bitfields": lambda: make_bmp(
        raw_rows(_565(rgb()).view(np.uint8).reshape(H, W, 2), 16), W, H, 16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F)),
    "24-bit top-down": lambda: make_bmp(raw_rows(rgb()[..., ::-1], 24, top_down=True), W, H, 24,
                                        top_down=True),
    "32-bit": lambda: make_bmp(raw_rows(_bgrx(rgb()), 32), W, H, 32),
    "32-bit bitfields BGRA, v4 header": lambda: make_bmp(
        raw_rows(_bgra(rgba()), 32), W, H, 32, compression=3, header=108,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "32-bit bitfields RGBA, v5 header": lambda: make_bmp(
        raw_rows(rgba(), 32), W, H, 32, compression=3, header=124,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "OS/2 24-bit": lambda: make_bmp(raw_rows(rgb()[..., ::-1], 24), W, H, 24, header=12),
    "OS/2 8-bit palette": lambda: make_bmp(raw_rows(index(256), 8), W, H, 8, header=12,
                                           palette=palette(256)),
}

TGA = {
    "pillow L": lambda: pil(grey(), "TGA"),
    "pillow RGB": lambda: pil(rgb(), "TGA"),
    "pillow RGBA": lambda: pil(rgba(), "TGA"),
    "pillow RLE L": lambda: pil(grey(), "TGA", compression="tga_rle"),
    "pillow RLE RGB": lambda: pil(np.repeat(rgb(), 3, axis=1)[:, :W], "TGA", compression="tga_rle"),
    "pillow RLE RGBA": lambda: pil(rgba(), "TGA", compression="tga_rle"),
    "pillow P": lambda: pil_image(quantized(), "TGA"),
    "pillow top-down": lambda: pil(rgb(), "TGA", orientation=1),
    "16-bit 5-5-5 + alpha bit": lambda: make_tga(
        np.where(index(2).astype(bool), _555(rgb(), 1), _555(rgb(), 0))[::-1].tobytes(),
        W, H, 2, 16),
    "32-bit right-to-left": lambda: make_tga(_bgra(rgba())[::-1, ::-1].tobytes(), W, H, 2, 32,
                                             flags=0x18),
    "24-bit top-down right-to-left": lambda: make_tga(rgb()[:, ::-1, ::-1].tobytes(), W, H, 2, 24,
                                                      flags=0x30),
    "RLE 24-bit, literals across rows": lambda: make_tga(
        tga_rle(np.repeat(rgb()[::-1, :, ::-1], 5, axis=1)[:, :W].reshape(-1, 3), W),
        W, H, 10, 24),
    "RLE repeat packet across a row": lambda: make_tga(  # Pillow refuses it
        tga_rle(np.full((H * W, 1), 7, np.uint8)), W, H, 11, 8),
    "RLE grey + alpha": lambda: make_tga(
        tga_rle(np.stack([grey(), index(200)], -1)[::-1].reshape(-1, 2), W), W, H, 11, 16,
        flags=8),
    "colour map 32-bit from 10": lambda: make_tga(
        (index(30) + 10)[::-1].tobytes(), W, H, 1, 8, cmap_start=10, cmap_len=30, cmap_depth=32,
        cmap=np.concatenate([palette(30), index(30)[0, :30, None]], 1).astype(np.uint8).tobytes()),
    "colour map 16-bit": lambda: make_tga(
        index(20)[::-1].tobytes(), W, H, 1, 8, cmap_len=20, cmap_depth=16,
        cmap=_555(palette(20)[None])[0].tobytes()),
    "RLE colour map 24-bit with id": lambda: make_tga(
        tga_rle(np.repeat(index(12), 4, axis=1)[:, :W][::-1].reshape(-1, 1), W), W, H, 9, 8,
        cmap_len=12, cmap_depth=24, cmap=palette(12)[:, ::-1].tobytes(), ident=b"stillleben"),
}

GIF = {
    "pillow P": lambda: pil_image(quantized(), "GIF"),
    "pillow P transparent": lambda: pil_image(quantized(), "GIF", transparency=3),
    "pillow P interlaced": lambda: pil_image(quantized(), "GIF", interlace=True),
    "pillow L": lambda: pil(grey(), "GIF"),
    "local table only": lambda: gif(index(8), local_pal=palette(8)),
    "local over global": lambda: gif(index(30), global_pal=palette(4, 9), local_pal=palette(30)),
    "small frame, transparent": lambda: gif(index(5)[:15, :20], screen=(W, H), offset=(9, 4),
                                            global_pal=palette(5), transparency=2, background=4),
    "small frame": lambda: gif(index(5)[:15, :20], screen=(W, H), offset=(9, 4),
                               global_pal=palette(5), background=3),
    "frame past the screen": lambda: gif(index(7), screen=(W - 5, H - 3), offset=(2, 1),
                                         global_pal=palette(7)),
    "grey ramp local table": lambda: gif(index(16), global_pal=palette(16),
                                         local_pal=np.repeat(np.arange(16)[:, None], 3, 1)),
    "interlaced, transparent, 2 colours": lambda: gif(index(2), global_pal=palette(2),
                                                      interlace=True, transparency=1),
    "256 colours": lambda: gif(index(256), global_pal=palette(256)),
}


def _cmap(n, seed=8):
    return (np.random.default_rng(seed).integers(0, 256, (3, n)) * 257).astype(np.uint16)


TIFF = {
    "pillow L": lambda: pil(grey(), "TIFF"),
    "pillow RGB": lambda: pil(rgb(), "TIFF"),
    "pillow RGBA": lambda: pil(rgba(), "TIFF"),
    "pillow I;16": lambda: pil(smooth(H, W, 1, 9)[..., 0].astype(np.uint16) * 251, "TIFF"),
    "pillow P": lambda: pil_image(quantized(), "TIFF"),
    "pillow LA": lambda: pil(np.stack([grey(), index(256)], -1), "TIFF", mode="LA"),
    "pillow 1-bit": lambda: pil_image(Image.fromarray(grey()).convert("1"), "TIFF"),
    "opencv RGB": lambda: cv2_bytes(rgb(), ".tif"),
    "opencv RGB 16-bit": lambda: cv2_bytes(smooth(H, W, 3, 10).astype(np.uint16) * 257, ".tif"),
    "opencv RGBA 16-bit": lambda: cv2_bytes(
        np.concatenate([smooth(H, W, 3, 11), smooth(H, W, 1, 12)], -1).astype(np.uint16) * 255,
        ".tif"),
    "opencv grey 16-bit": lambda: cv2_bytes(smooth(H, W, 1, 13)[..., 0].astype(np.uint16) * 99,
                                            ".tif"),
    "tiles 16x16": lambda: make_tiff(rgb()[..., None, :][:, :, 0], 2, tile=(16, 16)),
    "tiles Deflate RGBA": lambda: make_tiff(rgba(), 2, tile=(16, 32), compression=8, extra=(2,)),
    "strips of 5 rows": lambda: make_tiff(rgb(), 2, rows=5),
    "big-endian 16-bit RGB": lambda: make_tiff(smooth(H, W, 3, 14).astype(np.uint16) * 257, 2,
                                               endian=">"),
    "big-endian 16-bit grey": lambda: make_tiff(smooth(H, W, 1, 15).astype(np.uint16) * 3, 1,
                                                endian=">"),
    "predictor Deflate 8-bit": lambda: make_tiff(rgb(), 2, compression=8, predictor=2, rows=7),
    "predictor Deflate 16-bit": lambda: make_tiff(smooth(H, W, 3, 16).astype(np.uint16) * 211, 2,
                                                  compression=8, predictor=2),
    "palette 4-bit": lambda: make_tiff(index(16)[..., None], 3, bits=4, colormap=_cmap(16)),
    "palette 8-bit big-endian": lambda: make_tiff(index(256)[..., None], 3, endian=">",
                                                  colormap=_cmap(256)),
    "grey 4-bit": lambda: make_tiff(index(16)[..., None], 1, bits=4),
    "grey 2-bit tiles": lambda: make_tiff(index(4)[..., None], 1, bits=2, tile=(16, 16)),
    "WhiteIsZero 8-bit": lambda: make_tiff(grey()[..., None], 0),
    "RGB extra sample unspecified": lambda: make_tiff(rgba(), 2, extra=(0,)),
    "PackBits RGB strips": lambda: make_tiff(np.repeat(rgb(), 4, axis=1)[:, :W], 2, rows=5,
                                             compression=32773),
}
for mode, make in (("L", grey), ("RGB", rgb), ("RGBA", rgba)):
    for comp in ("tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits"):
        TIFF[f"pillow {mode} {comp}"] = (lambda m=make, c=comp: pil(m(), "TIFF", compression=c))
TIFF["pillow I;16 tiff_lzw"] = lambda: pil(smooth(H, W, 1, 9)[..., 0].astype(np.uint16) * 251,
                                           "TIFF", compression="tiff_lzw")
TIFF["pillow P tiff_lzw"] = lambda: pil_image(quantized(), "TIFF", compression="tiff_lzw")

CASES = ([("bmp", k) for k in BMP] + [("tga", k) for k in TGA] + [("gif", k) for k in GIF]
         + [("tif", k) for k in TIFF])
BUILDERS = {"bmp": BMP, "tga": TGA, "gif": GIF, "tif": TIFF}


@pytest.mark.parametrize("ext, case", CASES, ids=[f"{e}: {c}" for e, c in CASES])
def test_decode_matches_pillow_and_opencv(ext, case, tmp_path):
    data = BUILDERS[ext][case]()
    try:
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except (OSError, ValueError):  # what Pillow cannot read, the port's Pillow reading refuses
        with pytest.raises((OSError, ValueError)):
            image.decode_image(data, f"x.{ext}")
    else:
        got = image.decode_image(data, f"x.{ext}")
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / f"x.{ext}")
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, CV2_FLAGS)
    if case in ("OS/2 24-bit", "OS/2 8-bit palette"):
        with pytest.raises(NotImplementedError, match="OS/2"):
            image.read_image_cv2(path)
        return
    have = image.read_image_cv2(path)
    if want is None:
        assert have is None
        return
    assert have.dtype == want.dtype and have.shape == want.shape
    np.testing.assert_array_equal(have, want)


ENCODERS = {"BMP": bmp.encode_bmp, "TGA": tga.encode_tga, "TIFF": tiff.encode_tiff}
ARRAYS = {"L": grey, "RGB": rgb, "RGBA": rgba,
          "I;16": lambda: smooth(H, W, 1, 9)[..., 0].astype(np.uint16) * 251}


@pytest.mark.parametrize("size", [(1, 1), (H, W), (480, 640)])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("fmt", ["BMP", "TGA", "TIFF"])
def test_encode_equals_pillow(fmt, mode, size):
    a = ARRAYS[mode]()
    if size != (H, W):
        a = np.resize(a, size + a.shape[2:])
    try:
        ref = pil(a, fmt)
    except OSError as e:  # Pillow refuses the mode: so does the port, in its words
        with pytest.raises(OSError) as got:
            ENCODERS[fmt](a)
        assert str(got.value) == str(e)
        return
    assert ENCODERS[fmt](a) == ref
    back = np.asarray(Image.open(io.BytesIO(ref)))
    if mode != "RGBA" or fmt != "BMP":  # Pillow reads a 32-bit BMP back as RGB
        np.testing.assert_array_equal(back, a)


def test_fixtures_are_pillows():
    """The committed fixtures and digests (``assets/image_fixtures``) are what
    ``torch_image_fixtures.py`` regenerates with Pillow here: the same bytes,
    the same SHA-256 of Pillow's decodes and JPEG encodes."""
    from stillleben_tpu_torch.assets.image_fixtures import FILES, digests, path
    from torch_image_fixtures import digests as pillow_digests, make_fixtures

    files = make_fixtures()
    assert sorted(files) == sorted(FILES)
    for name, data in files.items():
        with open(path(name), "rb") as f:
            assert f.read() == data, name
    d = pillow_digests(files)
    assert d == {"DECODE": digests.DECODE, "JPEG_ENCODE": digests.JPEG_ENCODE,
                 "JPEG_ENCODE_DECODE": digests.JPEG_ENCODE_DECODE}
    assert sum(os.path.getsize(path(n)) for n in FILES) <= 200 * 1024


@pytest.mark.parametrize("name", ["progressive.jpg", "interlaced.gif", "lzw.tif", "deflate.tif",
                                  "rle8.bmp", "rle.tga"])
def test_port_decodes_fixture_to_pillows_digest(name):
    from stillleben_tpu_torch.assets.image_fixtures import digests, path

    with open(path(name), "rb") as f:
        got = image.decode_image(f.read(), name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == digests.DECODE[name]


@pytest.mark.parametrize("name", ["texture", "frame"])
def test_port_jpeg_of_seeded_image_is_pillows(name):
    from stillleben_tpu_torch.assets import jpeg
    from stillleben_tpu_torch.assets.image_fixtures import digests, seeded_images

    enc = jpeg.encode_jpeg(seeded_images()[name])
    assert hashlib.sha256(enc).hexdigest() == digests.JPEG_ENCODE[name]
    dec = jpeg.decode_jpeg(enc)
    assert hashlib.sha256(dec.tobytes()).hexdigest() == digests.JPEG_ENCODE_DECODE[name]


def _patched(data: bytes, at: int, fmt: str, *values) -> bytes:
    return data[:at] + struct.pack(fmt, *values) + data[at + struct.calcsize(fmt):]


def _png_sized(w, h):
    data = image.encode_png(grey())
    data = _patched(data, 16, ">II", w, h)
    return _patched(data, 29, ">I", zlib.crc32(data[12:29]) & 0xFFFFFFFF)


def _jpeg_sized(w, h):
    data = pil(grey(), "JPEG")
    sof = data.index(b"\xff\xc0")
    return _patched(data, sof + 5, ">HH", h, w)


# a small file whose header claims a w x h image, per format
SIZED = {
    "png": _png_sized,
    "ppm": lambda w, h: b"P6\n%d %d\n255\n" % (w, h) + bytes(64),
    "jpg": _jpeg_sized,
    "bmp": lambda w, h: _patched(bmp.encode_bmp(rgb()), 18, "<ii", w, h),
    "tga": lambda w, h: _patched(tga.encode_tga(rgb()), 12, "<HH", w, h),
    "gif": lambda w, h: _patched(pil_image(quantized(), "GIF"), 6, "<HH", w, h),
    "tif": lambda w, h: _patched(_patched(tiff.encode_tiff(rgb()), 18, "<I", w), 30, "<I", h),
    "hdr": lambda w, h: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
                        + bytes(64),
}


@pytest.mark.parametrize("ext", [e for e in SIZED if e != "hdr"])
def test_decompression_bomb_refused_as_pillow(ext):
    """A header that claims more pixels than Pillow opens (twice
    ``Image.MAX_IMAGE_PIXELS``) raises before a pixel is decoded, in every
    format, where Pillow raises ``DecompressionBombError``."""
    data = SIZED[ext](20000, 20000)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data)).convert("RGBA")
    with pytest.raises(ValueError, match="decompression bomb"):
        image.decode_image(data, f"x.{ext}")


OVERSIZE = ([(e, (40000, 40000)) for e in SIZED if e != "tga"]
            + [(e, ((1 << 20) + 1, 1)) for e in ("ppm", "bmp", "tif", "hdr")])


@pytest.mark.parametrize("ext, size", OVERSIZE, ids=[f"{e} {w}x{h}" for e, (w, h) in OVERSIZE])
def test_oversize_refused_as_opencv(ext, size, tmp_path):
    """A header over OpenCV's limits (2^30 pixels; 2^20 a side) raises in
    ``read_image_cv2`` where ``cv2.imread`` raises."""
    path = str(tmp_path / f"x.{ext}")
    with open(path, "wb") as f:
        f.write(SIZED[ext](*size))
    with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE"):
        cv2.imread(path, CV2_FLAGS)
    with pytest.raises(ValueError, match="OpenCV's limits"):
        image.read_image_cv2(path)


def test_rle_delta_past_the_image_is_clamped():
    """An RLE8 delta of 255 rows on a wide image appends what Pillow's
    decoder appends, but the port keeps only the image's bytes: the decode
    equals Pillow's, with no allocation of the skipped rows."""
    w, h = 50000, 4
    stream = bytes([3, 1, 0, 2, 0, 0, 9, 255, 0, 1])  # a run, a delta, end of bitmap
    data = make_bmp(stream, w, h, 8, compression=1, palette=palette(4))
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(image.decode_image(data, "x.bmp"), ref)
