"""Photoshop documents in the port's codec (``assets/psd.py``) against
Pillow 12.1.0's ``Image.open(p).convert("RGBA")``, which reads the
composite image: every ``(mode, bits)`` of Pillow's ``MODES`` (bitmap,
grey, indexed with and without its palette, RGB, RGB with a fourth
channel, CMYK, multichannel, duotone) x raw and PackBits x sizes (odd
widths, one row, one column) x channel counts past what the mode uses
(Pillow's PackBits table then covers only the channels it reads) x image
resources and a layer block to skip; PackBits packets that cross a row's
end, and 0x80; and what Pillow refuses, with its exception and words.
OpenCV reads no PSD (``read_image_cv2`` gives None); the JAX package's
paths on PSD files are in ``test_torch_icons.py``."""

import io

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import image, psd
from torch_image_fixtures import psd_file, psd_resource

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

# Photoshop mode -> (name, the channels Pillow reads)
MODES = {0: ("bitmap", 1), 1: ("grey", 1), 2: ("indexed", 1), 3: ("rgb", 3), 4: ("cmyk", 4),
         7: ("multichannel", 1), 8: ("duotone", 1)}
SIZES = ((19, 29), (1, 1), (1, 40), (33, 1), (8, 16), (61, 17))


def pillow_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _same_reading(data: bytes, what: str) -> None:
    """The port's reading is Pillow's: the same pixels, or an ``OSError``
    of the same words where Pillow's decoder runs out of data (a PackBits
    table that Pillow reads short of the file's channels can send it past
    the end)."""
    try:
        want = pillow_rgba(data)
    except OSError as e:
        assert "image file is truncated" in str(e), what
        with pytest.raises(OSError, match="image file is truncated"):
            image.decode_image(data, "x.psd")
        return
    np.testing.assert_array_equal(image.decode_image(data, "x.psd"), want, err_msg=what)


def planes(mode: int, channels: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded channels with runs in them (PackBits' repeat packets)."""
    rng = np.random.default_rng(seed)
    if mode == 0:
        bits = rng.integers(0, 2, (h, w)).astype(np.uint8)
        bits[h // 3:, : w // 2] = 1
        return np.packbits(bits, axis=1)[None]
    ch = rng.integers(0, 256, (channels, h, w)).astype(np.uint8)
    ch[:, h // 2:, w // 3:] = rng.integers(0, 256, (channels, 1, 1))
    return ch


@pytest.mark.parametrize("compression", (0, 1))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_pillow(mode, compression):
    name, used = MODES[mode]
    rng = np.random.default_rng(mode)
    for i, (h, w) in enumerate(SIZES):
        for extra in (0, 1, 2) if mode != 0 else (0,):
            p = planes(mode, used + extra, h, w, 10 * i + extra)
            kw = dict(width=w, bits=1) if mode == 0 else {}
            if mode == 2 and extra != 1:
                kw["color_data"] = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
            data = psd_file(p, mode, compression=compression, **kw)
            _same_reading(data, f"{name} {h}x{w} +{extra}")


def test_resources_and_layers_are_skipped():
    """Image resources with odd and even names and data, an ICC profile
    among them, and a layer block: skipped as Pillow skips them."""
    p = planes(3, 3, 11, 13, 1)
    res = (psd_resource(1039, b"icc", b"abc") + psd_resource(1005, b"", b"1234")
           + psd_resource(1036, b"thumb", bytes(7)) + psd_resource(4000, b"xy", b""))
    for r in (b"", res, psd_resource(1039, b"", b"x")):
        for layers in (b"", bytes(12), b"\0\0\0\x08" + bytes(8)):
            for comp in (0, 1):
                data = psd_file(p, 3, resources=r, layers=layers, compression=comp)
                np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))


def test_packbits_packets_across_rows():
    """Pillow's decoder runs on across rows: a packet that passes a row's
    end loses its excess, 0x80 is skipped, and the table's row lengths are
    not consulted (only their sum moves to the next channel)."""
    h, w = 4, 6
    streams = (
        bytes([0xFD, 7]) * 4 + bytes([0x80]) + bytes([0xFB, 9]) * 4,  # runs of 4 then of 6
        bytes([0x07]) + bytes(range(8)) + bytes([0x05]) + bytes(range(6)) * 3 + bytes([0xF9, 3]),
        bytes([0x80, 0x80]) + bytes([0xF9, 200]) * 4,  # runs of 8 into rows of 6
    )
    for body in streams:
        head = b"8BPS" + bytes([0, 1]) + bytes(6) + bytes([0, 1]) + h.to_bytes(4, "big")
        head += w.to_bytes(4, "big") + bytes([0, 8, 0, 1]) + bytes(12) + b"\0\x01"
        data = head + (len(body)).to_bytes(2, "big") + bytes(2 * (h - 1)) + body + bytes(64)
        np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))
    got = psd.packbits_rows(bytes([0xFD, 5, 0x80, 0x02, 6, 7, 8]), 0, 2, 3)
    np.testing.assert_array_equal(got, [[5, 5, 5], [6, 7, 8]])
    with pytest.raises(OSError, match="image file is truncated"):
        psd.packbits_rows(bytes([0xFD, 5, 0x01, 6, 7]), 0, 2, 3)


def _reading(fn, data):
    try:
        return fn(data)
    except Exception as e:  # noqa: BLE001  (compared with Pillow's)
        return e


REFUSED = {
    "16-bit": (lambda p: psd_file(p[:3], 3, bits=16), "cannot identify image file"),
    "32-bit": (lambda p: psd_file(p[:1], 1, bits=32), "cannot identify image file"),
    "mode 5": (lambda p: psd_file(p[:1], 5), "cannot identify image file"),
    "version 2": (lambda p: psd_file(p[:3], 3).replace(b"8BPS\0\1", b"8BPS\0\2", 1),
                  "cannot identify image file"),
    "two channels as RGB": (lambda p: psd_file(p[:2], 3), "not enough channels"),
    "three as CMYK": (lambda p: psd_file(p[:3], 4), "not enough channels"),
    "ZIP": (lambda p: psd_file(p[:3], 3, compression=2), "cannot load this image"),
    "ZIP with prediction": (lambda p: psd_file(p[:1], 1, compression=3), "cannot load this image"),
    "raw, cut": (lambda p: psd_file(p[:3], 3)[:-1], "image file is truncated"),
    "cut in the resources": (lambda p: psd_file(p[:3], 3, resources=psd_resource(
        1039, b"icc", bytes(40)))[:60], "cannot identify image file"),
    "cut in the row lengths": (lambda p: psd_file(p[:3], 3, compression=1)[:40],
                               "cannot identify image file"),
    "cut before the compression": (lambda p: psd_file(p[:3], 3)[:37],
                                   "cannot identify image file"),
    "PackBits, cut": (lambda p: psd_file(p[:4], 3, compression=1)[:-3],
                      "image file is truncated"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refusals_match_pillow(what):
    make, words = REFUSED[what]
    data = make(planes(3, 4, 9, 14, 3))
    ref, got = _reading(pillow_rgba, data), _reading(image.decode_image, data)
    assert isinstance(ref, OSError) and words in str(ref)
    assert isinstance(got, OSError) and words in str(got)


def test_lab_is_refused_by_name():
    """Pillow converts LAB to RGBA through LittleCMS; the port raises."""
    data = psd_file(planes(9, 3, 5, 6, 4), 9)
    assert pillow_rgba(data).shape == (5, 6, 4)
    with pytest.raises(NotImplementedError, match="LAB"):
        image.decode_image(data)


def test_opencv_reads_no_psd(tmp_path):
    for i, mode in enumerate((1, 3, 4)):
        path = tmp_path / f"x{i}.psd"
        path.write_bytes(psd_file(planes(mode, MODES[mode][1], 7, 9, i), mode, compression=i % 2))
        assert cv2.imread(str(path), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH) is None
        assert image.read_image_cv2(str(path)) is None
        np.testing.assert_array_equal(image.read_image(str(path)),
                                      np.asarray(Image.open(path).convert("RGBA")))
