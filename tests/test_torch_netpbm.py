"""The port's Netpbm codec (``assets/netpbm.py``) and DIB (``assets/bmp.py``)
against Pillow 12.1.0 and OpenCV 5.0.0 on the same bytes.

- The read matrix: ``P1``-``P6`` plain and raw at maxvals from 1 to
  65535 (Pillow's rescaling to 8 or 16 bits and its clip at 255, OpenCV's
  samples as stored), ``Pf``/``PF`` in both byte orders with NaN and
  infinities, PAM, headers with comments and odd blanks, and the files
  either library refuses (bad maxval, size, tokens, samples, data that
  ends early, ``P7`` and ``PF`` for Pillow). ``decode_netpbm`` equals
  ``Image.open(p).convert("RGBA")`` and ``decode_netpbm_cv2`` equals
  ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``, or each raises (or
  gives None) where its library does. The PAM layouts OpenCV converts
  through uninitialised memory raise ``NotImplementedError``.
- ``encode_netpbm`` writes Pillow's bytes for every extension and mode;
  a 16-bit PGM reads back bitwise both ways.
- ``encode_dib`` writes Pillow's DIB; ``decode_dib`` reads a headerless
  DIB as ``Image.open``; OpenCV reads none.
"""

import io
import os
import struct

import numpy as np
import pytest

from stillleben_tpu_torch.assets import bmp, image, netpbm
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import pillow_save

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def _be16(v) -> bytes:
    return np.asarray(v, ">u2").tobytes()


def _pam(width, height, depth, maxval, tupltype, body, extra=b""):
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (width, height, depth, maxval)
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + extra + b"ENDHDR\n" + body


def read_cases() -> dict[str, bytes]:
    """The read matrix, by name."""
    rng = np.random.default_rng(11)
    c = {
        # the table of what each library makes of a hand-made file
        "P1": b"P1\n3 1\n1 0 1\n",
        "P1 without blanks": b"P1\n3 1\n101",
        "P4": b"P4\n3 1\n\xa0",
        "P2": b"P2\n3 1\n255\n0 128 255\n",
        "P2 maxval 1000": b"P2\n3 1\n1000\n3 500 1000\n",
        "P2 maxval 100": b"P2\n3 1\n100\n3 50 100\n",
        "P2 sample over maxval": b"P2\n3 1\n100\n3 50 200\n",
        "P2 ending on a digit": b"P2\n3 1\n255\n0 128 255",
        "P2 maxval 65535": b"P2\n2 1\n65535\n65535 300\n",
        "P5 maxval 65535": b"P5\n3 1\n65535\n" + _be16([1000, 30000, 65535]),
        "P5 maxval 1000": b"P5\n3 1\n1000\n" + _be16([3, 500, 1000]),
        "P5 maxval 256": b"P5\n2 1\n256\n" + _be16([256, 128]),
        "P5 maxval 100": b"P5\n3 1\n100\n" + bytes([3, 50, 100]),
        "P5 sample over maxval": b"P5\n3 1\n100\n" + bytes([3, 50, 200]),
        "P3": b"P3\n2 1\n255\n1 2 3 4 5 6\n",
        "P3 maxval 1000": b"P3\n2 1\n1000\n1 2 3 400 500 1000\n",
        "P6 maxval 65535": b"P6\n1 1\n65535\n" + _be16([1000, 30000, 65535]),
        "P6 maxval 100": b"P6\n1 1\n100\n" + bytes([50, 100, 10]),
        "P6": b"P6\n1 1\n255\n" + bytes([50, 100, 10]),
        "Pf": b"Pf\n3 1\n-1.0\n" + np.array([0.5, -1, 300.7], "<f4").tobytes(),
        "Pf big-endian": b"Pf\n3 1\n2.0\n" + np.array([0.5, -1, 300.7], ">f4").tobytes(),
        "Pf rows": b"Pf\n1 2\n-1.0\n" + np.array([1.5, 7.9], "<f4").tobytes(),
        "Pf NaN and infinities": b"Pf\n4 1\n-1.0\n" + np.array(
            [np.nan, np.inf, -np.inf, 254.99], "<f4").tobytes(),
        "PF": b"PF\n1 1\n-1.0\n" + np.array([0.5, 1.0, 2], "<f4").tobytes(),
        "PF scale 3": b"PF\n5 3\n3.0\n" + rng.random(45).astype(">f4").tobytes(),
        "PF scale -0.7": b"PF\n5 3\n-0.7\n" + (rng.random(45) * 90).astype("<f4").tobytes(),
        "P7 RGB": _pam(1, 1, 3, 255, b"RGB", bytes([10, 20, 30])),
        "P7 grey": _pam(2, 1, 1, 255, b"GRAYSCALE", bytes([10, 20])),
        "P7 RGB 16-bit": _pam(1, 1, 3, 65535, b"RGB", _be16([1000, 2000, 3000])),
        "P7 without TUPLTYPE": _pam(1, 1, 3, 255, None, bytes([10, 20, 30])),
        "P7 maxval 100": _pam(1, 1, 3, 100, b"RGB", bytes([10, 20, 30])),
        "P7 comments and blank lines": _pam(3, 2, 1, 200, b"GRAYSCALE", bytes(range(6)),
                                            b"# a comment\n\n  \n"),
        "P7 unknown TUPLTYPE": _pam(1, 1, 3, 255, b"CMYK", bytes(3)),
        "P7 without DEPTH": b"P7\nWIDTH 1\nHEIGHT 1\nMAXVAL 255\nENDHDR\n" + bytes(3),
        "P7 WIDTH twice": b"P7\nWIDTH 1\nWIDTH 1\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x07",
        "P7 truncated": _pam(4, 4, 3, 255, b"RGB", bytes(40)),
        "P7 grey alpha": _pam(2, 1, 2, 255, b"GRAYSCALE_ALPHA", bytes([10, 20, 30, 40])),
        "P7 RGB alpha": _pam(3, 1, 4, 255, b"RGB_ALPHA", bytes(range(12))),
        "P7 black and white": _pam(2, 1, 1, 1, b"BLACKANDWHITE", bytes([0, 1])),
        # headers: comments, blanks, Pillow's comment inside a token
        "comments": b"P6 #c\n1#x\n 1\n255\n" + bytes([50, 100, 10]),
        "comment inside a token": b"P6\n1#x\n2 1\n255\n" + bytes([50, 100, 10]) * 12,
        "comment lines": b"P5\n# made by hand\n# twice\r4 2\n#\n255\n" + bytes(range(8)),
        "tabs and CR": b"P5\t4\r\n2\x0b\x0c255\n" + bytes(range(8)),
        "plain with comments": b"P2\n# c\n3 2\n255\n1 2 # mid\n3\n4 5\n6\n",
        "plain with tabs": b"P3\t2\t1\t255\t1\t2\t3\t4\t5\t6\t",
        "plain bits with comments": b"P1\n5 2 # c\n10101\n#\n01010\n",
        "plus sign": b"P6\n+1 1\n255\n" + bytes(3),
        # what a library refuses
        "maxval 0": b"P6\n1 1\n0\n" + bytes([1, 2, 3]),
        "maxval 65536": b"P5\n1 1\n65536\n" + bytes(2),
        "width 0": b"P6\n0 1\n255\n",
        "negative width": b"P6\n-1 1\n255\n" + bytes(3),
        "token too long": b"P5\n12345678901 1\n255\n" + bytes(3),
        "EOF in the header": b"P5\n4 ",
        "raw truncated": b"P6\n2 1\n255\n" + bytes([50, 100, 10]),
        "raw 16-bit truncated": b"P5\n2 1\n65535\n" + bytes([1, 2]),
        "rescaled truncated": b"P6\n2 2\n1000\n" + _be16([1, 2, 3, 4, 5]),
        "plain truncated": b"P2\n3 2\n255\n1 2 3 4\n",
        "plain bits truncated": b"P1\n3 2\n1 0 1 1\n",
        "plain negative": b"P2\n2 1\n255\n-1 3\n",
        "plain not a number": b"P2\n2 1\n255\n1 x\n",
        "plain bits not a bit": b"P1\n2 1\n1 2\n",
        "Pf scale 0": b"Pf\n1 1\n0.0\n" + bytes(4),
        "Pf truncated": b"Pf\n2 2\n-1.0\n" + bytes(12),
        "Pf header without a line break": b"Pf 1 1\n-1.0\n" + bytes(4),
        "junk after the magic": b"P6#\n1 1\n255\n" + bytes(3),
        "P8": b"P8\n1 1\n255\n" + bytes(3),
    }
    for maxval in (1, 2, 100, 255, 256, 1000, 65535):
        wide = maxval > 255
        for magic, ch in ((b"P5", 1), (b"P6", 3)):
            v = rng.integers(0, maxval + 1, (23, 37, ch))
            body = _be16(v) if wide else v.astype(np.uint8).tobytes()
            c[f"{magic.decode()} 37x23 maxval {maxval}"] = (
                magic + b"\n37 23\n%d\n" % maxval + body)
        for magic, ch in ((b"P2", 1), (b"P3", 3)):
            v = rng.integers(0, maxval + 1, (5, 9 * ch))
            rows = b"\n".join(b" ".join(b"%d" % x for x in r) for r in v)
            c[f"{magic.decode()} 9x5 maxval {maxval}"] = magic + b"\n9 5\n%d\n" % maxval + rows + b"\n"
    bits = rng.integers(0, 2, (5, 37)).astype(np.uint8)
    c["P4 37x5"] = b"P4\n37 5\n" + np.packbits(bits, axis=1).tobytes()
    c["P1 37x5"] = b"P1\n37 5\n" + b"\n".join(b" ".join(b"%d" % x for x in r) for r in bits) + b"\n"
    return c


READ = read_cases()
# OpenCV converts these PAM layouts through uninitialised memory
REFUSED_CV2 = ("P7 grey alpha", "P7 RGB alpha", "P7 black and white")
# Pillow's exceptions -> the port's
PIL_ERRORS = {"UnidentifiedImageError": ValueError, "ValueError": ValueError, "OSError": OSError}


def _write(tmp_path, data: bytes, name: str = "x.pnm") -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


@pytest.mark.parametrize("case", sorted(READ))
def test_reads_like_pillow(tmp_path, case):
    data = READ[case]
    try:
        ref = np.asarray(Image.open(_write(tmp_path, data)).convert("RGBA"))
    except Exception as e:  # noqa: BLE001 - the port raises where Pillow raises
        with pytest.raises(PIL_ERRORS[type(e).__name__]):
            netpbm.decode_netpbm(data)
        return
    got = netpbm.decode_netpbm(data)
    assert (got.shape, got.dtype) == (ref.shape, ref.dtype)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(image.read_image(_write(tmp_path, data)), ref)


@pytest.mark.parametrize("case", sorted(READ))
def test_reads_like_opencv(tmp_path, case):
    data = READ[case]
    if case in REFUSED_CV2:
        with pytest.raises(NotImplementedError, match="PAM"):
            netpbm.decode_netpbm_cv2(data)
        return
    path = _write(tmp_path, data)
    ref = cv2.imread(path, CV2_FLAGS)
    got = image.read_image_cv2(path)
    if ref is None:
        assert got is None
        return
    assert (got.shape, got.dtype) == (ref.shape, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def test_matrix_reaches_each_reading():
    """Every Pillow and OpenCV outcome is in the matrix: each mode, each
    exception, None."""
    modes, errors, nones = set(), set(), 0
    for data in READ.values():
        try:
            modes.add(Image.open(io.BytesIO(data)).mode)
        except Exception as e:  # noqa: BLE001
            errors.add(type(e).__name__)
    assert modes == {"1", "L", "I", "RGB", "F"}
    assert errors == {"UnidentifiedImageError", "ValueError"}
    for name, data in READ.items():
        if name in REFUSED_CV2:
            continue
        nones += netpbm.decode_netpbm_cv2(data) is None
    assert nones >= 10


def test_truncated_raw_raises_oserror():
    """Raw data that ends early: Pillow's "image file is truncated"."""
    for name in ("raw truncated", "raw 16-bit truncated"):
        with pytest.raises(OSError, match="truncated"):
            Image.open(io.BytesIO(READ[name])).load()
        with pytest.raises(OSError, match="truncated"):
            netpbm.decode_netpbm(READ[name])


def test_size_limits():
    """A header over Pillow's bomb limit or OpenCV's side limit raises
    before a sample is read."""
    data = b"P5\n100000 100000\n255\n"
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="decompression bomb"):
        netpbm.decode_netpbm(data)
    wide = b"P5\n2000000 1\n255\n"
    with pytest.raises(ValueError, match="OpenCV"):
        netpbm.decode_netpbm_cv2(wide)


def _sources(h: int, w: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(h + w)
    return {"grey": rng.integers(0, 256, (h, w)).astype(np.uint8),
            "rgb": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            "rgba": rng.integers(0, 256, (h, w, 4)).astype(np.uint8),
            "depth": rng.integers(0, 65536, (h, w)).astype(np.uint16)}


@pytest.mark.parametrize("ext", [".ppm", ".pgm", ".pbm", ".pnm", ".pfm"])
@pytest.mark.parametrize("size", [(1, 1), (31, 45), (480, 640)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_matches_pillow(ext, size):
    for kind, a in _sources(*size).items():
        assert netpbm.encode_netpbm(a) == pillow_save(a, ext), kind


def test_pgm16_reads_back_bitwise(tmp_path):
    depth = _sources(67, 91)["depth"]
    path = _write(tmp_path, netpbm.encode_netpbm(depth), "d.pgm")
    got = image.read_image_cv2(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(got, cv2.imread(path, CV2_FLAGS))
    assert Image.open(path).mode == "I"
    np.testing.assert_array_equal(np.asarray(Image.open(path)), depth)
    np.testing.assert_array_equal(image.read_image(path), np.asarray(Image.open(path).convert("RGBA")))


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "depth"])
def test_dib_matches_pillow(tmp_path, kind):
    a = _sources(31, 45)[kind]
    if kind == "depth":
        for enc in (bmp.encode_dib, lambda x: pillow_save(x, ".dib")):
            with pytest.raises(OSError, match="I;16"):
                enc(a)
        return
    data = bmp.encode_dib(a)
    assert data == pillow_save(a, ".dib")
    path = _write(tmp_path, data, "x.dib")
    im = Image.open(path)
    assert im.format == "DIB"
    np.testing.assert_array_equal(image.read_image(path), np.asarray(im.convert("RGBA")))
    assert cv2.imread(path, CV2_FLAGS) is None and image.read_image_cv2(path) is None


def test_dib_variants_read_like_pillow(tmp_path):
    """A DIB with a palette and one with BITFIELDS masks after a 40-byte
    header: the pixels start after the masks and the palette."""
    rng = np.random.default_rng(4)
    pal = Image.fromarray(rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)).quantize(16)
    b = io.BytesIO()
    pal.save(b, "DIB")
    w, h = 7, 3
    px = rng.integers(0, 65536, (h, w)).astype("<u2")
    stride = (w * 2 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 2 * w] = px.view(np.uint8).reshape(h, -1)
    masks = struct.pack("<III", 0xF800, 0x7E0, 0x1F)
    dib565 = (struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 3, rows.size, 0, 0, 0, 0) + masks
              + rows[::-1].tobytes())
    for data in (b.getvalue(), dib565):
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(bmp.decode_dib(data), ref)
        np.testing.assert_array_equal(image.decode_image(data), ref)


def test_dispatch_by_signature(tmp_path):
    """``read_image`` and ``read_image_cv2`` send every Netpbm kind to
    this module, whatever the extension; Pillow's test formats raise by
    name."""
    for name in ("P1", "P4", "P2", "P3", "P5 maxval 1000", "P6 maxval 65535", "Pf", "PF", "P7 RGB"):
        path = _write(tmp_path, READ[name], "x.bin")
        ref = cv2.imread(path, CV2_FLAGS)
        np.testing.assert_array_equal(image.read_image_cv2(path), ref)
    with pytest.raises(NotImplementedError, match="PyRGBA"):
        image.decode_image(b"PyRGBA\n1 1\n255\n" + bytes(4))
    assert os.path.exists(path)
