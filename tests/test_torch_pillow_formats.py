"""Pillow's rarer readers in the port's codec (``assets/blp.py``,
``ftex.py``, ``sun.py``, ``xbm.py``, ``xpm.py``, ``msp.py``, ``gbr.py``,
``fits.py``, ``fli.py``, ``spider.py``, ``mcidas.py``, ``pixar.py``,
``imt.py``, ``xvthumb.py``, ``pcd.py``, ``iptc.py``, over the native loops
of ``csrc/sl_pillow_formats.cpp``) against Pillow 12.1.0 and OpenCV 5.0.0
on the same bytes.

- The committed fixtures hold their digests, the writer-made ones come out
  of ``image_fixtures.rare_formats`` byte-equal, and each reads as
  ``Image.open(p).convert("RGBA")`` reads it (or raises as it raises), the
  Sun rasters also as ``cv2.imread`` reads them; the seeded PhotoCD files
  likewise.
- A seeded sweep of each writer's options and sizes
  (``torch_image_fixtures.pillow_formats_sweep_case``), and damaged files:
  cut short and with bytes changed, raising Pillow's exception types and
  ``OSError`` messages.
- Pillow's order: files that pass a weak test (GBR's) or none (SPIDER,
  PCD, IPTC) but are another format's, a TGA, and the refusals (the BUFR,
  GRIB and HDF5 stubs, MPEG, WMF, EPS without Ghostscript, a Radiance
  ``.hdr``, which Pillow does not read).
"""

import hashlib
import struct

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import image
from stillleben_tpu_torch.assets.image_fixtures import (PILLOW_FORMAT_FILES,
                                                        PILLOW_FORMAT_REFUSALS,
                                                        PILLOW_FORMAT_WRITTEN, digests)
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_fixtures import rare_formats as rf
from torch_image_fixtures import PILLOW_SWEEP_FORMATS, pillow_formats_sweep_case

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def read(name: str) -> bytes:
    with open(fixture(name), "rb") as f:
        return f.read()


def outcome(fn, path):
    """The array a reading gives, or (exception type, message of an
    ``OSError``); Pillow's ``UnidentifiedImageError`` and
    ``DecompressionBombError`` are the port's ``OSError`` and ``ValueError``."""
    try:
        return fn(path)
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        kind = {"UnidentifiedImageError": OSError, "DecompressionBombError": ValueError}.get(
            type(e).__name__, type(e))
        for base in (OSError, ValueError, NotImplementedError):
            if isinstance(e, base) and kind is not base and issubclass(kind, base):
                kind = base
        return kind, str(e) if kind is OSError else ""


def pillow(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def assert_reads_as_pillow(data: bytes, tmp_path, name: str = "x.bin", message: bool = True):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    ref, got = outcome(pillow, path), outcome(image.read_image, path)
    if isinstance(ref, tuple) or isinstance(got, tuple):
        assert isinstance(ref, tuple) and isinstance(got, tuple), (name, ref, got)
        assert ref[0] is got[0], (name, ref, got)
        if message:
            assert ref[1] == got[1], (name, ref, got)
        return ref
    assert got.shape == ref.shape and got.dtype == ref.dtype, (name, got.shape, ref.shape)
    diff = (got != ref).any(-1)
    assert not diff.any(), f"{name}: {int(diff.sum())} pixels differ, first at " \
                           f"{np.argwhere(diff)[0].tolist()}"
    return ref


def test_fixture_bytes():
    """The committed files hold their digests; the writer-made ones are
    ``rare_formats.pillow_format_files()``'s bytes, and the seeded PhotoCD
    files hold theirs."""
    written = rf.pillow_format_files()
    assert sorted(written) == sorted(PILLOW_FORMAT_WRITTEN)
    for name in PILLOW_FORMAT_FILES:
        assert sha(read(name)) == digests.PILLOW_FORMAT_FILE[name], name
        if name in written:
            assert written[name] == read(name), name
    pcd = rf.pcd_files()
    assert {n: sha(d) for n, d in pcd.items()} == digests.PCD_FILE


@pytest.mark.parametrize("name", PILLOW_FORMAT_FILES)
def test_fixture_reads_as_pillow(name, tmp_path):
    """Each committed file as Pillow reads it, to the digest of Pillow's
    reading (what the card's host checks), and a refused one by the
    exception Pillow raises."""
    data = read(name)
    ref = assert_reads_as_pillow(data, tmp_path, name)
    if name in PILLOW_FORMAT_REFUSALS:
        assert ref[0] is PILLOW_FORMAT_REFUSALS[name]
        assert digests.PILLOW_FORMAT_DECODE[name].startswith("BLPFormatError")
        return
    assert sha(image.decode_image(data, name).tobytes()) == digests.PILLOW_FORMAT_DECODE[name]


@pytest.mark.parametrize("name", [n for n in PILLOW_FORMAT_FILES if n.endswith(".ras")])
def test_sun_reads_as_opencv(name):
    """Each Sun raster as ``cv2.imread`` reads it: OpenCV's own files,
    palettes (grey ones give one channel), 1 and 32 bits, and None for the
    run-length and type-3 files OpenCV's reader turns away."""
    ref = cv2.imread(fixture(name), CV2_FLAGS)
    got = image.read_image_cv2(fixture(name))
    assert (ref is None) == (got is None), name
    want = digests.PILLOW_FORMAT_DECODE_CV2[name]
    if ref is None:
        assert want == "None"
        return
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert sha(np.ascontiguousarray(got).tobytes()) == want


def test_opencv_reads_run_length_and_type_3_as_none(tmp_path):
    """OpenCV 5's Sun reader accepts types 0 and 1 only, and reads grey
    without a palette as zeros."""
    rng = np.random.default_rng(3)
    grey = rng.integers(1, 256, (5, 7)).astype(np.uint8)
    cases = {"rle.ras": rf.sun_raster(grey, 8, rle=True),
             "type3.ras": rf.sun_raster(np.stack([grey] * 3, -1), 24, ftype=3),
             "old.ras": rf.sun_raster(grey, 8, ftype=0)}
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        ref, got = cv2.imread(str(p), CV2_FLAGS), image.read_image_cv2(str(p))
        if name == "old.ras":
            assert ref is not None and not ref.any()
            np.testing.assert_array_equal(got, ref)
        else:
            assert ref is None and got is None


@pytest.mark.parametrize("name", sorted(rf.PCD_SEEDS))
def test_pcd_reads_as_pillow(name, tmp_path):
    """PhotoCD from seeds (smooth and uniform PhotoYCC noise, every
    orientation Pillow turns): Pillow's fixed-point tables, bitwise."""
    data = rf.pcd_files()[name]
    assert_reads_as_pillow(data, tmp_path, name)
    assert sha(image.decode_image(data, name).tobytes()) == digests.PCD_DECODE[name]


def test_pcd_tables_cover_every_value(tmp_path):
    """Every PhotoYCC triple's luma and chroma value once: the 256-entry
    tables and the clipping, against Pillow's raw ``YCC;P`` unpacker."""
    from stillleben_tpu_torch.assets import pcd

    y, c1, c2 = (v.reshape(-1) for v in np.meshgrid(np.arange(256), np.arange(256),
                                                     np.arange(0, 256, 3), indexing="ij"))
    ycc = np.stack([y, c1, c2], -1).astype(np.uint8)
    ref = np.asarray(Image.frombytes("RGB", (len(ycc), 1), ycc.tobytes(), "raw", "YCC;P"))[0]
    np.testing.assert_array_equal(pcd.ycc_to_rgb(y, c1, c2), ref)


SWEEP = 17 * 30


@pytest.mark.parametrize("group", range(30))
def test_sweep_reads_as_pillow(group, tmp_path):
    """Seeded files of every writer, its options drawn from the seed, at
    1x1, 3x5, 33x33 and 65x130 (each way up): 17 formats a group."""
    for i in range(group * len(PILLOW_SWEEP_FORMATS), (group + 1) * len(PILLOW_SWEEP_FORMATS)):
        name, data = pillow_formats_sweep_case(i)
        # IPTC's embedded image is opened by the other readers: its type only
        assert_reads_as_pillow(data, tmp_path, name, message=not name.endswith(".iim"))
        if name.endswith(".ras"):
            p = str(tmp_path / name)
            ref, got = cv2.imread(p, CV2_FLAGS), image.read_image_cv2(p)
            assert (ref is None) == (got is None)
            if ref is not None:
                np.testing.assert_array_equal(got, ref)


def damaged(data: bytes, rng, n: int) -> list[bytes]:
    """Cut short at seeded points, seeded bytes changed, bytes appended."""
    out = []
    for k in range(n):
        d = bytearray(data)
        if k % 3 == 0:
            d = d[: int(rng.integers(0, len(d)))]
        elif k % 3 == 1:
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
        else:
            d += rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("fmt", PILLOW_SWEEP_FORMATS)
def test_damaged_files_raise_as_pillow(fmt, tmp_path):
    """Cut and changed files of each format: the image Pillow reads, or
    Pillow's exception type and ``OSError`` message. IPTC's embedded image is
    opened by the other readers, so only its type is held there."""
    rng = np.random.default_rng(900 + PILLOW_SWEEP_FORMATS.index(fmt))
    i0 = PILLOW_SWEEP_FORMATS.index(fmt)
    for k in range(4):
        name, data = pillow_formats_sweep_case(i0 + k * len(PILLOW_SWEEP_FORMATS))
        for bad in damaged(data, rng, 9):
            assert_reads_as_pillow(bad, tmp_path, name, message=fmt != "iptc")


def test_gbr_test_passes_on_other_formats(tmp_path):
    """GBR's ``_accept`` (a header size of at least 20, version 1 or 2)
    passes on these, but GBR's header does not parse, so Pillow goes on:
    a PhotoCD whose first bytes look like a brush header, and an IM Tools
    file whose first words do."""
    pcd = bytearray(rf.pcd_file(11))
    pcd[:20] = struct.pack(">5I", 20, 1, 0, 5, 1)  # width 0: "not a GIMP brush"
    imt = struct.pack(">II", 0x2A202020, 2) + b"\n" + rf.imt(np.full((3, 4), 9, np.uint8))
    for name, data in (("x.pcd", bytes(pcd)), ("x.imt", imt)):
        assert data[:8] and struct.unpack(">I", data[4:8])[0] in (1, 2)
        ref = assert_reads_as_pillow(data, tmp_path, name)
        assert not isinstance(ref, tuple), name


def test_spider_and_tga(tmp_path):
    """SPIDER has no ``_accept`` and comes before TGA: a TGA is read as
    TGA, and a file whose header passes ``isSpiderHeader`` (in either byte
    order) is SPIDER even under a TGA's name, as Pillow takes it; a
    SPIDER header of another ``iform`` is not."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    tga = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 9, 6, 24, 0x20) + \
        rgb[..., ::-1].tobytes()
    f32 = rng.random((6, 9)).astype(np.float32) * 200
    stack3 = bytearray(rf.spider(f32))
    stack3[16:20] = struct.pack(">f", 3.0)  # iform 3: not a 2-D image
    for name, data in (("a.tga", tga), ("b.tga", rf.spider(f32)), ("c.tga", rf.spider(f32, "<")),
                       ("d.spi", bytes(stack3))):
        assert_reads_as_pillow(data, tmp_path, name)
    assert outcome(image.read_image, str(tmp_path / "a.tga")).shape == (6, 9, 4)


def test_iptc_and_pcd_without_magic(tmp_path):
    """IPTC and PCD have no ``_accept``: a record of raw data, of a band of
    an RGB or CMYK image and of a JPEG, and a PhotoCD, each read as Pillow
    reads it; a record of an unknown compression raises as Pillow does."""
    rng = np.random.default_rng(8)
    grey = rng.integers(0, 256, (7, 11)).astype(np.uint8)
    import io

    b = io.BytesIO()
    Image.fromarray(grey).save(b, "JPEG")
    cases = {"raw.iim": rf.iptc(11, 7, grey.tobytes(), chunk=20),
             "rgb.iim": rf.iptc(11, 7, grey.tobytes(), layers=3, component=1, band=3),
             "cmyk.iim": rf.iptc(11, 7, grey.tobytes(), layers=4, component=1, band=1),
             "jpeg.iim": rf.iptc(11, 7, b.getvalue(), compression=5),
             "unknown.iim": rf.iptc(11, 7, grey.tobytes(), compression=3),
             "turned.pcd": rf.pcd_file(3, orientation=3)}
    for name, data in cases.items():
        ref = assert_reads_as_pillow(data, tmp_path, name)
        assert isinstance(ref, tuple) == (name == "unknown.iim"), name


REFUSED = {
    "sky.hdr": lambda: image.encode_hdr(np.ones((4, 9, 3), np.float32)),
    "x.eps": lambda: __import__("stillleben_tpu_torch.assets.eps", fromlist=["eps"]).encode_eps(
        np.zeros((5, 7, 3), np.uint8)),
    "x.bufr": lambda: b"BUFR" + bytes(60),
    "x.grib": lambda: b"GRIB\x00\x00\x00\x01" + bytes(60),
    "x.h5": lambda: b"\x89HDF\r\n\x1a\n" + bytes(60),
    "x.mpg": lambda: b"\x00\x00\x01\xb3\x14\x00\xf0" + bytes(20),
    "x.wmf": lambda: (b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", 0, 0, 100, 50, 72)
                      + bytes(6) + b"\x01\x00\t\x00" + bytes(30)),
    "x.emf": lambda: (b"\x01\x00\x00\x00" + bytes(4) + struct.pack("<8i", 0, 0, 30, 20, 0, 0, 9, 9)
                      + b" EMF" + bytes(20)),
}
REFUSED_WORDS = {"sky.hdr": "cannot identify image file", "x.eps": "Unable to locate Ghostscript",
                 "x.bufr": "cannot find loader for this BUFR file",
                 "x.grib": "cannot find loader for this GRIB file",
                 "x.h5": "cannot find loader for this HDF5 file", "x.mpg": "cannot load this image",
                 "x.wmf": "cannot find loader for this WMF file",
                 "x.emf": "cannot find loader for this WMF file"}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_raise_pillows_oserror(name, tmp_path):
    """The stubs (BUFR, GRIB, HDF5), MPEG, WMF and EMF open in Pillow and
    fail to load; EPS fails without Ghostscript; a Radiance ``.hdr`` is no
    format of Pillow's (C-25): each raises Pillow's ``OSError`` and message,
    and an ``.hdr`` still reads through OpenCV's path."""
    data = REFUSED[name]()
    ref = assert_reads_as_pillow(data, tmp_path, name)
    assert ref[0] is OSError and REFUSED_WORDS[name] in ref[1]
    if name == "sky.hdr":
        np.testing.assert_array_equal(image.read_image_cv2(str(tmp_path / name)),
                                      cv2.imread(str(tmp_path / name), CV2_FLAGS))
