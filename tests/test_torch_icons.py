"""ICO, CUR and ICNS in the port's codec (``assets/ico.py``,
``assets/icns.py``) against Pillow 12.1.0, OpenCV 5.0.0 and the JAX
package; PSD's readings are in ``test_torch_psd.py``.

- Writing: ``encode_ico`` / ``encode_icns`` are Pillow's ``save`` byte for
  byte in L, RGB, RGBA and I;16, for images under 16 pixels (an ICO with
  no entries), of exactly one icon size, of odd sizes and over 256; the
  saver's digests (``ICON_ENCODE``) from ``icon_sources()``.
- Reading: every committed icon, cursor and PSD fixture to the digests of
  Pillow's reading (the card's host checks the same), and Pillow here;
  ICO entries as DIBs at 1, 4, 8, 24 and 32 bits with AND masks over odd
  widths, entries of one size at several depths, cursors of several
  entries, ICNS run-length planes of every size with and without masks;
  what Pillow refuses refused with its words; a JPEG 2000 ICNS entry
  raises ``NotImplementedError``; OpenCV reads none of the formats.
- The JAX package on the same files: ``Texture``, a GLB whose embedded
  image is an ICO and an OBJ whose MTL names a PSD (their documents and
  scene atlas), ``ImageLoader``, the light map's panorama reader.
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
from stillleben_tpu.assets.gltf import load_gltf as jax_gltf
from stillleben_tpu.assets.image_loader import ImageLoader as JaxImageLoader
from stillleben_tpu.assets.objfile import load_obj as jax_obj
from stillleben_tpu.render import light_map as jlm
from stillleben_tpu.render.atlas import build_scene_atlas as jax_build_scene_atlas
from stillleben_tpu_torch.assets import icns, ico, image
from stillleben_tpu_torch.assets.gltf import load_gltf
from stillleben_tpu_torch.assets.image_fixtures import ICON_FILES, digests, icon_sources
from stillleben_tpu_torch.assets.image_fixtures import path as fixture
from stillleben_tpu_torch.assets.image_loader import ImageLoader
from stillleben_tpu_torch.assets.mesh import Mesh
from stillleben_tpu_torch.assets.objfile import load_obj
from stillleben_tpu_torch.assets.procedural import write_icon_fixtures
from stillleben_tpu_torch.assets.texture import Texture
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.render import light_map as plm
from stillleben_tpu_torch.scene.scene import Object
from test_torch_loaders import assert_same
from torch_image_fixtures import icns_file, icns_rle, icon_dib, icon_file, smooth
from torch_port_scene import to_numpy

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning", "ignore::DeprecationWarning")


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def save(a: np.ndarray, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, fmt, **kw)
    return b.getvalue()


def pillow_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def port_reading(data: bytes, name: str = "x") -> str:
    """``torch_image_fixtures.icon_reading``'s form of the port's reading."""
    try:
        return sha(image.decode_image(data, name).tobytes())
    except OSError as e:
        return "refused: " + next((r for r in tif.ICON_REFUSALS if r in str(e)), str(e))
    except Exception as e:  # noqa: BLE001  (the reading is the exception)
        return f"{type(e).__name__}: {e}"


def source(mode: str, h: int, w: int, seed: int) -> np.ndarray:
    a = smooth(h, w, 4, seed)
    return {"L": a[..., 0], "RGB": np.ascontiguousarray(a[..., :3]), "RGBA": a,
            "I;16": a[..., 0].astype(np.uint16) * 251 + a[..., 1]}[mode]


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ("L", "RGB", "RGBA", "I;16"))
def test_encode_ico_matches_pillow(mode):
    """No entry (15x40), one size exactly (16x16), thumbnails of an odd
    image (37x53: 16, 24, 32), and every size up to 256 from 300x270."""
    for i, (h, w) in enumerate(((40, 15), (16, 16), (37, 53), (270, 300))):
        a = source(mode, h, w, i)
        assert ico.encode_ico(a) == save(a, "ICO"), (h, w)


@pytest.mark.parametrize("mode", ("L", "RGB", "RGBA", "I;16"))
def test_encode_icns_matches_pillow(mode):
    a = source(mode, 23, 41, 7)
    assert icns.encode_icns(a) == save(a, "ICNS")


@pytest.mark.parametrize("name", sorted(icon_sources()))
def test_saver_digests(name):
    """The digests the card's host holds the port's encodes to."""
    a = icon_sources()[name]
    enc = ico.encode_ico if name.endswith(".ico") else icns.encode_icns
    assert sha(enc(a)) == digests.ICON_ENCODE[name]


def test_ico_entries_are_the_thumbnails():
    """Each PNG entry of the saver's ICO is the LANCZOS thumbnail into its
    size, as Pillow's reading of the entry gives it."""
    a = source("RGBA", 61, 83, 8)
    data = ico.encode_ico(a)
    for e in ico.entries(data):
        im = Image.open(io.BytesIO(data[e.offset:]))
        want = Image.fromarray(a)
        want.thumbnail((e.width, e.height), Image.Resampling.LANCZOS, reducing_gap=None)
        np.testing.assert_array_equal(np.asarray(im), np.asarray(want))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def test_fixtures_regenerate():
    """``make_icon_fixtures`` writes the committed files again."""
    files = tif.make_icon_fixtures()
    assert sorted(files) == sorted(ICON_FILES)
    for name, data in files.items():
        with open(fixture(name), "rb") as f:
            assert f.read() == data, name


@pytest.mark.parametrize("name", ICON_FILES)
def test_fixture_digests(name):
    """The port reads each committed file to the digest of Pillow's
    reading, and so does Pillow here; OpenCV reads none of them."""
    with open(fixture(name), "rb") as f:
        data = f.read()
    assert sha(data) == digests.ICON_FILE[name]
    want = digests.ICON_DECODE[name]
    assert tif.icon_reading(data) == want
    assert port_reading(data, name) == want
    assert image.read_image_cv2(fixture(name)) is None
    assert cv2.imread(fixture(name), CV2_FLAGS) is None


@pytest.mark.parametrize("bits", (1, 4, 8, 24, 32))
def test_ico_dib_entries(bits):
    """A DIB entry at each depth over widths that end inside a byte, a
    word and a mask row, with seeded AND masks, as ICO and as CUR."""
    rng = np.random.default_rng(bits)
    for w in (1, 7, 31, 33, 45):
        h = 5 + w % 7
        mask = (rng.random((h, w)) < 0.4).astype(np.uint8)
        if bits <= 8:
            n = 1 << bits
            pix, pal = rng.integers(0, n, (h, w)).astype(np.uint8), rng.integers(0, 256, (n, 3))
            entry = (w, h, bits, icon_dib(pix, bits, mask, pal.astype(np.uint8)), n % 256)
        else:
            pix = rng.integers(0, 256, (h, w, bits // 8)).astype(np.uint8)
            entry = (w, h, bits, icon_dib(pix, bits, mask))
        for cur in (False, True):
            data = icon_file([entry], cur=cur)
            np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data),
                                          err_msg=f"{w} {cur}")


def test_ico_picks_pillows_entry():
    """The largest entry, and of one size the shallowest (Pillow's stable
    sorts), whatever the directory's order; a cursor's largest."""
    rng = np.random.default_rng(9)
    pix = rng.integers(0, 256, (24, 24, 4)).astype(np.uint8)
    ents = [(24, 24, 32, icon_dib(pix, 32)), (24, 24, 24, icon_dib(pix[..., :3], 24)),
            (16, 16, 32, icon_dib(pix[:16, :16], 32)),
            (24, 24, 8, icon_dib(pix[..., 0], 8, None, rng.integers(0, 256, (256, 3)).astype(
                np.uint8))),
            (24, 24, 0, icon_dib(pix[..., :3], 24), 0)]
    for order in ([0, 1, 2, 3, 4], [2, 4, 3, 1, 0], [1, 0, 2], [2, 0], [4, 2]):
        for cur in (False, True):
            data = icon_file([ents[i] for i in order], cur=cur)
            np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data),
                                          err_msg=f"{order} {cur}")


def test_ico_png_entries():
    """PNG entries: grey, palette with ``tRNS`` (which Pillow drops), 16-bit
    grey, RGBA; the image's own size where the directory says another."""
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 16, (20, 27, 1)).astype(np.uint8)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    pngs = [image.encode_png_samples(idx, 3, 8, palette=pal, trns=bytes(range(0, 256, 16))),
            image.encode_png_samples(idx * 16, 0, 8, trns=b"\0\x20"),
            image.encode_png(source("I;16", 20, 27, 11)), image.encode_png(source("RGBA", 20, 27, 12))]
    for body in pngs:
        for dims in ((27, 20), (32, 32)):
            data = icon_file([(*dims, 32, body)])
            np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))


@pytest.mark.parametrize("size", (16, 32, 48, 128))
def test_icns_planes(size):
    """Run-length planes of each size (``it32`` after its four zero bytes),
    with and without their mask, and as raw RGB."""
    kind, mask = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"), 48: (b"ih32", b"h8mk"),
                  128: (b"it32", b"t8mk")}[size]
    p = smooth(size, size, 4, size)
    p[size // 4: size // 2, 3: size - 2] = (9, 200, 9, 128)
    pre = bytes(4) if kind == b"it32" else b""
    rle = pre + b"".join(icns_rle(p[..., c]) for c in range(3))
    for blocks in ([(kind, rle), (mask, p[..., 3].tobytes())], [(kind, rle)],
                   [(mask, p[..., 3].tobytes()), (kind, pre + p[..., :3].tobytes())]):
        data = icns_file(blocks)
        np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))


def test_icns_png_entries():
    """PNG entries of each kind: palette, grey and truecolour with ``tRNS``
    (which Pillow drops), 16-bit grey, grey + alpha."""
    rng = np.random.default_rng(16)
    idx = rng.integers(0, 16, (32, 32, 1)).astype(np.uint8)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    pngs = [image.encode_png_samples(idx, 3, 8, palette=pal, trns=bytes(range(0, 256, 16))),
            image.encode_png_samples(idx * 16, 0, 8, trns=b"\0\x20"),
            image.encode_png_samples(np.repeat(idx * 16, 3, -1), 2, 8, trns=b"\0\x20" * 3),
            image.encode_png(source("I;16", 32, 32, 17)),
            image.encode_png_samples(np.concatenate([idx * 16, idx * 9], -1), 4, 8)]
    for body in pngs:
        data = icns_file([(b"ic11", body)])
        np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))


def test_icns_pillow_files_and_refusals():
    """Pillow's own ICNS (the 1024^2 PNG entry is read), a PNG entry over
    run-length planes of its size, and the refusals: JPEG 2000 by name,
    an unknown entry with Pillow's ``ValueError``, damaged run-length data
    with Pillow's ``SyntaxError``, a file of no icon with ``OSError``."""
    data = save(source("RGBA", 19, 25, 13), "ICNS")
    np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))
    p = smooth(128, 128, 3, 14)
    data = icns_file([(b"it32", bytes(4) + b"".join(icns_rle(p[..., c]) for c in range(3))),
                      (b"ic07", image.encode_png(p[::-1].copy()))])
    np.testing.assert_array_equal(image.decode_image(data), pillow_rgba(data))
    with pytest.raises(NotImplementedError, match="JPEG 2000"):
        image.decode_image(icns_file([(b"ic09", b"\xff\x4f\xff\x51" + bytes(40))]))
    with pytest.raises(ValueError, match="Unsupported icon subimage format"):
        image.decode_image(icns_file([(b"ic09", b"JUNK" * 4)]))
    bad = icns_file([(b"is32", b"\xff\x01" * 3)])  # 130 bytes a plane for 256
    with pytest.raises(SyntaxError) as ref:
        pillow_rgba(bad)
    with pytest.raises(SyntaxError) as ours:
        image.decode_image(bad)
    assert str(ours.value) == str(ref.value)
    for data in (icns_file([(b"TOC ", bytes(8))]), b"\0\0\1\0\0\0", b"\0\0\2\0\0\0"):
        with pytest.raises(OSError, match="cannot identify image file"):
            pillow_rgba(data)
        with pytest.raises(OSError, match="cannot identify image file"):
            image.decode_image(data)


def test_truecolour_tga_is_no_cursor(tmp_path):
    """An uncompressed truecolour TGA starts with the cursor's magic; with
    its colour-map origin (the cursor's count) 0 Pillow's cursor reader
    gives up and the TGA reader takes it, and so does the port's."""
    a = smooth(9, 14, 3, 15)
    for mode, arr in (("RGB", a), ("RGBA", np.concatenate([a, a[..., :1]], -1))):
        data = save(arr, "TGA")
        assert data[:4] == ico.CUR_MAGIC and not ico.is_cur(data)
        path = tmp_path / f"x_{mode}.tga"
        path.write_bytes(data)
        np.testing.assert_array_equal(image.read_image(str(path)), pillow_rgba(data))
        assert image.read_image_cv2(str(path)) is None


# ---------------------------------------------------------------------------
# the JAX package on the same files
# ---------------------------------------------------------------------------

READ = ("pillow_rgba.ico", "pillow_bmp_rgb.ico", "pillow_depth16.ico", "dib1.ico", "dib4.ico",
        "png_trns.ico", "cursor.cur", "cursors.cur", "rle.icns", "png.icns", "png_grey.icns",
        "bitmap.psd", "indexed_rle.psd", "rgba.psd", "cmyk5_rle.psd", "grey_rle.psd",
        "truncated.psd", "unknown.icns")


def _or_error(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001  (compared with the other package's)
        return e


def _same_or_same_error(got, ref):
    if isinstance(ref, Exception):
        assert isinstance(got, type(ref)) and not isinstance(got, NotImplementedError), (got, ref)
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", READ)
def test_texture_matches_jax(name):
    """``Texture(path)``: the same pixels, or the same exception type."""
    got, ref = (_or_error(lambda p, T=T: T(p).pixels, fixture(name)) for T in (Texture, jsl.Texture))
    _same_or_same_error(got, ref)


@pytest.mark.parametrize("name", READ)
def test_panorama_reader_matches_jax(name):
    """The light map's panorama reader: OpenCV reads none of these, so both
    packages take the Pillow fallback, ``convert("RGB") / 255`` to the 2.2."""
    got, ref = (_or_error(m._load_hdr_image, fixture(name)) for m in (plm, jlm))
    _same_or_same_error(got, ref)


def test_image_loader_matches_jax(tmp_path):
    """A folder of icons, cursors and PSDs under names the loaders take
    (both read a file by its bytes): one thread, one seed, the same
    textures in the same order."""
    names = ("pillow_rgba.ico", "dib8.ico", "cursors.cur", "rle.icns", "raw.icns", "rgb_rle.psd",
             "cmyk.psd", "indexed.psd")
    for i, name in enumerate(names):
        shutil.copyfile(fixture(name), tmp_path / f"{i}_{name.replace('.', '_')}.png")
    port = ImageLoader(str(tmp_path), seed=6, num_threads=1)
    ref = JaxImageLoader(str(tmp_path), seed=6, num_threads=1)
    try:
        for _ in range(16):
            np.testing.assert_array_equal(port.next_texture().pixels, ref.next_texture().pixels)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    return write_icon_fixtures(str(tmp_path_factory.mktemp("icons")), subdiv=2)


@pytest.mark.parametrize("name", ["obj_psd", "glb_ico"])
def test_document_matches_jax(scene_files, name):
    path = scene_files[name]
    port, ref = (load_obj(path), jax_obj(path)) if name.startswith("obj") else (
        load_gltf(path), jax_gltf(path))
    assert_same(port, ref)
    twin = scene_files[name.split("_")[0] + "_png"]
    twin_doc = load_obj(twin) if name.startswith("obj") else load_gltf(twin)
    np.testing.assert_array_equal(port.images[0], twin_doc.images[0])


def test_atlas_matches_jax(scene_files):
    """The scene atlas of the PSD-textured blob and the ICO-textured GLB
    (the textures' only way into a frame) is the JAX package's, bitwise;
    the ICNS plane texture and the PSD panorama are its PNG twins'."""
    meshes = [scene_files["obj_psd"], scene_files["glb_ico"]]
    port = [Object(Mesh(p, physics=False)) for p in meshes]
    ref = [jsl.Object(jsl.Mesh(p, physics=False)) for p in meshes]
    pa = patlas.build_scene_atlas(port, "cpu")
    ja = to_numpy(jax_build_scene_atlas(ref))
    for field in pa._fields:
        got, want = getattr(pa, field), getattr(ja, field)
        if field == "num_objects":
            assert got == int(want) == 2
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert (pa.mat_base_tex >= 0).sum() == 2
    np.testing.assert_array_equal(Texture(scene_files["plane_icns"]).pixels,
                                  jsl.Texture(scene_files["plane_icns"]).pixels)
    np.testing.assert_array_equal(Texture(scene_files["plane_icns"]).pixels,
                                  Texture(scene_files["plane_png"]).pixels)
    d = os.path.dirname(scene_files["ibl_psd"])
    sky = plm._load_hdr_image(os.path.join(d, "sky_packbits.psd"))
    np.testing.assert_array_equal(sky, jlm._load_hdr_image(os.path.join(d, "sky_packbits.psd")))
    np.testing.assert_array_equal(sky, plm._load_hdr_image(os.path.join(d, "sky_packbits.png")))
