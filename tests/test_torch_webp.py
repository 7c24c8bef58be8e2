"""The port's WebP decoder (``assets/webp.py``, ``csrc/sl_webp.cpp``) against
Pillow 12.1.0 and OpenCV 5.0.0 (both with libwebp 1.6.0) on the same bytes.

Every file is one Pillow wrote (an animation's container is
``torch_image_fixtures.webp_anim`` around frames Pillow wrote). Each
decodes through ``image.decode_image`` bitwise to
``Image.open(f).convert("RGBA")`` and through ``image.read_image_cv2``
bitwise to ``cv2.imread(f, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``: lossy
(every quality and method), lossless (with and without ``exact``), alpha
(pre-processed levels below ``alpha_quality`` 100), palettes of 2 to 256
colours, odd sizes from 1x1, and frame 0 of animations with offsets; and
files libwebp's encoder writes with the options Pillow's ``save`` does not
pass (the simple loop filter, sharpness, token partitions, segments, raw
and unfiltered alpha, near-lossless). A
truncated or corrupt file raises where Pillow raises and reads as None
where OpenCV reads nothing. The committed fixtures decode to the digests
recorded from both libraries.
"""

import hashlib
import os

import numpy as np
import pytest

from stillleben_tpu_torch.assets import image, webp
from stillleben_tpu_torch.assets.image_fixtures import WEBP_FILES, digests, path
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import (
    cv2_bgr_sha, make_webp_fixtures, smooth, webp_anim, webp_digests, webp_save,
)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")
CV2_FLAGS = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pillow_rgba(data: bytes, tmp_path):
    """Pillow's reading, or the name of the exception it raises."""
    p = tmp_path / "pil.webp"
    p.write_bytes(data)
    try:
        with Image.open(p) as im:
            return np.asarray(im.convert("RGBA"))
    except Exception as e:  # noqa: BLE001  (compared by kind)
        return type(e).__name__


def cv2_reading(data: bytes, tmp_path):
    p = tmp_path / "cv.webp"
    p.write_bytes(data)
    return cv2.imread(str(p), CV2_FLAGS)


def assert_readings(data: bytes, tmp_path):
    """Both of the port's readings against Pillow's and OpenCV's."""
    p = tmp_path / "x.webp"
    p.write_bytes(data)
    want = pillow_rgba(data, tmp_path)
    if isinstance(want, str):
        with pytest.raises((ValueError, OSError)):
            image.read_image(str(p))
    else:
        got = image.read_image(str(p))
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), f"{(got != want).any(-1).sum()} pixels differ"
    want_cv = cv2_reading(data, tmp_path)
    got_cv = image.read_image_cv2(str(p))
    if want_cv is None:
        assert got_cv is None
    else:
        assert got_cv is not None and got_cv.dtype == want_cv.dtype
        assert got_cv.shape == want_cv.shape
        assert np.array_equal(got_cv, want_cv), f"{(got_cv != want_cv).any(-1).sum()} pixels"


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WEBP_FILES)
def test_fixture_decodes_to_digests(name, tmp_path):
    """Each committed WebP: the port's two readings equal Pillow's and
    OpenCV's here and the digests recorded from them (which the card's
    host, without either library, checks)."""
    with open(path(name), "rb") as f:
        data = f.read()
    assert sha(webp.decode_webp(data, name)) == digests.WEBP_DECODE[name]
    assert sha(webp.decode_webp_cv2(data, name)) == digests.WEBP_DECODE_CV2[name]
    assert_readings(data, tmp_path)


def test_webp_fixtures_are_pillows():
    """The committed WebP files and their digests are what
    ``torch_image_fixtures.py`` regenerates with Pillow and OpenCV here."""
    files = make_webp_fixtures()
    assert tuple(sorted(files)) == tuple(sorted(WEBP_FILES))
    for name, data in files.items():
        with open(path(name), "rb") as f:
            assert f.read() == data, name
    d = webp_digests(files)
    assert d == {"WEBP_DECODE": digests.WEBP_DECODE, "WEBP_DECODE_CV2": digests.WEBP_DECODE_CV2}
    assert cv2_bgr_sha(files["q80.webp"]) == digests.WEBP_DECODE_CV2["q80.webp"]


def test_fixture_kinds():
    """The fixtures hold what they are named for: VP8 / VP8X+ALPH / VP8L,
    16 colours, odd sizes, an animation whose frame 0 sits inside a larger
    canvas."""
    from stillleben_tpu_torch.assets import native_image

    info = {}
    for name in WEBP_FILES:
        with open(path(name), "rb") as f:
            data = f.read()
        info[name] = (data[12:16], native_image.webp_info(data, name))
    assert info["q80.webp"][0] == b"VP8 " and not info["q80.webp"][1]["alpha"]
    assert info["alpha.webp"][0] == b"VP8X" and info["alpha.webp"][1]["alpha"]
    assert info["lossless.webp"][1]["lossless"] and info["lossless.webp"][1]["alpha"]
    assert info["palette16.webp"][1]["lossless"]
    odd = info["odd.webp"][1]
    assert odd["width"] % 2 == 1 and odd["height"] % 2 == 1
    anim = info["anim.webp"][1]
    assert anim["frames"] == 2 and (anim["x"], anim["y"]) == (6, 8)
    assert anim["frame_width"] < anim["width"] and anim["frame_height"] < anim["height"]
    assert (info["frame.webp"][1]["width"], info["frame.webp"][1]["height"]) == (640, 480)


# ---------------------------------------------------------------------------
# the seeded sweep: 40 files Pillow writes here
# ---------------------------------------------------------------------------


def _sweep_cases():
    rng = np.random.default_rng(2026)
    cases = [("1x1 lossy", dict(h=1, w=1, c=3, opts=dict(quality=80))),
             ("1x1 lossless", dict(h=1, w=1, c=4, opts=dict(lossless=True))),
             ("97x61 lossy", dict(h=61, w=97, c=3, opts=dict(quality=90, method=6))),
             ("2x3 alpha", dict(h=3, w=2, c=4, opts=dict(quality=30, alpha_quality=40)))]
    for q in (0, 25, 50, 75):
        for m in (0, 3, 6):
            h, w = (int(v) for v in rng.integers(1, 62, 2))
            cases.append((f"q{q} m{m} {h}x{w}",
                          dict(h=h, w=w, c=3, opts=dict(quality=q, method=m))))
    for exact in (False, True):
        for m in (0, 4):
            h, w = (int(v) for v in rng.integers(5, 62, 2))
            cases.append((f"lossless exact={exact} m{m} {h}x{w}",
                          dict(h=h, w=w, c=4, transparent=True,
                               opts=dict(lossless=True, exact=exact, method=m))))
    for aq in (0, 20, 50, 90):
        h, w = (int(v) for v in rng.integers(3, 62, 2))
        cases.append((f"alpha_quality {aq} {h}x{w}",
                      dict(h=h, w=w, c=4, opts=dict(quality=70, alpha_quality=aq,
                                                    method=int(rng.integers(0, 7))))))
    for n in (2, 4, 16, 256):
        for c in (3, 4):
            h, w = (int(v) for v in rng.integers(3, 62, 2))
            cases.append((f"palette {n} c{c} {h}x{w}",
                          dict(h=h, w=w, c=c, colours=n, opts=dict(lossless=True))))
    for k in range(4):
        cases.append((f"animation {k}", dict(anim=k)))
    for m in (0, 3, 6):  # drawn last, so the sizes above stay as they were
        h, w = (int(v) for v in rng.integers(1, 62, 2))
        cases.append((f"q100 m{m} {h}x{w}", dict(h=h, w=w, c=3, opts=dict(quality=100, method=m))))
    return cases


SWEEP = _sweep_cases()


def _sweep_file(case: dict, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if "anim" in case:
        k = case["anim"]
        cw, ch = 30 + 6 * k, 24 + 4 * k
        fw, fh = int(rng.integers(3, cw - 6)), int(rng.integers(3, ch - 6))
        x, y = 2 * int(rng.integers(0, (cw - fw) // 2 + 1)), 2 * int(rng.integers(0, (ch - fh) // 2 + 1))
        first = smooth(fh, fw, 4 if k % 2 else 3, seed)
        f0 = webp_save(first, lossless=True) if k >= 2 else webp_save(first, quality=60)
        f1 = webp_save(smooth(ch, cw, 3, seed + 1), quality=60)
        return webp_anim((cw, ch), [(x, y, f0), (0, 0, f1)], alpha=k != 1,
                         background=int(rng.integers(0, 2**32)))
    h, w, c = case["h"], case["w"], case["c"]
    if "colours" in case:
        pal = rng.integers(0, 256, (case["colours"], c)).astype(np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        idx = np.where(rng.random((h, w)) < 0.3, rng.integers(0, len(pal), (h, w)),
                       (xx // 3 + yy // 2) % len(pal))
        pix = pal[idx]
    else:
        pix = smooth(h, w, c, seed)
        if case.get("transparent"):
            pix[..., 3] = np.where(rng.random((h, w)) < 0.4, 0, pix[..., 3])
    return webp_save(pix, **case["opts"])


@pytest.mark.parametrize("case", range(len(SWEEP)), ids=[name for name, _ in SWEEP])
def test_seeded_sweep(case, tmp_path):
    """Pillow's encode of a seeded image, read as Pillow and OpenCV read it."""
    _, spec = SWEEP[case]
    assert_readings(_sweep_file(spec, 100 + case), tmp_path)


# ---------------------------------------------------------------------------
# libwebp's options that Pillow's save does not pass
# ---------------------------------------------------------------------------

ENCODER_OPTIONS = [
    ("simple filter", 3, dict(filter_type=0)),
    ("simple filter, sharpness 5", 3, dict(filter_type=0, filter_sharpness=5)),
    ("simple filter, strength 100", 3, dict(filter_type=0, filter_strength=100)),
    ("normal filter, sharpness 7, strength 100", 3, dict(filter_sharpness=7, filter_strength=100)),
    ("no filter", 3, dict(filter_strength=0)),
    ("2 token partitions", 3, dict(partitions=1)),
    ("8 token partitions", 3, dict(partitions=3, method=6)),
    ("1 segment", 3, dict(segments=1)),
    ("2 segments, sns 100, 4 partitions", 3, dict(segments=2, sns_strength=100, partitions=2)),
    ("raw alpha", 4, dict(alpha_compression=0)),
    ("alpha unfiltered", 4, dict(alpha_filtering=0)),
    ("alpha best filter", 4, dict(alpha_filtering=2)),
    ("alpha quality 30, preprocessing", 4, dict(alpha_quality=30, preprocessing=1)),
    ("lossless near_lossless 60", 4, dict(lossless=1, near_lossless=60)),
    ("lossless method 6, exact", 4, dict(lossless=1, method=6, exact=1)),
]


@pytest.mark.parametrize("case", range(len(ENCODER_OPTIONS)),
                         ids=[name for name, _, _ in ENCODER_OPTIONS])
def test_libwebp_encoder_options(case, tmp_path):
    """Files libwebp writes with options Pillow's ``save`` never passes, at
    three sizes each (odd ones and more than one macroblock row)."""
    from torch_image_fixtures import libwebp_encode

    _, c, opts = ENCODER_OPTIONS[case]
    for k, (h, w) in enumerate(((61, 97), (33, 20), (130, 71))):
        pix = smooth(h, w, c, 40 + 3 * case + k)
        assert_readings(libwebp_encode(pix, quality=15.0 + 6 * case, **opts), tmp_path)


# ---------------------------------------------------------------------------
# truncated and corrupt files
# ---------------------------------------------------------------------------


def _damaged():
    rgba = smooth(40, 50, 4, 9)
    files = {"vp8x": webp_save(rgba, quality=60), "vp8l": webp_save(rgba, lossless=True),
             "vp8": webp_save(rgba[..., :3], quality=60)}
    out = []
    for kind, data in files.items():
        n = len(data)
        for cut in (10, 16, 20, 31, 32, 40, n // 2, n - 9, n - 1):
            out.append((f"{kind} cut at {cut}", data[:cut]))
        out.append((f"{kind} + 7 zero bytes", data + bytes(7)))
        out.append((f"{kind} + junk", data + b"JUNKJUNKJUNK"))
        for pos in (13, 30, 40, n // 2, n - 3):
            b = bytearray(data)
            b[pos] ^= 0x5A
            out.append((f"{kind} byte {pos} flipped", bytes(b)))
        for riff in (n, n - 20):
            b = bytearray(data)
            b[4:8] = riff.to_bytes(4, "little")
            out.append((f"{kind} RIFF size {riff}", bytes(b)))
    return out


DAMAGED = _damaged()


@pytest.mark.parametrize("case", range(len(DAMAGED)), ids=[name for name, _ in DAMAGED])
def test_damaged_file(case, tmp_path):
    """A truncated or corrupt file raises where Pillow raises and is None
    where OpenCV reads nothing; where either still reads an image, so does
    the port, bitwise."""
    assert_readings(DAMAGED[case][1], tmp_path)


def test_canvas_over_the_limits_raises_before_decoding(tmp_path):
    """A VP8X canvas too large for the file's frame: Pillow's reading raises
    before a pixel is decoded (Pillow's decoder is refused first), as the
    port's does. OpenCV's reading raises where ``cv2.imread`` raises, for a
    canvas over OpenCV's limits (2^20 a side, 2^30 pixels), and is None
    where ``imread`` reads no image, for one under them."""
    with open(path("alpha.webp"), "rb") as f:
        alpha = f.read()

    def canvas(width, height):
        data = bytearray(alpha)
        data[24:27] = (width - 1).to_bytes(3, "little")
        data[27:30] = (height - 1).to_bytes(3, "little")
        return bytes(data)

    for width, height in ((20000, 20000), (2 ** 20 + 1, 100), (100, 2 ** 24), (40000, 40000)):
        data = canvas(width, height)
        assert isinstance(pillow_rgba(data, tmp_path), str)
        with pytest.raises((ValueError, OSError), match="WebP"):
            webp.decode_webp(data)
        if width * height <= 2 ** 30 and max(width, height) <= 2 ** 20:
            assert cv2_reading(data, tmp_path) is None
            assert webp.decode_webp_cv2(data) is None
        else:
            with pytest.raises(cv2.error, match="validateInputImageSize"):
                cv2_reading(data, tmp_path)
            with pytest.raises(ValueError, match="OpenCV's limits"):
                webp.decode_webp_cv2(data)


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def test_readers_load_webp(tmp_path):
    """``read_image``, ``Texture2D`` and ``ImageLoader`` load ``.webp`` (none
    counts as a failed load); a ``.webp`` that ``ImageSaver`` writes reads
    back through ``Texture2D`` and ``ImageLoader``."""
    from stillleben_tpu_torch.assets.image_loader import ImageLoader
    from stillleben_tpu_torch.assets.image_saver import ImageSaver
    from stillleben_tpu_torch.assets.texture import Texture2D

    names = ("q80.webp", "alpha.webp", "lossless.webp")
    for name in names:
        with open(path(name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    tex = Texture2D(str(tmp_path / "alpha.webp"))
    assert sha(tex.pixels) == digests.WEBP_DECODE["alpha.webp"]
    loader = ImageLoader(str(tmp_path), seed=0, num_threads=2)
    try:
        got = {sha(loader.next_texture().pixels) for _ in range(6)}
    finally:
        loader.close()
    assert got <= {digests.WEBP_DECODE[n] for n in names} and len(got) >= 2
    saved = tmp_path / "saved"
    saved.mkdir()
    rgba = np.concatenate([smooth(40, 52, 3, 11), smooth(40, 52, 1, 12)], -1)
    with ImageSaver(num_threads=1) as saver:
        saver.save(rgba, str(saved / "out.webp"))
    data = (saved / "out.webp").read_bytes()
    want = np.asarray(Image.open(saved / "out.webp").convert("RGBA"))
    np.testing.assert_array_equal(want[..., 3], rgba[..., 3])
    assert sha(Texture2D(str(saved / "out.webp")).pixels) == sha(want)
    assert sha(image.decode_image(data)) == sha(want)
    loader = ImageLoader(str(saved), seed=0, num_threads=1)
    try:
        assert sha(loader.next_texture().pixels) == sha(want)
    finally:
        loader.close()
