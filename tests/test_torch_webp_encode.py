"""The port's WebP encoder (``assets/webp.py::encode_webp``,
``csrc/sl_webp_enc.cpp``) against Pillow 12.1.0's ``save`` (libwebp 1.6.0
at quality 80, method 4) on the same arrays.

Stage by stage: the YUV 4:2:0 planes equal ``WebPPictureImportRGB(A)``'s
and, after the transparent area's clean-up, ``WebPCleanupTransparentArea``'s
(libwebp through ctypes); the files equal Pillow's byte for byte for grey
(L), RGB, opaque RGBA and 16-bit grey (I;16) arrays of every size and
content of the matrix; for RGBA with transparency the VP8X and VP8 chunks
and the ALPH header byte are Pillow's, the alpha decodes exactly, and the
ALPH payload is at most 1.25x libwebp's (or libwebp's + 16 bytes). Every
file reads the same in Pillow, OpenCV and the port's decoders. Where a
lossy file parts from libwebp's, ``vp8_divergence`` names the first stage.
The committed q80 fixtures come out of their sources again, and the port's
``ImageSaver`` writes what the JAX package's writes.
"""

import io
import os

import numpy as np
import pytest

from stillleben_tpu_torch.assets import native_image, webp
from stillleben_tpu_torch.assets.image_fixtures import path
from stillleben_tpu_torch.assets.image_saver import ImageSaver
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import (
    libwebp_encode, libwebp_planes, smooth, vp8_divergence, vp8_partition0, webp_anim,
    webp_chunks, webp_frame, webp_save,
)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

SIZES = [(1, 1), (2, 3), (15, 17), (16, 16), (17, 33), (1, 300), (300, 1), (1, 16383), (67, 91),
         (256, 256)]
CONTENTS = ("flat", "smooth", "noise", "checker", "frame")
CASES = [(s, c) for s in SIZES for c in CONTENTS] + [((480, 640), "frame")]
ALPHAS = ("ramp", "mask", "transparent")


def content(kind: str, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 of each kind: flat, a smooth seeded field, seeded
    noise (large coefficients: VP8's largest level category), a coloured
    checker, and the 640x480 WebP frame tiled."""
    if kind == "flat":
        return np.full((h, w, 3), (97, 151, 212), np.uint8)
    if kind == "smooth":
        return smooth(h, w, 3, h * 31 + w)
    if kind == "noise":
        return np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "checker":
        yy, xx = np.mgrid[0:h, 0:w]
        on = ((yy // 8 + xx // 8) % 2).astype(bool)[..., None]
        return np.where(on, np.uint8([230, 40, 20]), np.uint8([10, 60, 200])).astype(np.uint8)
    frame = webp_frame()
    return np.tile(frame, (-(-h // 480), -(-w // 640), 1))[:h, :w]


def alpha(kind: str, h: int, w: int) -> np.ndarray:
    """(h, w) uint8 with some transparency: a smooth seeded ramp, a binary
    disc, or all 0."""
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "ramp":
        a = smooth(h, w, 1, 5 + h + w)[..., 0]
    elif kind == "mask":
        disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 2.5) ** 2 + 1
        a = disc.astype(np.uint8) * 255
    else:
        a = np.zeros((h, w), np.uint8)
    if (a == 255).all():
        a[-1, -1] = 0
    return a


def pillow_save(a: np.ndarray) -> bytes:
    """What the JAX ``ImageSaver`` writes: ``Image.fromarray`` in its mode."""
    b = io.BytesIO()
    Image.fromarray(a).save(b, "WEBP")
    return b.getvalue()


def readings(data: bytes):
    """Pillow's RGBA, OpenCV's BGR, and the port's two readings of a file."""
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
    return pil, cv, webp.decode_webp(data), webp.decode_webp_cv2(data)


def assert_readers_agree(data: bytes):
    pil, cv, port, port_cv = readings(data)
    np.testing.assert_array_equal(port, pil)
    np.testing.assert_array_equal(port_cv, cv)
    return pil


def alph_bound(ref_size: int) -> int:
    return max(int(1.25 * ref_size), ref_size + 16)


def check_alpha_file(ours: bytes, ref: bytes, a: np.ndarray) -> None:
    """The port's file of an RGBA array with transparency against Pillow's:
    VP8X and VP8 chunks equal, the ALPH header byte equal, its payload
    within the bound, the alpha exact, the readers agreeing."""
    co, cr = dict(webp_chunks(ours)), dict(webp_chunks(ref))
    assert list(co) == list(cr) == [b"VP8X", b"ALPH", b"VP8 "]
    assert co[b"VP8X"] == cr[b"VP8X"]
    assert co[b"VP8 "] == cr[b"VP8 "], vp8_divergence(ours, ref)
    assert co[b"ALPH"][0] == cr[b"ALPH"][0], (co[b"ALPH"][0], cr[b"ALPH"][0])
    assert len(co[b"ALPH"]) <= alph_bound(len(cr[b"ALPH"])), (len(co[b"ALPH"]), len(cr[b"ALPH"]))
    pil = assert_readers_agree(ours)
    np.testing.assert_array_equal(pil[..., 3], a[..., 3])
    ref_pil = np.asarray(Image.open(io.BytesIO(ref)).convert("RGBA"))
    np.testing.assert_array_equal(pil[..., :3], ref_pil[..., :3])


# ---------------------------------------------------------------------------
# stages 1-2: the planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,kind", [c for c in CASES if c[0][0] * c[0][1] <= 67 * 91]
                         + [((480, 640), "frame")], ids=str)
def test_planes_equal_libwebp(size, kind):
    h, w = size
    rgb = content(kind, h, w)
    arrays = [rgb, np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)]
    arrays += [np.concatenate([rgb, alpha(k, h, w)[..., None]], -1) for k in ALPHAS]
    for a in arrays:
        for cleanup in (False, True):
            ours, ref = native_image.webp_encode_planes(a, cleanup), libwebp_planes(a, cleanup)
            for k in "yuv":
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"{k} cleanup={cleanup}")
            assert (ours["a"] is None) == (ref["a"] is None)
            if ref["a"] is not None:
                np.testing.assert_array_equal(ours["a"], ref["a"])


# ---------------------------------------------------------------------------
# the files against Pillow's save
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,kind", CASES, ids=str)
def test_encode_matches_pillow(size, kind):
    h, w = size
    rgb = content(kind, h, w)
    exact = {
        "L": rgb[..., 1].copy(),
        "RGB": rgb,
        "RGBA opaque": np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1),
        "I;16": (rgb[..., 0].astype(np.uint16) * 3),
    }
    for mode, a in exact.items():
        ours, ref = webp.encode_webp(a), pillow_save(a)
        assert ours == ref, f"{mode}: {vp8_divergence(ours, ref)}"
        assert_readers_agree(ours)
    for k in ALPHAS:
        a = np.concatenate([rgb, alpha(k, h, w)[..., None]], -1)
        check_alpha_file(webp.encode_webp(a), pillow_save(a), a)


def test_committed_q80_fixtures_from_sources():
    """The q80 fixtures Pillow wrote come out of their sources again: the
    RGB files byte for byte, alpha.webp's VP8X and VP8 chunks and ALPH
    header byte, with its alpha exact, and anim.webp around the port's two
    frames."""
    from stillleben_tpu_torch.assets.procedural import base_color_texture, sky_ldr

    def committed(name):
        with open(path(name), "rb") as f:
            return f.read()

    sources = {"q80.webp": smooth(67, 91, 3, 1), "frame.webp": webp_frame(),
               "blob_basecolor.webp": base_color_texture(0)[..., :3], "sky.webp": sky_ldr()}
    for name, a in sources.items():
        ours = webp.encode_webp(a)
        assert ours == committed(name), f"{name}: {vp8_divergence(ours, committed(name))}"
    rgba = np.concatenate([smooth(67, 91, 3, 1), smooth(67, 91, 1, 2)], -1)
    check_alpha_file(webp.encode_webp(rgba), committed("alpha.webp"), rgba)
    frames = [webp.encode_webp(smooth(22, 30, 3, 3)), webp.encode_webp(smooth(40, 48, 3, 4))]
    assert webp_anim((48, 40), [(6, 8, frames[0]), (0, 0, frames[1])]) == committed("anim.webp")


# ---------------------------------------------------------------------------
# ImageSaver
# ---------------------------------------------------------------------------


def test_oversize_fails_in_both_savers(tmp_path, capsys):
    """A side over 16383 fails in the worker with Pillow's line in both
    packages, and leaves no file; 1x16383 still encodes."""
    from stillleben_tpu.assets.image_saver import ImageSaver as JaxImageSaver

    big = np.zeros((1, 16384, 3), np.uint8)
    ports, jaxs = str(tmp_path / "port.webp"), str(tmp_path / "jax.webp")
    with ImageSaver(num_threads=1) as port, JaxImageSaver(num_threads=1) as ref:
        port.save(big, ports)
        ref.save(big, jaxs)
    out = capsys.readouterr().out.splitlines()
    msg = "encoding error 5: Image size exceeds WebP limit of 16383 pixels"
    assert f"ImageSaver: failed to write {ports}: {msg}" in out
    assert f"ImageSaver: failed to write {jaxs}: {msg}" in out
    assert not os.path.exists(ports) and not os.path.exists(jaxs)
    edge = np.zeros((1, 16383, 3), np.uint8)
    ours = webp.encode_webp(edge)
    assert ours == pillow_save(edge) and len(ours) == 528


def test_threads_equal_serial(tmp_path):
    """``ImageSaver(num_threads=4)`` over 16 images writes what serial
    encodes give (the encoder is re-entrant)."""
    images = []
    for i in range(16):
        a = smooth(48 + i, 64, 4 if i % 2 else 3, 40 + i)
        if i % 4 == 1:
            a[..., 3] = np.where(a[..., 3] > 100, 255, 0)
        images.append(a)
    with ImageSaver(num_threads=4) as saver:
        for i, a in enumerate(images):
            saver.save(a, str(tmp_path / f"{i}.webp"))
    for i, a in enumerate(images):
        assert (tmp_path / f"{i}.webp").read_bytes() == webp.encode_webp(a)


def test_image_saver_webp_matches_jax(tmp_path):
    """The JAX ``ImageSaver`` and the port's write the parity test's arrays
    to ``.webp``: rgb, grey and depth byte for byte; rgba with its VP8X and
    VP8 chunks and ALPH header byte equal and its alpha exact."""
    from stillleben_tpu.assets.image_saver import ImageSaver as JaxImageSaver
    from test_torch_image_parity import ARRAYS

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    with ImageSaver(num_threads=2) as port, JaxImageSaver(num_threads=2) as ref:
        for name, make in ARRAYS.items():
            port.save(make(), str(tmp_path / "port" / f"{name}.webp"))
            ref.save(make(), str(tmp_path / "jax" / f"{name}.webp"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == sorted(
        f"{n}.webp" for n in ARRAYS)
    for name in ("rgb", "grey", "depth"):
        ours = (tmp_path / "port" / f"{name}.webp").read_bytes()
        ref = (tmp_path / "jax" / f"{name}.webp").read_bytes()
        assert ours == ref, f"{name}: {vp8_divergence(ours, ref)}"
    rgba = ARRAYS["rgba"]()
    check_alpha_file((tmp_path / "port" / "rgba.webp").read_bytes(),
                     (tmp_path / "jax" / "rgba.webp").read_bytes(), rgba)


def test_divergence_finder_names_the_stage():
    """``vp8_partition0`` reads every macroblock's modes from partition 0;
    ``vp8_divergence`` gives None for equal files and else the first stage
    at which they part: the segment header for another quality, the token
    probabilities for another method."""
    a = webp_frame()
    ours = webp.encode_webp(a)
    info = vp8_partition0(ours)
    assert (info["w"], info["h"], info["partitions"], info["skip_proba"]) == (640, 480, 1, None)
    assert len(info["macroblocks"]) == 40 * 30
    assert all(("i16" in mb) != ("i4" in mb) for mb in info["macroblocks"])
    assert vp8_divergence(ours, webp_save(a, quality=80)) is None
    assert vp8_divergence(ours, webp_save(a, quality=79)).startswith("partition 0, segments")
    assert vp8_divergence(ours, libwebp_encode(a, 80, method=3)).startswith(
        "partition 0, proba_updates")
