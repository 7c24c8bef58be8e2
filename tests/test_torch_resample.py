"""The port's resampler (``assets/resample.py``) against Pillow 12.1.0's
``Image.resize`` and ``thumbnail``, bitwise: BILINEAR, BICUBIC and LANCZOS
x L, RGB, RGBA and I;16 x reductions and enlargements (odd sizes, one
axis only, 640x480 to 1024^2) x noise and sharp edges at both ends of the
range (where BICUBIC and LANCZOS overshoot: 8-bit sums clip, 16-bit sums
keep Pillow's byte-by-byte clipping); the thumbnail sizes of ICO's save;
the texture atlas's ``resize_bilinear_u8`` through it."""

import numpy as np
import pytest

import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from stillleben_tpu_torch.assets import resample
from stillleben_tpu_torch.render.atlas import resize_bilinear_u8

Image = pytest.importorskip("PIL.Image")

FILTERS = {"BILINEAR": resample.BILINEAR, "BICUBIC": resample.BICUBIC,
           "LANCZOS": resample.LANCZOS}
MODES = ("L", "RGB", "RGBA", "I;16")
# (in h, in w, out h, out w)
SIZES = ((48, 64, 12, 16), (37, 53, 101, 29), (7, 5, 31, 3), (33, 1, 5, 9), (20, 30, 20, 47),
         (45, 23, 17, 23), (1, 1, 3, 2))


def content(mode: str, h: int, w: int, kind: str, seed: int = 0) -> np.ndarray:
    """Seeded noise, or blocks at 0 and full scale whose edges make the
    filters overshoot both ways (RGBA: with alpha at 0, 255 and between)."""
    rng = np.random.default_rng(seed)
    top = 65535 if mode == "I;16" else 255
    dtype = np.uint16 if mode == "I;16" else np.uint8
    shape = (h, w) if mode in ("L", "I;16") else (h, w, len(mode))
    if kind == "noise":
        return rng.integers(0, top + 1, shape).astype(dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    edge = ((xx * 3 // max(w, 1) + yy * 2 // max(h, 1)) % 2) * top
    a = np.broadcast_to(edge.reshape(h, w, *([1] * (len(shape) - 2))), shape).astype(dtype).copy()
    if mode == "RGBA":
        a[..., 3] = rng.choice(np.array([0, 255, 7, 128], np.uint8), (h, w))
    return a


def pillow(a: np.ndarray, mode: str) -> Image.Image:
    return Image.frombuffer(mode, (a.shape[1], a.shape[0]), np.ascontiguousarray(a).tobytes(),
                            "raw", mode, 0, 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("kind", ("noise", "edges"))
def test_resize_matches_pillow(mode, filt, kind):
    for i, (h, w, oh, ow) in enumerate(SIZES):
        a = content(mode, h, w, kind, seed=i)
        want = np.asarray(pillow(a, mode).resize((ow, oh), FILTERS[filt]))
        got = resample.resize(a, (ow, oh), FILTERS[filt])
        assert got.dtype == want.dtype and got.shape == want.shape, (h, w, oh, ow)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, oh, ow)))


@pytest.mark.parametrize("filt", FILTERS)
def test_frame_to_icns_sizes(filt):
    """The 640x480 frame up to 1024^2 and down to 32^2 (ICNS's sizes) in
    every mode, with a block at full scale beside zeros."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (480, 640, 4)).astype(np.uint8)
    a[100:300, 200:400] = (255, 0, 255, 0)
    deep = a[..., 0].astype(np.uint16) * 257
    deep[100:300, 200:400], deep[300:340, 200:400] = 65535, 0
    for mode, arr in (("RGBA", a), ("RGB", np.ascontiguousarray(a[..., :3])),
                      ("L", np.ascontiguousarray(a[..., 1])), ("I;16", deep)):
        for s in (1024, 32):
            want = np.asarray(pillow(arr, mode).resize((s, s), FILTERS[filt]))
            np.testing.assert_array_equal(resample.resize(arr, (s, s), FILTERS[filt]), want)


def test_sixteen_bit_overshoot_is_pillows():
    """At a sharp edge BICUBIC and LANCZOS sums pass 65535 and 0; Pillow
    stores the low byte (the value mod 256) under a high byte clipped at
    255, and 0 below: values like 65284 that a plain clip would not give."""
    a = np.zeros((9, 12), np.uint16)
    a[:, 6:] = 65535
    for filt in (resample.BICUBIC, resample.LANCZOS):
        want = np.asarray(pillow(a, "I;16").resize((31, 9), filt))
        got = resample.resize(a, (31, 9), filt)
        np.testing.assert_array_equal(got, want)
        assert ((want > 65280) & (want < 65535)).any() or filt == resample.BICUBIC


def test_thumbnail_sizes_match_pillow():
    """``thumbnail_size`` is Pillow's ``preserve_aspect_ratio`` (None where
    the box holds the image), over images and boxes of many aspects."""
    rng = np.random.default_rng(4)
    cases = [(640, 480, (s, s)) for s in (16, 24, 32, 48, 64, 128, 256)]
    cases += [(int(w), int(h), (int(bw), int(bh))) for w, h, bw, bh in
              rng.integers(1, 700, (300, 4))]
    cases += [(1, 700, (16, 16)), (700, 1, (16, 16)), (17, 16, (16, 16)), (16, 16, (16, 16))]
    for w, h, box in cases:
        im = Image.new("L", (w, h))
        im.thumbnail(box, Image.Resampling.LANCZOS, reducing_gap=None)
        size = resample.thumbnail_size(w, h, box)
        assert (size or (w, h)) == im.size, (w, h, box)


@pytest.mark.parametrize("mode", MODES)
def test_thumbnail_matches_pillow(mode):
    a = content(mode, 61, 83, "noise", seed=5)
    for box in ((16, 16), (48, 48), (256, 256), (83, 10)):
        im = pillow(a, mode)
        im.thumbnail(box, Image.Resampling.LANCZOS, reducing_gap=None)
        np.testing.assert_array_equal(resample.thumbnail(a, box, resample.LANCZOS),
                                      np.asarray(im))


def test_resize_bilinear_u8_is_pillows():
    """The atlas's BILINEAR resize is the module's: Pillow's RGBA resize."""
    a = content("RGBA", 75, 91, "noise", seed=6)
    for size in (256, (40, 13), (91, 75)):
        w, h = (size, size) if isinstance(size, int) else size
        want = np.asarray(pillow(a, "RGBA").resize((w, h), Image.Resampling.BILINEAR))
        np.testing.assert_array_equal(resize_bilinear_u8(a, size), want)


def test_refusals():
    with pytest.raises(ValueError, match="not ported"):
        resample.resize(np.zeros((4, 4), np.uint8), (2, 2), 0)  # NEAREST
    with pytest.raises(ValueError, match="> 0"):
        resample.resize(np.zeros((4, 4), np.uint8), (0, 2), resample.BICUBIC)
    with pytest.raises(ValueError, match="uint8 L, RGB, RGBA"):
        resample.resize(np.zeros((4, 4, 2), np.uint8), (2, 2), resample.BICUBIC)
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = resample.resize(a, (4, 3), resample.LANCZOS)
    assert np.array_equal(out, a) and out is not a
