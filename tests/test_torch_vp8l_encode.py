"""The alpha plane's VP8L stream (``csrc/sl_vp8l_enc.cpp`` through
``native_image.vp8l_encode_plane``) against libwebp 1.6.0's own, on the
plane alone.

libwebp's alpha encoder (alpha_enc.c's EncodeLossless) puts the plane in
the green byte of ARGB pixels whose alpha, red and blue are 0 and runs its
lossless encoder at method 4, quality 32, exact, with no header. The same
image through ``WebPEncode`` (lossless, method 4, quality 32, exact; over
Pillow's libwebp: ``torch_image_fixtures.libwebp_alpha_stream``) writes a
VP8L chunk whose bytes after its 5-byte header are that stream, for any
plane. So every plane of the matrix is held equal to it: sides from 1x1 to
640x480; flat, 2, 4 and 16 levels (the palette and its bundled indices),
17 to 256 levels, a smooth ramp, noise and the WebP frame's green; each
as it is and under each of libwebp's three alpha filters. A failure names
the first part that differs (``vp8l_divergence``: transforms, colour-cache
bits, meta prefix image, code lengths, then the first token). A seeded
sweep of 300 planes of random sides, kinds and filters holds the rarer
paths (colour caches, the clustering of many tiles' codes) the same way.
"""

import numpy as np
import pytest

from stillleben_tpu_torch.assets import native_image
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import (
    alpha_filter, libwebp_alpha_stream, libwebp_encode, smooth, vp8l_divergence, vp8l_parse,
    webp_chunks, webp_frame,
)

pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (2, 3), (1, 300), (300, 1), (17, 33), (67, 91), (256, 256), (480, 640)]
CONTENTS = ("flat", "levels2", "levels4", "levels16", "levels200", "ramp", "noise", "frame")
FILTERS = ("none", "horizontal", "vertical", "gradient")


def plane(kind: str, h: int, w: int) -> np.ndarray:
    """(h, w) uint8 of each kind: one value; a disc of 255 on 0; four
    levels in diagonal bands; a smooth field cut to 16 levels, or to every
    third value (up to 86 levels); the smooth field itself; seeded noise;
    the 640x480 WebP frame's green, tiled."""
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "flat":
        return np.full((h, w), 200, np.uint8)
    if kind == "levels2":
        disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 2.5) ** 2 + 1
        return disc.astype(np.uint8) * 255
    if kind == "levels4":
        return ((xx * 4 // w + yy) % 4 * 85).astype(np.uint8)
    if kind == "levels16":
        return (smooth(h, w, 1, h + w)[..., 0] // 16 * 17).astype(np.uint8)
    if kind == "levels200":
        return (smooth(h, w, 1, h * w)[..., 0] // 3 * 3).astype(np.uint8)
    if kind == "ramp":
        return smooth(h, w, 1, 5 + h + w)[..., 0]
    if kind == "noise":
        return np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w)).astype(np.uint8)
    frame = webp_frame()[..., 1]
    return np.tile(frame, (-(-h // 480), -(-w // 640)))[:h, :w].copy()


@pytest.mark.parametrize("filt", range(4), ids=FILTERS)
@pytest.mark.parametrize("kind", CONTENTS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_stream_equals_libwebp(size, kind, filt):
    h, w = size
    p = alpha_filter(plane(kind, h, w), filt)
    ours, ref = native_image.vp8l_encode_plane(p), libwebp_alpha_stream(p)
    assert ours == ref, vp8l_divergence(ours, ref, w, h)


def random_plane(seed: int) -> np.ndarray:
    """A seeded plane of a seeded size up to 480x640 and one of nine kinds:
    noise, a smooth field (whole, or cut to a few levels), sparse noise on
    255, checker bands of 2-17 levels, a ramp with noise, a random palette
    of up to 300 colours, discs of random levels, a wrapped ramp."""
    rng = np.random.default_rng(seed)
    h = int(rng.choice([1, 2, 3, 5, 8, 16, 31, 64, 100, 200, 480]))
    w = int(rng.choice([1, 2, 4, 7, 16, 33, 64, 130, 300, 640]))
    yy, xx = np.mgrid[0:h, 0:w]
    kind = seed % 9
    if kind == 0:
        p = rng.integers(0, 256, (h, w))
    elif kind == 1:
        p = smooth(h, w, 1, seed)[..., 0]
    elif kind == 2:
        p = (smooth(h, w, 1, seed)[..., 0] // int(rng.integers(2, 40))) * 7
    elif kind == 3:
        p = np.where(rng.random((h, w)) < 0.02, rng.integers(0, 256, (h, w)), 255)
    elif kind == 4:
        p = ((xx // int(rng.integers(1, 20)) + yy // int(rng.integers(1, 20)))
             % int(rng.integers(2, 18))) * 13
    elif kind == 5:
        p = np.clip(xx * 255 // max(w - 1, 1) + rng.integers(-3, 4, (h, w)), 0, 255)
    elif kind == 6:
        p = rng.choice(rng.integers(0, 256, int(rng.integers(1, 300))), (h, w))
    elif kind == 7:
        p = np.zeros((h, w), np.int64)
        for _ in range(int(rng.integers(1, 8))):
            cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, max(2, min(h, w)))
            p[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256)
    else:
        p = (yy * w + xx) % 256
    return alpha_filter(np.asarray(p).astype(np.uint8), int(rng.integers(0, 4)))


@pytest.mark.parametrize("first", range(0, 300, 30))
def test_seeded_sweep_equals_libwebp(first):
    """30 seeded planes a case (``random_plane``), 300 in all."""
    for seed in range(first, first + 30):
        p = random_plane(seed)
        ours, ref = native_image.vp8l_encode_plane(p), libwebp_alpha_stream(p)
        assert ours == ref, (seed, p.shape, vp8l_divergence(ours, ref, p.shape[1], p.shape[0]))


def test_divergence_finder_names_the_part():
    """``vp8l_parse`` decodes a stream without transforms back to its plane
    (in green); ``vp8l_divergence`` gives None for equal streams and else
    the first part that differs: the token for one changed sample, the
    transforms for a third level in a two-level plane, and the layout of
    libwebp's low-effort stream (method 0)."""
    a = alpha_filter(smooth(67, 91, 1, 2)[..., 0], 1)
    ours = native_image.vp8l_encode_plane(a)
    parsed = vp8l_parse(ours, 91, 67)
    assert parsed["transforms"] == []
    np.testing.assert_array_equal(np.array(parsed["main"]["pixels"]).reshape(67, 91),
                                  a.astype(np.uint32) << 8)
    assert vp8l_divergence(ours, libwebp_alpha_stream(a), 91, 67) is None
    b = a.copy()
    b[30, 40] ^= 1
    msg = vp8l_divergence(ours, libwebp_alpha_stream(b), 91, 67)
    assert msg.startswith("the main image: tokens: token "), msg

    mask = plane("levels2", 40, 50)
    m3 = mask.copy()
    m3[0, 0] = 7
    msg = vp8l_divergence(native_image.vp8l_encode_plane(mask), libwebp_alpha_stream(m3), 50, 40)
    assert msg == "transforms: [('palette', 2)] vs libwebp's [('palette', 3)]", msg

    argb = np.zeros((67, 91, 4), np.uint8)
    argb[..., 1] = a
    low = dict(webp_chunks(libwebp_encode(argb, quality=32.0, lossless=1, method=0, exact=1)))
    msg = vp8l_divergence(ours, low[b"VP8L"][5:], 91, 67)
    assert msg is not None and not msg.startswith("a stream does not parse"), msg


def test_plane_entry_refuses_bad_input():
    with pytest.raises(ValueError):
        native_image.vp8l_encode_plane(np.zeros((0, 4), np.uint8))
    with pytest.raises(ValueError):
        native_image.vp8l_encode_plane(np.zeros((2, 3, 1), np.uint8))
    with pytest.raises(ValueError, match="sides must be 1..16383"):
        native_image.vp8l_encode_plane(np.zeros((1, 16384), np.uint8))
