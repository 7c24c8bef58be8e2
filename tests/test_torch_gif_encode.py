"""The port's GIF encoder (``assets/gif.py::encode_gif`` over
``csrc/sl_gif_enc.cpp``) against Pillow 12.1.0's ``save`` on the same arrays,
and the port's ``ImageSaver`` against the JAX package's for every extension
this slice adds.

Stage by stage: the median cut's palette and index image equal
``Image.convert("P", palette=ADAPTIVE)``'s (RGB), the fast octree's equal
``Image.quantize(256)``'s (RGBA), and the LZW stream, given Pillow's own
index image, equals the one in Pillow's ``save(..., optimize=False)``. The
files then equal Pillow's byte for byte over the matrix (1x1, 31x45, 67x91,
640x480; a ramp, seeded noise with more than 4096 LZW codes and, at
640x480, more distinct colours than Pillow's median-cut hash holds, a flat
image, exactly 256 colours, under 16 colours, RGBA with a binary mask,
opaque and fully transparent, grey and 16-bit grey above 255); where a
file parts from Pillow's, ``gif_divergence`` names the first stage. The
committed encode fixtures come out of their sources again. A failed g++
build raises.
"""

import hashlib
import io
import os
import stat

import numpy as np
import pytest

from stillleben_tpu_torch.assets import gif, image, native_image
from stillleben_tpu_torch.assets.image_fixtures import ENCODE_FILES, encode_sources, path
from stillleben_tpu_torch.assets.image_fixtures.digests import ENCODE
from stillleben_tpu_torch.assets.image_saver import ENCODERS, ImageSaver
from stillleben_tpu_torch.assets.netpbm import encode_netpbm
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import gif_divergence, gif_parts, pillow_save

Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (31, 45), (67, 91), (480, 640)]
RGB_SOURCES = ("ramp", "noise", "flat", "colours256", "colours12")
RGBA_SOURCES = ("mask", "opaque", "transparent")
SOURCES = RGB_SOURCES + RGBA_SOURCES + ("grey", "depth")
CASES = [(s, k) for s in SIZES for k in SOURCES]
# the extensions this slice adds to ImageSaver, and what each must equal
NEW_EXTENSIONS = (".gif", ".ppm", ".pgm", ".pbm", ".pnm", ".pfm", ".jpe", ".jfif", ".mpo", ".apng",
                  ".dib", ".icb", ".vda", ".vst")


def source(kind: str, h: int, w: int) -> np.ndarray:
    """The matrix's arrays, seeded by their size."""
    rng = np.random.default_rng(h * 1000 + w)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "ramp":
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256],
                        -1).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), (97, 151, 212), np.uint8)
    if kind == "colours256":  # every one of 256 colours where there is room
        pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
        return pal[rng.permutation(np.arange(h * w) % 256).reshape(h, w)]
    if kind == "colours12":
        pal = rng.integers(0, 256, (12, 3)).astype(np.uint8)
        return pal[rng.integers(0, 12, (h, w))]
    if kind in RGBA_SOURCES:
        rgb = source("ramp" if kind == "mask" else "noise", h, w)
        disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 2.5) ** 2 + 1
        a = {"mask": disc * 255, "opaque": np.full((h, w), 255),
             "transparent": np.zeros((h, w))}[kind].astype(np.uint8)
        return np.concatenate([rgb, a[..., None]], -1)
    if kind == "grey":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    return (yy * 7 + xx * 3 + rng.integers(0, 200, (h, w))).astype(np.uint16)  # depth, to ~5000


def pillow_p(a: np.ndarray):
    """The image Pillow's GIF writer quantises ``a`` to (``_normalize_mode``)."""
    im = Image.fromarray(a)
    if im.mode == "RGB":
        return im.convert("P", palette=Image.Palette.ADAPTIVE)
    if im.mode == "RGBA":
        return im.quantize(256)
    return im.convert("L")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", RGB_SOURCES)
def test_median_cut_matches_pillow(size, kind):
    a = source(kind, *size)
    ref = pillow_p(a)
    palette, index = native_image.quantize_median(a)
    np.testing.assert_array_equal(palette, np.asarray(ref.getpalette(None), np.uint8).reshape(-1, 3))
    np.testing.assert_array_equal(index, np.asarray(ref))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", RGBA_SOURCES + ("noise",))
def test_octree_matches_pillow(size, kind):
    a = source(kind, *size)
    if a.shape[2] == 3:  # noise under a seeded alpha of every level
        alpha = np.random.default_rng(7).integers(0, 256, size).astype(np.uint8)
        a = np.concatenate([a, alpha[..., None]], -1)
    ref = Image.fromarray(a).quantize(256)
    palette, index = native_image.quantize_octree(a)
    np.testing.assert_array_equal(palette,
                                  np.asarray(ref.getpalette("RGBA"), np.uint8).reshape(-1, 4))
    np.testing.assert_array_equal(index, np.asarray(ref))


@pytest.mark.parametrize("size,kind", CASES, ids=[f"{s[0]}x{s[1]}-{k}" for s, k in CASES])
def test_lzw_matches_pillow(size, kind):
    """Pillow's own index image, LZW-coded by the port: the stream in
    Pillow's ``save(optimize=False)`` of that image, sub-blocks and all."""
    im = pillow_p(source(kind, *size))
    b = io.BytesIO()
    im.save(b, "GIF", optimize=False)
    ref = gif_parts(b.getvalue())
    interlace = min(size) >= 16
    ours = native_image.gif_lzw_encode(np.asarray(im), interlace)
    assert ours == ref["lzw"]


@pytest.mark.parametrize("size,kind", CASES, ids=[f"{s[0]}x{s[1]}-{k}" for s, k in CASES])
def test_gif_file_matches_pillow(size, kind):
    a = source(kind, *size)
    ours, ref = gif.encode_gif(a), pillow_save(a, ".gif")
    assert gif_divergence(ours, ref) is None
    assert ours == ref


def test_matrix_reaches_the_hard_cases():
    """The 640x480 noise has more distinct colours than Pillow's median-cut
    hash holds (65536) and more LZW codes than a table (4096): the
    encoder's rescale and clear paths run."""
    a = source("noise", 480, 640)
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 65536
    # every code is at least 9 bits: more than 4096 codes take more bytes
    assert len(gif_parts(gif.encode_gif(a))["lzw"]) > 4 * 4096 * 9 // 8
    assert len(np.unique(source("colours256", 67, 91).reshape(-1, 3), axis=0)) == 256


def test_wide_images_match_pillow():
    """Wider than 16384 pixels, Pillow's encoder buffer is 4 x width bytes,
    and a sub-block is cut short at its end."""
    rng = np.random.default_rng(3)
    for a in (rng.integers(0, 256, (2, 20000)).astype(np.uint8),
              rng.integers(0, 256, (17, 16500, 3)).astype(np.uint8)):
        assert gif_divergence(gif.encode_gif(a), pillow_save(a, ".gif")) is None


def test_committed_fixtures_from_sources():
    """Each encode fixture is Pillow's file (its digest), and the port's
    encoder writes it again from its source."""
    sources = encode_sources()
    assert set(sources) == set(ENCODE_FILES) == set(ENCODE)
    for name in ENCODE_FILES:
        with open(path(name), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == ENCODE[name], name
        enc = gif.encode_gif if name.endswith(".gif") else encode_netpbm
        assert enc(sources[name]) == data, name
        assert pillow_save(sources[name], os.path.splitext(name)[1]) == data, name


def test_gif_reads_back():
    """The port's reading of its own GIF is its palette at its indices, the
    transparent index where the alpha was 0."""
    a = source("mask", 67, 91)
    index, palette, transparency = gif.gif_index(a)
    rgba = image.decode_image(gif.encode_gif(a))
    np.testing.assert_array_equal(rgba[..., :3], palette[index])
    np.testing.assert_array_equal(rgba[..., 3] == 0, a[..., 3] == 0)
    assert transparency is not None


def _jax_saver():
    from stillleben_tpu.assets.image_saver import ImageSaver as JaxImageSaver

    return JaxImageSaver


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ext", NEW_EXTENSIONS)
def test_image_saver_matches_jax(tmp_path, capsys, ext, size):
    """Both savers, every mode: the same bytes, or (where Pillow refuses
    the mode) nothing written by either and a message printed by both."""
    assert ext in ENCODERS
    arrays = {"grey": source("grey", *size), "rgb": source("noise", *size),
              "rgba": source("mask", *size), "depth": source("depth", *size)}
    with ImageSaver(num_threads=2) as port, _jax_saver()(num_threads=2) as ref:
        for name, arr in arrays.items():
            port.save(arr, str(tmp_path / f"port_{name}{ext}"))
            ref.save(arr, str(tmp_path / f"jax_{name}{ext}"))
    printed = capsys.readouterr().out
    for name in arrays:
        p, j = tmp_path / f"port_{name}{ext}", tmp_path / f"jax_{name}{ext}"
        assert p.exists() == j.exists(), name
        if j.exists():
            assert p.read_bytes() == j.read_bytes(), name
        else:
            assert printed.count(f"port_{name}{ext}") == printed.count(f"jax_{name}{ext}") == 1


def test_threads_equal_serial(tmp_path):
    frames = [source(k, 67, 91) for k in ("ramp", "mask", "noise", "grey")] * 2
    with ImageSaver(num_threads=4) as saver:
        for i, a in enumerate(frames):
            saver.save(a, str(tmp_path / f"{i}.gif"))
    for i, a in enumerate(frames):
        assert (tmp_path / f"{i}.gif").read_bytes() == gif.encode_gif(a)


def test_divergence_finder_names_the_stage():
    a = source("ramp", 31, 45)
    ref = gif.encode_gif(a)
    assert gif_divergence(ref, ref) is None
    pal = bytearray(ref)
    pal[13] ^= 1
    assert gif_divergence(bytes(pal), ref) == "palette"
    other = gif.encode_gif(np.ascontiguousarray(a[::-1]))
    assert gif_divergence(other, ref).startswith(("palette", "index image"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A ``g++`` first on ``PATH`` that fails: the encoder raises with its
    message, nothing is left in the build directory, and no Python encoder
    stands in."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'broken compiler: cannot compile' >&2\nexit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native_image, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_image, "_gif_enc_lib", None)
    with pytest.raises(RuntimeError, match="broken compiler: cannot compile"):
        gif.encode_gif(source("ramp", 4, 4))
    assert not os.listdir(tmp_path / "build")
