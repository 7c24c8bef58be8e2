"""The port's QOI, SGI, PCX/DCX, IM and DDS codecs (``assets/qoi.py``,
``sgi.py``, ``pcx.py``, ``im.py``, ``dds.py`` over the native core
``csrc/sl_plain_formats.cpp``) against Pillow 12.1.0 and OpenCV 5.0.0 on
the same bytes.

- Encoding: every extension of the five formats in every mode the JAX
  ``ImageSaver`` hands Pillow, over sizes and contents, gives Pillow's
  ``save`` bytes, or refuses where Pillow refuses.
- Reading: ``read_image`` equals ``Image.open(p).convert("RGBA")`` on
  Pillow's files, on the variants Pillow reads but does not write (the
  writers of ``tests/torch_image_fixtures.py``) and on random BC1-BC7
  blocks, block by block; ``read_image_cv2`` gives None where
  ``cv2.imread`` does. Damaged files raise where Pillow raises.
- The committed fixtures hold their digests and re-encode from their
  sources; a panorama saved as SGI loads as the JAX light map loads it.
"""

import hashlib
import io
import os
import struct

import numpy as np
import pytest

from stillleben_tpu_torch.assets import dds, image, im, native_image, pcx, qoi, sgi
from stillleben_tpu_torch.assets.image_fixtures import (PLAIN_ENCODE_FILES, PLAIN_READ_FILES,
                                                        path, plain_sources)
from stillleben_tpu_torch.assets.image_fixtures.digests import PLAIN_DECODE, PLAIN_FILE
import torch_port_scene  # noqa: F401  (limits torch's threads under pytest-xdist)
from torch_image_fixtures import (bcn_blocks, dcx, dds_file, dds_masked, pcx_bitplanes, pcx_file,
                                  sgi_file, smooth)

Image = pytest.importorskip("PIL.Image")
cv2 = pytest.importorskip("cv2")

EXTS = (".qoi", ".sgi", ".rgb", ".rgba", ".bw", ".pcx", ".im", ".dds")
ENCODERS = {".qoi": lambda a, p: qoi.encode_qoi(a), ".pcx": lambda a, p: pcx.encode_pcx(a),
            ".im": im.encode_im, ".dds": lambda a, p: dds.encode_dds(a),
            **{e: sgi.encode_sgi for e in (".sgi", ".rgb", ".rgba", ".bw")}}
# format -> (DXGI code, bytes a block)
DX10 = {"BC1": (71, 8), "BC2": (74, 16), "BC3": (77, 16), "BC4": (80, 8), "BC5": (83, 16),
        "BC5S": (84, 16), "BC6H": (95, 16), "BC6HS": (96, 16), "BC7": (98, 16)}


def pillow_rgba(data: bytes):
    """Pillow's ``convert("RGBA")``, or the exception's type where it raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    except Exception as e:  # noqa: BLE001 - the reference's failure is the result
        return type(e).__name__


def port_rgba(data: bytes, name: str = "x"):
    try:
        return image.decode_image(data, name)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


def assert_same_reading(data: bytes, what: str):
    ref, ours = pillow_rgba(data), port_rgba(data)
    if isinstance(ref, str) or isinstance(ours, str):
        assert isinstance(ref, str) and isinstance(ours, str), (what, ref, ours)
    else:
        assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
        diff = (ours != ref).any(-1)
        assert not diff.any(), f"{what}: {int(diff.sum())} pixels differ, first at " \
                               f"{np.argwhere(diff)[0].tolist()}"


def pillow_file(a: np.ndarray, ext: str, d, name: str = "x"):
    """What Pillow's ``save`` writes for ``a`` to ``d/name+ext``, or None."""
    p = os.path.join(d, name + ext)
    if os.path.exists(p):
        os.remove(p)
    try:
        Image.fromarray(a).save(p)
    except Exception:  # noqa: BLE001
        assert not os.path.exists(p)
        return None
    with open(p, "rb") as f:
        return f.read()


def sources(h: int, w: int, seed: int) -> dict:
    """The four modes in four contents: smooth, noise, runs, a constant."""
    rng = np.random.default_rng(seed)
    out = {}
    for kind in ("smooth", "noise", "runs", "flat"):
        if kind == "smooth":
            rgba = np.concatenate([smooth(h, w, 3, seed), smooth(h, w, 1, seed + 1)], -1)
        elif kind == "noise":
            rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        elif kind == "runs":  # long runs of values over 0xC0 among others
            cols = rng.choice(np.array([0, 5, 191, 192, 200, 255], np.uint8), (h, (w + 69) // 70, 4))
            rgba = np.repeat(cols, 70, axis=1)[:, :w]
        else:
            rgba = np.full((h, w, 4), 201, np.uint8)
        out[f"{kind} L"] = np.ascontiguousarray(rgba[..., 0])
        out[f"{kind} RGB"] = np.ascontiguousarray(rgba[..., :3])
        out[f"{kind} RGBA"] = rgba
        out[f"{kind} I;16"] = (rgba[..., 0].astype(np.uint16) * 257 + rgba[..., 1]).astype(np.uint16)
    return out


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (5, 1), (7, 13), (40, 130)])
def test_encode_matches_pillow(size, tmp_path):
    """Every extension and mode: Pillow's bytes, or a refusal where Pillow
    refuses; the port reads each file back as Pillow does."""
    for key, a in sources(*size, seed=size[0] * 31 + size[1]).items():
        for ext in EXTS:
            ref = pillow_file(a, ext, tmp_path)
            try:
                ours = ENCODERS[ext](a, str(tmp_path / ("x" + ext)))
            except (ValueError, OSError):
                ours = None
            assert ours == ref, (key, ext, size)
            if ref is not None:
                assert_same_reading(ref, f"{key} {ext} {size}")


def test_header_names(tmp_path):
    """SGI and IM write the base name as Pillow does: SGI without the
    extension, ASCII only, cut at 79 bytes; IM with the extension, the name
    cut at 92 less the extension's length."""
    a = smooth(3, 4, 3, 0)
    for base in ("x", "a" * 120, "tëxt name", "dots.in.name"):
        for ext in (".sgi", ".rgb", ".im"):
            ref = pillow_file(a, ext, tmp_path, base)
            try:
                ours = ENCODERS[ext](a, str(tmp_path / (base + ext)))
            except UnicodeEncodeError:
                ours = None
            assert ours == ref, (base, ext)


@pytest.mark.parametrize("fmt", sorted(DX10))
def test_bcn_random_blocks(fmt):
    """Random blocks in a DX10 file at 64x64 (256 blocks, every mode of BC6H
    and BC7) and odd sizes, compared block by block: the first block that
    differs is named with its mode byte."""
    dxgi, block = DX10[fmt]
    for seed, (w, h) in enumerate(((64, 64), (7, 5), (13, 9), (1, 1))):
        blocks = bcn_blocks(w, h, block, 100 + seed)
        data = dds_file(w, h, 0x4, blocks, dxgi=dxgi)
        ref, ours = pillow_rgba(data), port_rgba(data)
        assert not isinstance(ours, str), ours
        if np.array_equal(ref, ours):
            continue
        by, bx = np.argwhere((ref != ours).any(-1))[0] // 4
        i = int(by * ((w + 3) // 4) + bx)
        raise AssertionError(f"{fmt} {w}x{h}: block {i} differs, its first byte (the mode) "
                             f"{blocks[i * block]:#04x}")


def test_bcn_pillow_writes():
    """Pillow's own BCn writes (DXT1, DXT3, DXT5, BC2, BC3, BC5) of smooth and
    noisy images with alpha, odd sizes among them."""
    for w, h in ((45, 37), (8, 4), (3, 2)):
        rgba = np.concatenate([smooth(h, w, 3, w), smooth(h, w, 1, h)], -1)
        for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"):
            b = io.BytesIO()
            src = Image.fromarray(rgba[..., :3] if pf == "BC5" else rgba)
            src.save(b, "DDS", pixel_format=pf)
            assert_same_reading(b.getvalue(), f"{pf} {w}x{h}")


def test_bcn_truncated():
    dxgi, block = DX10["BC7"]
    data = dds_file(8, 8, 0x4, bcn_blocks(8, 8, block, 0)[:-1], dxgi=dxgi)
    assert_same_reading(data, "truncated BC7")
    with pytest.raises(OSError):
        dds.decode_dds(data)


@pytest.mark.parametrize("masks,bitcount,flags", [
    ((0xF800, 0x7E0, 0x1F, 0), 16, 0x40), ((0x7C00, 0x3E0, 0x1F, 0x8000), 16, 0x41),
    ((0xF00, 0xF0, 0xF, 0xF000), 16, 0x41), ((0xFF0000, 0xFF00, 0xFF, 0), 24, 0x40),
    ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), 32, 0x41), ((0x3, 0xC, 0x30, 0xC0), 8, 0x41),
    ((0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000), 32, 0x41), ((0, 0xFF00, 0xFF, 0), 16, 0x40)])
def test_dds_masks(masks, bitcount, flags):
    """``DDPF_RGB`` with any masks: Pillow's truncating scale of each field,
    whole and cut short (zeros past the data's end)."""
    rgba = np.concatenate([smooth(9, 11, 3, bitcount), smooth(9, 11, 1, flags)], -1)
    body = dds_masked(rgba, masks, bitcount)
    for cut in (0, 5):
        data = dds_file(11, 9, flags, body[: len(body) - cut], bitcount=bitcount, masks=masks)
        assert_same_reading(data, f"masks {masks} cut {cut}")


def test_dds_other_layouts():
    """Luminance, luminance with alpha, palette, R8G8B8A8 through DX10, the
    FourCCs, and the formats Pillow refuses."""
    rng = np.random.default_rng(5)
    lum = rng.integers(0, 256, (6, 10, 2)).astype(np.uint8)
    cases = {
        "L": dds_file(10, 6, 0x20000, lum[..., 0].tobytes(), bitcount=8),
        "LA": dds_file(10, 6, 0x20001, lum.tobytes(), bitcount=16),
        "L 16 without alpha": dds_file(10, 6, 0x20000, lum.tobytes(), bitcount=16),
        "P": dds_file(10, 6, 0x20, rng.integers(0, 256, 1024 + 60).astype(np.uint8).tobytes(),
                      bitcount=8),
        "R8G8B8A8_SRGB": dds_file(10, 6, 0x4, rng.integers(0, 256, 240).astype(np.uint8).tobytes(),
                                  dxgi=29),
        "DXGI R16 (refused)": dds_file(10, 6, 0x4, bytes(120), dxgi=56),
        "FourCC ATC (refused)": dds_file(10, 6, 0x4, bytes(120), fourcc=b"ATC "),
        "no flags (refused)": dds_file(10, 6, 0, bytes(120)),
        "header size 100": b"DDS " + struct.pack("<I", 100) + bytes(200),
    }
    for fourcc, n in ((b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16), (b"BC4U", 8), (b"ATI1", 8),
                      (b"BC5U", 16), (b"ATI2", 16), (b"BC5S", 16)):
        cases[fourcc.decode()] = dds_file(10, 6, 0x4, bcn_blocks(10, 6, n, n), fourcc=fourcc)
    for what, data in cases.items():
        assert_same_reading(data, what)
    with pytest.raises(NotImplementedError):
        dds.decode_dds(cases["DXGI R16 (refused)"])


def test_qoi_streams():
    """Chunks Pillow's encoder never writes: an index that was never set,
    RGBA chunks in a 3-channel file, a run past the image's end, data that
    ends early."""
    head = lambda w, h, c: qoi.MAGIC + struct.pack(">IIBB", w, h, c, 0)  # noqa: E731
    body = bytes([0x05, 0xFF, 9, 8, 7, 6, 0x40 | 0x3F & 0b111111, 0x85, 0x7C, 0xFE, 1, 2, 3,
                  0xC0 | 20, 0x00, 0xFD]) + bytes(7) + b"\x01"
    for c in (3, 4, 7):
        assert_same_reading(head(5, 5, c) + body, f"channels {c}")
    assert_same_reading(head(5, 5, 4) + body[:6], "short")
    for a in sources(9, 17, 2).values():
        if a.ndim == 3:
            data = qoi.encode_qoi(a)
            np.testing.assert_array_equal(qoi.decode_qoi(data)[..., : a.shape[2]], a)


@pytest.mark.parametrize("bpc", [1, 2])
def test_sgi_reading(bpc):
    """Run-length and planar SGI at 1 and 2 bytes a sample, one, three and
    four channels, a one-row image, an unknown compression (Pillow's blank
    image), tables that point outside the data, and a run past a row."""
    rng = np.random.default_rng(bpc)
    top = 255 if bpc == 1 else 65535
    for z in (1, 3, 4):
        planes = rng.integers(0, top + 1, (z, 7, 19))
        planes[:, 2:5, 3:15] = 200 * (top // 255)  # runs
        for rle in (False, True):
            assert_same_reading(sgi_file(planes, bpc, rle), f"z {z} rle {rle}")
    one_row = sgi_file(planes[:1, :1], bpc, True, dimension=1)
    assert_same_reading(one_row, "one row")
    blank = bytearray(sgi_file(planes[:3], bpc))
    blank[2] = 2
    assert_same_reading(bytes(blank), "compression 2")
    bad = bytearray(sgi_file(planes[:1], bpc, True))
    bad[512:516] = struct.pack(">I", 10)
    assert_same_reading(bytes(bad), "offset inside the header")
    assert_same_reading(sgi_file(planes[:1], bpc, True)[:600], "tables cut short")
    assert_same_reading(b"\x01\xda" + bytes(10), "short header")


def test_sgi_rle_stops_where_pillow_stops():
    """A row whose length table ends on a byte that is not a terminator:
    Pillow's decoder stops there and keeps the rest of the image black."""
    planes = np.arange(3 * 4 * 6, dtype=np.uint8).reshape(3, 4, 6)
    data = bytearray(sgi_file(planes, 1, True))
    n = 3 * 4
    lengths = list(struct.unpack_from(f">{n}I", data, 512 + 4 * n))
    lengths[5] -= 1  # channel 1, row 1: the terminator falls outside the length
    struct.pack_into(f">{n}I", data, 512 + 4 * n, *lengths)
    assert_same_reading(bytes(data), "cut length")
    overrun = bytearray(sgi_file(planes, 1, True))
    overrun[512 + 8 * n] = 0x7F  # a run of 127 in a row of 6
    assert_same_reading(bytes(overrun), "run past the row")


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 9, 15, 16, 17, 45])
def test_pcx_reading(width):
    """Every PCX kind Pillow reads at widths around the byte and even-stride
    edges: 1 bit, 1 bit in 2 and 4 planes, 8-bit grey and palette, 24-bit;
    with the header's stride odd and even (Pillow's own stride and plane
    moves), runs that cross a row (Pillow's overrun), data that ends early."""
    rng = np.random.default_rng(width)
    h = 5
    for bits, planes in ((1, 1), (1, 2), (1, 4), (8, 1), (8, 3)):
        stride = (width * bits + 7) // 8
        for pad in (0, 1):
            rows = rng.integers(0, 256, (h, planes * (stride + pad))).astype(np.uint8)
            pal = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
            for trailer in (b"", b"\x0c" + pal):
                data = pcx_file(rows, width, bits, planes, palette16=pal[:48], trailer=trailer)
                assert_same_reading(data, f"bits {bits} planes {planes} pad {pad}")
        assert_same_reading(data[:-20 - len(trailer)], f"bits {bits} planes {planes} cut")
    index = rng.integers(0, 16, (h, width))
    assert_same_reading(pcx_bitplanes(index, 4, bytes(range(48))), "4 bit planes")
    over = pcx_file(np.zeros((1, 1), np.uint8), 1, 8, 1)
    over = over[:128] + b"\xc3\x07" + over[130:]  # a run of 3 in a row of 1 (stride 1)
    assert_same_reading(over, "run over the row")
    grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    l_file = pcx_file(rng.integers(0, 256, (h, width + width % 2)).astype(np.uint8), width, 8, 1,
                      trailer=b"\x0c" + grey)
    assert_same_reading(l_file, "grey ramp palette")
    assert_same_reading(pcx_file(rows, width, 8, 2), "8 bits in 2 planes (refused)")
    assert_same_reading(pcx_file(rows[:, :stride], width, 8, 1, version=3), "version 3, 8 bits")


def test_pcx_pillow_writes(tmp_path):
    """Pillow's PCX of modes 1 and P, odd widths among them."""
    for w in (1, 9, 30):
        rgb = smooth(6, w, 3, w)
        for img in (Image.fromarray(rgb[..., 0]).convert("1"),
                    Image.fromarray(rgb).quantize(40), Image.fromarray(rgb).quantize(3)):
            b = io.BytesIO()
            img.save(b, "PCX")
            assert_same_reading(b.getvalue(), f"{img.mode} width {w}")


def test_dcx_frame0():
    """DCX: frame 0; an 8-bit frame's palette is read from the whole file's end."""
    rgb = smooth(6, 10, 3, 1)
    frames = []
    for img in (Image.fromarray(rgb[..., 0]), Image.fromarray(rgb).quantize(9),
                Image.fromarray(rgb)):
        b = io.BytesIO()
        img.save(b, "PCX")
        frames.append(b.getvalue())
    for order in ((0, 1), (1, 0), (0, 2), (2, 0), (0,)):
        assert_same_reading(dcx([frames[i] for i in order]), f"frames {order}")
    assert_same_reading(dcx([]), "no frames")


def test_im_pillow_modes():
    """IM in every mode Pillow's ``SAVE`` table writes, P and PA with a Lut
    among them; YCbCr over every (Cb, Cr) pair."""
    rng = np.random.default_rng(3)
    rgb = smooth(9, 14, 3, 2)
    rgba = np.concatenate([rgb, smooth(9, 14, 1, 3)], -1)
    imgs = {
        "1": Image.fromarray(rgb[..., 0]).convert("1"), "L": Image.fromarray(rgb[..., 0]),
        "LA": Image.fromarray(rgba[..., 2:]).convert("LA"),
        "P": Image.fromarray(rgb).quantize(20), "PA": Image.fromarray(rgb).quantize(20).convert("PA"),
        "I": Image.fromarray(rng.integers(-300, 600, (9, 14)).astype(np.int32), "I"),
        "F": Image.fromarray(rng.uniform(-50, 400, (9, 14)).astype(np.float32), "F"),
        "RGB": Image.fromarray(rgb), "RGBA": Image.fromarray(rgba),
        "RGBX": Image.fromarray(rgba).convert("RGBX"), "CMYK": Image.fromarray(rgba, "CMYK"),
        "YCbCr": Image.fromarray(rgb, "YCbCr"),
        "YCbCr pairs": Image.fromarray(np.stack([np.full((256, 256), 128)] + list(
            np.meshgrid(np.arange(256), np.arange(256))), -1).astype(np.uint8), "YCbCr"),
    }
    for bits in ("I;16", "I;16L", "I;16B"):
        imgs[bits] = Image.frombytes(bits, (14, 9), rng.integers(0, 256, 252).astype(np.uint8).tobytes())
    imgs["P grey Lut"] = Image.fromarray(rgb[..., 0]).convert("P")
    for mode, img in imgs.items():
        b = io.BytesIO()
        img.save(b, "IM")
        assert_same_reading(b.getvalue(), mode)


def test_im_headers():
    """IM has no magic: a file is IM where Pillow's header parse takes it,
    and other text is not; other kinds raise by name; damaged headers."""
    good = (b"Image type: RGB image\r\nImage size (x*y): 3*2\r\n").ljust(511, b"\0") + b"\x1a"
    body = bytes(range(18))
    cases = {
        "good": good + body,
        "\\n line ends, no size (512x512 default)": b"Image type: L 16 image\n\x1a" + bytes(2 * 512 * 512),
        "no type (L)": b"Image size (x*y): 2*2\n\x1a" + bytes(4),
        "not a tag": b"Hello: world\n\x1a" + bytes(4),
        "no newline in 100 bytes": b"Image type: RGB image" + b" " * 100 + b"\n\x1a",
        "a line over 100": b"Comment: " + b"x" * 120 + b"\n\x1a",
        "syntax": b"Image type: RGB image\n3 by 2\n\x1a",
        "no 0x1a": b"Image type: RGB image\nImage size (x*y): 1*1\n",
        "truncated body": good + body[:5],
        "CR before keys": b"\r\rImage size (x*y): 1*1\r\n\x1a\x07",
    }
    for what, data in cases.items():
        assert_same_reading(data, what)
    for kind in sorted(im.OTHER_KINDS)[:8]:
        data = f"Image type: {kind}\nImage size (x*y): 2*2\n".encode() + b"\x1a" + bytes(64)
        ref = pillow_rgba(data)
        with pytest.raises(NotImplementedError, match=kind.split()[0]):
            im.decode_im(data)
        assert not isinstance(ref, str) or ref != "UnidentifiedImageError", kind


def test_read_image_cv2_gives_none(tmp_path):
    """OpenCV reads none of the five formats; nor does the port."""
    for name in PLAIN_ENCODE_FILES + PLAIN_READ_FILES:
        assert cv2.imread(path(name), cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH) is None, name
        assert image.read_image_cv2(path(name)) is None, name


def test_fixtures_digests():
    """Each committed file is the one Pillow (or the helper) wrote, and the
    port reads it to Pillow's reading's digest (Pillow's reading, live)."""
    assert set(PLAIN_FILE) == set(PLAIN_DECODE) == set(PLAIN_ENCODE_FILES + PLAIN_READ_FILES)
    for name in PLAIN_FILE:
        with open(path(name), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == PLAIN_FILE[name], name
        rgba = image.read_image(path(name))
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == PLAIN_DECODE[name], name
        np.testing.assert_array_equal(rgba, pillow_rgba(data), err_msg=name)


def test_fixtures_from_sources():
    """Each encode fixture is the port's encode of its source."""
    srcs = plain_sources()
    assert tuple(srcs) == PLAIN_ENCODE_FILES
    for name, a in srcs.items():
        with open(path(name), "rb") as f:
            data = f.read()
        assert ENCODERS[os.path.splitext(name)[1]](a, name) == data, name


def test_light_map_panorama_sgi(tmp_path):
    """A panorama saved as SGI: the port's light-map loader (OpenCV's None,
    then Pillow's RGB to the power 2.2) equals the JAX loader's array."""
    from stillleben_tpu.render.light_map import _load_hdr_image as jax_load
    from stillleben_tpu_torch.assets.procedural import sky_ldr
    from stillleben_tpu_torch.render.light_map import _load_hdr_image as port_load

    p = str(tmp_path / "sky.sgi")
    with open(p, "wb") as f:
        f.write(sgi.encode_sgi(sky_ldr(32, 64), p))
    np.testing.assert_allclose(port_load(p), jax_load(p), rtol=0, atol=1e-6)


def test_native_failures():
    """The native core refuses a BCn format it does not know, and reports
    data that ends early."""
    with pytest.raises(NotImplementedError):
        native_image.bcn_decode(bytes(16), 9, False, 4, 4)
    with pytest.raises(OSError):
        native_image.qoi_decode(b"\x00", 2, 2, 3)
    with pytest.raises(OSError):
        native_image.pcx_decode(b"\xc5", 4, 1)
