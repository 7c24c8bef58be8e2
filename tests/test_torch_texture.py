"""Textures of the port against the JAX package: the port's own PNG/PPM
codec (round trip; equal to Pillow's decode where Pillow is installed), its
numpy resampler against ``PIL.Image.resize(BILINEAR)`` (equal on >= 99.9% of
the texels, within 1/255 everywhere), and ``build_scene_atlas`` of a
textured, stickered scene with a background plane: every array exactly
equal to the JAX package's (``tex_combo_quad``, a TPU layout the port does
not have, aside). An OBJ's MTL carries only a base-colour texture, so the
metallic-roughness, normal and emissive layers are reached by setting the
texture indices and ``images`` of a loaded mesh's consolidated materials by
hand, the same arrays on both sides."""

import numpy as np
import pytest
import torch

import stillleben_tpu as sl
from stillleben_tpu.render.atlas import build_scene_atlas as jax_build_scene_atlas
from stillleben_tpu.render.atlas import has_cutout_materials as jax_has_cutout
from stillleben_tpu.render.atlas import render_inputs_from_scene as jax_render_inputs
from stillleben_tpu_torch.assets import image
from stillleben_tpu_torch.assets.procedural import (
    base_color_texture, checker_texture, cutout_texture,
)
from stillleben_tpu_torch.assets.texture import Texture, Texture2D
from stillleben_tpu_torch.render import atlas as patlas
from stillleben_tpu_torch.scene.scene import Object, Scene
from torch_port_scene import build_full_meshes, fill_full_scene, to_numpy


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(37, 53, channels), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    image.write_png(path, img)
    back = image.read_image(path)
    assert back.shape == (37, 53, 4) and back.dtype == np.uint8
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()
    np.testing.assert_array_equal(Texture(path).pixels, back)


def test_png_filters_and_ppm_decode(tmp_path):
    """Scanlines written with each of the five PNG filters decode to the
    image; a binary PPM with a comment decodes; a greyscale PNG decodes;
    a file that names WebP over no valid container raises."""
    import struct
    import zlib

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(10, 7, 4), dtype=np.uint8)
    bpp, stride = 4, 28
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(10):
        ftype = y % 5
        line = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0 * line, left, prev, (left + prev) >> 1, paeth][ftype]
        raw += bytes([ftype]) + ((line - pred) & 255).astype(np.uint8).tobytes()
        prev = line

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (image.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 10, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image.decode_png(data), img)

    ppm = tmp_path / "t.ppm"
    ppm.write_bytes(b"P6\n# a comment\n7 10\n255\n" + img[..., :3].tobytes())
    np.testing.assert_array_equal(image.read_image(str(ppm))[..., :3], img[..., :3])
    webp = tmp_path / "t.webp"
    webp.write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 not really")
    with pytest.raises(ValueError, match="WebP"):
        image.read_image(str(webp))
    # a greyscale PNG (once refused) decodes as Pillow's convert("RGBA")
    grey = (image.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 10, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(b"\0" + r.tobytes() for r in img[..., 0])))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image.decode_png(grey)[..., 0], img[..., 0])
    assert (image.decode_png(grey)[..., 3] == 255).all()


def test_port_png_decodes_like_pillow(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "c.png")
    image.write_png(path, cutout_texture(3))
    np.testing.assert_array_equal(
        np.asarray(Image.open(path).convert("RGBA")), image.read_image(path)
    )
    # a PNG that Pillow wrote (adaptive filters) through the port's decoder
    img = base_color_texture(2, 64)
    Image.fromarray(img, "RGBA").save(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(image.read_image(str(tmp_path / "p.png")), img)


@pytest.mark.parametrize("shape", [(512, 512), (300, 200), (100, 130), (256, 512), (256, 256)])
@pytest.mark.parametrize("opaque", [True, False])
def test_resampler_matches_pillow(shape, opaque):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(shape[0] + shape[1])
    img = rng.integers(0, 256, size=shape + (4,), dtype=np.uint8)
    if opaque:
        img[..., 3] = 255
    ref = np.asarray(Image.fromarray(img, "RGBA").resize((256, 256), Image.BILINEAR))
    got = patlas.resize_bilinear_u8(img, 256)
    d = np.abs(ref.astype(np.int32) - got.astype(np.int32))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


def test_texture_linear_f32_and_checker():
    tex = Texture2D(checker_texture())
    assert (tex.width, tex.height) == (512, 512)
    np.testing.assert_array_equal(tex.linear_f32(), sl.Texture2D(checker_texture()).linear_f32())
    with pytest.raises(TypeError):
        Texture(np.zeros((4, 4, 4), np.float32))


def _layered(meshes):
    """Give the textured blob's material a metallic-roughness, a normal and
    an emissive texture by hand (seeded images of sizes that need the
    resampler), the same arrays for whoever loads ``meshes``."""
    rng = np.random.default_rng(11)
    extra = [rng.integers(0, 256, size=s + (4,), dtype=np.uint8)
             for s in ((128, 128), (64, 96), (256, 256))]
    c = meshes[2].consolidated
    c.images.extend(extra)
    mat = c.materials[0]
    mat.metallic_roughness_texture, mat.normal_texture, mat.emissive_texture = 1, 2, 3
    mat.has_metallic_factor = False  # so the texture promotes metallic to 1.0
    return meshes


@pytest.fixture(scope="module")
def atlases(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("meshes"))
    jm = _layered(build_full_meshes(d, native_decomp=False))
    pm = _layered(build_full_meshes(d, port=True, native_decomp=False))
    js = fill_full_scene(sl.Scene((48, 48)), jm, sl.Object, sl.Texture, sl.Texture2D, None,
                         stickers=True)
    js._objects[1]._color = np.array([0.2, 0.4, 0.6], np.float32)
    js._objects[1]._force_color = True
    ps = fill_full_scene(Scene((48, 48)), pm, Object, Texture, Texture2D, None, stickers=True)
    ps.objects[1].color = np.array([0.2, 0.4, 0.6], np.float32)
    ps.objects[1].force_color = True
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, -0.2, 0.05)
    js.background_plane_pose = pose
    ps.background_plane_pose = pose
    plane = dict(size=np.array([3.0, 3.0], np.float32), texture=checker_texture())
    ja = jax_build_scene_atlas(js.objects, background_plane=plane)
    pa = patlas.build_scene_atlas(ps.objects, "cpu", background_plane=plane)
    return js, ps, ja, pa


def test_build_scene_atlas_equals_jax(atlases):
    _, _, ja, pa = atlases
    jn = to_numpy(ja)
    compared = 0
    for name in pa._fields:
        got, ref = getattr(pa, name), getattr(jn, name)
        if name == "num_objects":
            assert got == int(ref) == 5
            continue
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        compared += 1
    assert compared == len(patlas.SceneAtlas._fields) - 1
    assert set(jn._fields) - set(pa._fields) == {"tex_combo_quad"}
    # what the scene was built to reach
    assert (pa.mat_base_tex >= 0).sum() == 3 and (pa.mat_mr_tex >= 0).sum() == 1
    assert (pa.mat_normal_tex >= 0).sum() == 1 and (pa.mat_emissive_tex >= 0).sum() == 1
    assert float(pa.mat_metallic[pa.mat_mr_tex >= 0]) == 1.0  # promoted by its texture
    assert pa.tex_combo.shape[1:] == (patlas.MIP_TOTAL, 16) and patlas.MIP_TOTAL == 87381
    assert pa.sticker_stack.shape[0] == 3 and (pa.obj_sticker_tex >= 0).sum() == 3
    assert int(pa.obj_class[-1]) == 0 and not pa.face_cullable[-2:].any()
    assert (pa.colors[pa.vert_obj == 1] == torch.tensor([0.2, 0.4, 0.6, 1.0])).all()


def test_render_inputs_with_plane_equal_jax(atlases):
    js, ps, ja, pa = atlases
    ji = to_numpy(jax_render_inputs(js, ja))
    pi = patlas.render_inputs_from_scene(ps, pa, "cpu")
    for name in pi._fields:
        got, ref = getattr(pi, name).numpy(), getattr(ji, name)
        assert got.shape == ref.shape, name
        if name == "projection":  # each package's own tan(): 1 ulp apart, 1e-6
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert pi.obj_instance.shape == (5,) and int(pi.obj_instance[-1]) == 0
    assert float(pi.obj_metallic[-1]) == -1.0 and bool(pi.obj_casts_shadows[-1])
    np.testing.assert_array_equal(pi.obj_to_world[-1, :3, 3].numpy(),
                                  np.array([0.1, -0.2, 0.05], np.float32))
    assert (pi.sticker_range[1:4] != 0).any(1).all() and not pi.sticker_range[0].any()


def test_has_cutout_materials(atlases, tmp_path):
    _, ps, ja, pa = atlases
    assert patlas.has_cutout_materials(pa) and jax_has_cutout(ja)
    opaque = patlas.build_scene_atlas(ps.objects[:3], "cpu")  # without the cutout cube
    assert not patlas.has_cutout_materials(opaque)
