"""Procedural test and benchmark meshes, written as Wavefront OBJ files.

numpy only. The port reads the files with its own ``assets.mesh.Mesh`` and
the JAX package with ``stillleben_tpu.assets.mesh.Mesh``, so both packages
load the very same geometry and nothing needs a download:

- ``cube``: the 24-vertex cube of ``primitive://cube`` (``primitive.py``:
  corners at +-1, per-face normals and uvs);
- ``sphere``: the 16 x 32 UV sphere of ``primitive://sphere``;
- ``blob``: a dense non-convex mesh, an icosphere subdivided ``subdiv``
  times (20 * 4^subdiv faces; 81,920 at 6) and displaced radially by
  seeded smooth noise. Load it with ``Mesh.Flag.PHYSICS_FORCE_CONVEX_HULL``
  so physics cooking makes one hull;
- ``blob_textured``: the same blob with uv coordinates (a spherical map of
  the vertex direction) and an MTL whose ``map_Kd`` names a seeded 256x256
  RGBA PNG, written with the port's own encoder (``assets/image.py``);
- ``cube_cutout``: the cube with an MTL whose ``map_Kd`` names a second
  seeded 256x256 PNG whose alpha channel dips under 0.5 in round holes
  (the alpha-cutoff and alpha-peel fixture).

``checker_texture`` and ``sky_equirect`` are the benchmark's background
plane texture and sky panorama (copies of ``bench.py:57-84``).

``write_loader_fixtures`` writes every other format the loaders read (glTF,
GLB, FBX, 3DS, .x, DAE, STL, OFF, a Radiance sky with an sIBL descriptor,
PNG variants) from these meshes, through ``writers.py``;
``write_image_fixtures`` the textured scene's images as JPEG and TGA, each
beside a PNG twin of its decoded pixels.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from .image import write_png
from .primitive import cube_arrays as _cube
from .primitive import uv_sphere_arrays as _uv_sphere


def _icosphere(subdiv: int):
    """Unit icosphere, outward (counter-clockwise) winding."""
    t = (1.0 + 5.0**0.5) / 2.0
    v = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
         [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        np.float64,
    )
    f = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
         [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
         [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
         [8, 6, 7], [9, 8, 1]],
        np.int64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.sort(edges, axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        mid = v[uniq[:, 0]] + v[uniq[:, 1]]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m = inv.reshape(-1) + len(v)
        nf = len(f)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[:nf], m[nf : 2 * nf], m[2 * nf :]
        f = np.concatenate(
            [np.stack(x, axis=1) for x in ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))]
        )
        v = np.concatenate([v, mid])
    return v, f


def _blob(subdiv: int, seed: int):
    """Icosphere displaced by a sum of seeded low-frequency waves."""
    v, f = _icosphere(subdiv)
    rng = np.random.default_rng(seed)
    r = np.ones(len(v))
    for _ in range(8):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        freq = rng.uniform(1.5, 4.0)
        r += 0.08 * np.sin(freq * (v @ d) * np.pi + rng.uniform(0, 2 * np.pi))
    return (v * r[:, None]).astype(np.float32), f


def _spherical_uv(positions: np.ndarray) -> np.ndarray:
    """uv from the vertex direction: u the azimuth, v the polar angle, both
    in [0, 1]. Vertices are shared, so the triangles that straddle the
    azimuth seam run through the whole texture width backwards (they wrap),
    as do the fans at the poles; harmless for a test fixture."""
    d = positions / np.maximum(np.linalg.norm(positions, axis=1, keepdims=True), 1e-12)
    u = np.arctan2(d[:, 1], d[:, 0]) / (2 * np.pi) + 0.5
    v = np.arccos(np.clip(d[:, 2], -1.0, 1.0)) / np.pi
    return np.stack([u, v], axis=1).astype(np.float32)


def base_color_texture(seed: int = 0, size: int = 256) -> np.ndarray:
    """Seeded opaque (size, size, 4) uint8 colour texture: three
    low-frequency waves per channel under a fine 32x32 board, so every mip
    level differs from the one above."""
    rng = np.random.default_rng(seed + 101)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    rgb = np.zeros((size, size, 3), np.float64)
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.integers(1, 5, size=2)
            ph = rng.uniform(0, 2 * np.pi)
            rgb[..., c] += np.sin(2 * np.pi * (fx * xx + fy * yy) / size + ph)
    rgb = 0.5 + rgb / 6.0 * 0.8
    board = ((yy // (size // 32) + xx // (size // 32)) % 2) * 0.2 - 0.1
    rgb = np.clip(rgb + board[..., None], 0.0, 1.0)
    out = np.empty((size, size, 4), np.uint8)
    out[..., :3] = np.round(rgb * 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def cutout_texture(seed: int = 0, size: int = 256) -> np.ndarray:
    """Seeded (size, size, 4) uint8 texture whose alpha is 40/255 inside a
    4x4 grid of round holes and 255 elsewhere: under the 0.5 cutoff in the
    holes."""
    out = base_color_texture(seed + 1, size)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // 4
    dy = (yy % cell) - cell / 2 + 0.5
    dx = (xx % cell) - cell / 2 + 0.5
    out[..., 3] = np.where(dx * dx + dy * dy < (0.3 * cell) ** 2, 40, 255).astype(np.uint8)
    return out


def checker_texture(size: int = 512, tiles: int = 8) -> np.ndarray:
    """The benchmark's uint8 board texture for the background plane."""
    t = size // tiles
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    board = ((yy // t + xx // t) % 2).astype(np.float32)
    rgb = (120 + 90 * board).astype(np.uint8)
    return np.stack([rgb, rgb // 2 + 60, np.full_like(rgb, 90), np.full_like(rgb, 255)], -1)


def sky_equirect(h: int = 64, w: int = 128) -> np.ndarray:
    """The benchmark's synthetic HDR sky, (h, w, 3) float32: a blue
    gradient and a warm sun blob."""
    v = np.linspace(0, np.pi, h, dtype=np.float32)[:, None]
    u = np.linspace(0, 2 * np.pi, w, dtype=np.float32)[None, :]
    sky = np.stack(
        [
            0.4 + 0.2 * np.cos(v) + 0 * u,
            0.5 + 0.3 * np.cos(v) + 0 * u,
            0.9 + 0.1 * np.cos(v) + 0 * u,
        ],
        -1,
    )
    sun = 40.0 * np.exp(-(((v - 0.9) / 0.08) ** 2 + ((u - 2.0) / 0.08) ** 2))
    sky[..., 0] += sun
    sky[..., 1] += 0.9 * sun
    sky[..., 2] += 0.7 * sun
    return sky.astype(np.float32)


def _write_mtl(path: str, name: str, texture_file: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(f"newmtl {name}\nKd 1 1 1\nmap_Kd {texture_file}\n")
    os.replace(tmp, path)


def _write_obj(path: str, positions, faces, normals=None, uvs=None, mtl=None) -> None:
    """``mtl``: (MTL file name, material name) for every face."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        if mtl is not None:
            fh.write(f"mtllib {mtl[0]}\nusemtl {mtl[1]}\n")
        np.savetxt(fh, positions, fmt="v %.9g %.9g %.9g")
        if normals is not None:
            np.savetxt(fh, normals, fmt="vn %.9g %.9g %.9g")
        if uvs is not None:
            # OBJ's v axis points up; the loader flips it back (objfile.py)
            np.savetxt(fh, np.stack([uvs[:, 0], 1.0 - uvs[:, 1]], 1), fmt="vt %.9g %.9g")
        idx = faces + 1
        if normals is not None and uvs is not None:
            corners = np.repeat(idx, 3, axis=1)  # v/vt/vn share the index
            np.savetxt(fh, corners, fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
        elif uvs is not None:
            np.savetxt(fh, np.repeat(idx, 2, axis=1), fmt="f %d/%d %d/%d %d/%d")
        else:
            np.savetxt(fh, idx, fmt="f %d %d %d")
    os.replace(tmp, path)


def write_meshes(directory: str, subdiv: int = 6, seed: int = 0) -> dict[str, str]:
    """Write the cube, sphere, blob, textured blob and cutout cube (OBJ,
    MTL and PNG files) into ``directory`` (kept if already there) and
    return the OBJ paths by name."""
    os.makedirs(directory, exist_ok=True)
    paths = {
        "cube": os.path.join(directory, "cube.obj"),
        "sphere": os.path.join(directory, "sphere_16x32.obj"),
        "blob": os.path.join(directory, f"blob_s{subdiv}_seed{seed}.obj"),
        "blob_textured": os.path.join(directory, f"blob_s{subdiv}_seed{seed}_textured.obj"),
        "cube_cutout": os.path.join(directory, f"cube_cutout_seed{seed}.obj"),
    }
    if not os.path.exists(paths["cube"]):
        p, n, uv, f = _cube()
        _write_obj(paths["cube"], p, f, n, uv)
    if not os.path.exists(paths["sphere"]):
        p, n, uv, f = _uv_sphere()
        _write_obj(paths["sphere"], p, f, n, uv)
    if not os.path.exists(paths["blob"]):
        p, f = _blob(subdiv, seed)
        _write_obj(paths["blob"], p, f)
    if not os.path.exists(paths["blob_textured"]):
        stem = f"blob_s{subdiv}_seed{seed}_textured"
        write_png(os.path.join(directory, f"blob_basecolor_seed{seed}.png"),
                  base_color_texture(seed))
        _write_mtl(os.path.join(directory, stem + ".mtl"), "blob",
                   f"blob_basecolor_seed{seed}.png")
        p, f = _blob(subdiv, seed)
        _write_obj(paths["blob_textured"], p, f, uvs=_spherical_uv(p), mtl=(stem + ".mtl", "blob"))
    if not os.path.exists(paths["cube_cutout"]):
        stem = f"cube_cutout_seed{seed}"
        write_png(os.path.join(directory, f"cutout_seed{seed}.png"), cutout_texture(seed))
        _write_mtl(os.path.join(directory, stem + ".mtl"), "cutout", f"cutout_seed{seed}.png")
        p, n, uv, f = _cube()
        _write_obj(paths["cube_cutout"], p, f, n, uv, mtl=(stem + ".mtl", "cutout"))
    return paths


# the sky's sun (bench.py:122-124) as an sIBL light: direction
# -(cos(v pi) sin t, sin(v pi) sin t, cos t), t = (u + 0.5) 2 pi
SKY_SUN_DIRECTION = np.array([0.3, 0.5, -0.8]) / np.linalg.norm([0.3, 0.5, -0.8])
SKY_SUN_MULTI, SKY_SUN_COLOR = 3.0, (255.0, 238.0, 212.5)


def _sun_uv(direction: np.ndarray) -> tuple[float, float]:
    pos = -np.asarray(direction, np.float64)
    theta = np.arccos(np.clip(pos[2], -1.0, 1.0))
    phi = np.arctan2(pos[1] / np.sin(theta), pos[0] / np.sin(theta))
    return float(theta / (2 * np.pi) - 0.5), float(phi / np.pi)


def _write_features_gltf(path: str) -> None:
    """A small glTF that reaches every parser path the blob does not: one
    ``data:`` URI buffer, an interleaved (strided) position/normal view, a
    sparse accessor moving one vertex, normalized u8 colours, a root node
    with translation / rotation / scale and a child with a matrix (no
    ``scenes``: the root is the node no other lists), a material with
    emissive, alpha mask, double sides and no metallic factor, and a
    palette PNG with tRNS as a ``data:`` URI image."""
    from .image import encode_png_samples
    from .writers import atomic_write, data_uri

    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    inter = np.concatenate([pos, nrm], axis=1).astype(np.float32).tobytes()  # stride 24
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16).tobytes()
    col = np.array([[255, 0, 0, 255], [0, 255, 0, 128], [0, 0, 255, 255], [255, 255, 255, 0]],
                   np.uint8).tobytes()
    sp_idx = np.array([2], np.uint16).tobytes() + b"\0\0"
    sp_val = np.array([[1.5, 1.25, 0.5]], np.float32).tobytes()
    blob = inter + idx + b"\0\0" + col + sp_idx + sp_val
    offs = np.cumsum([0, len(inter), len(idx) + 2, len(col), len(sp_idx)]).tolist()
    rng = np.random.default_rng(3)
    palette = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    png = encode_png_samples(rng.integers(0, 4, (8, 8)).astype(np.uint8), 3, 2, palette,
                             trns=bytes([255, 0, 128]), filter_type=4)
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob), "uri": data_uri(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offs[0], "byteLength": len(inter), "byteStride": 24},
            {"buffer": 0, "byteOffset": offs[1], "byteLength": len(idx)},
            {"buffer": 0, "byteOffset": offs[2], "byteLength": len(col)},
            {"buffer": 0, "byteOffset": offs[3], "byteLength": len(sp_idx)},
            {"buffer": 0, "byteOffset": offs[4], "byteLength": len(sp_val)},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "sparse": {"count": 1, "indices": {"bufferView": 3, "componentType": 5123},
                        "values": {"bufferView": 4}}},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5121, "normalized": True, "count": 4,
             "type": "VEC4"},
        ],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1, "COLOR_0": 3}, "indices": 2,
             "material": 0},
            {"attributes": {"POSITION": 0}, "indices": 2, "mode": 1},  # lines: skipped
        ]}],
        "materials": [{"name": "features", "emissiveFactor": [0.1, 0.2, 0.3],
                       "alphaMode": "MASK", "alphaCutoff": 0.3, "doubleSided": True,
                       "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 1.0],
                                                "roughnessFactor": 0.25,
                                                "baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"uri": data_uri(png, "image/png")}],
        "nodes": [
            {"name": "root", "translation": [0.5, -0.25, 1.0],
             "rotation": [0.0, 0.0, 0.38268343, 0.92387953], "scale": [2.0, 2.0, 2.0],
             "children": [1]},
            {"name": "child", "mesh": 0,
             "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0, 0.1, 0.2, 0.3, 1]},
        ],
    }
    atomic_write(path, json.dumps(doc))


def _png_variants(rng) -> dict[str, bytes]:
    """PNGs of every colour type and depth, with tRNS where the type takes
    one, plain and Adam7-interlaced, each filter in turn."""
    from .image import _PNG_TYPES, encode_png_samples

    out = {}
    k = 0
    for ctype, (channels, depths) in _PNG_TYPES.items():
        for depth in depths:
            for trns in (False, True):
                if trns and ctype in (4, 6):
                    continue
                for interlace in (False, True):
                    hi = (1 << depth) - 1
                    n = min(hi + 1, 256)
                    s = rng.integers(0, n if ctype == 3 else hi + 1, (19, 23, channels))
                    s = s.astype(np.uint16 if depth == 16 else np.uint8)
                    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8) if ctype == 3 else None
                    t = None
                    if trns and ctype == 3:
                        t = bytes(rng.integers(0, 256, max(1, n // 2), dtype=np.uint8))
                    elif trns:
                        key = s[5, 7, :channels]
                        t = struct.pack(">" + "H" * channels, *(int(v) for v in key))
                    name = f"png_c{ctype}_d{depth}{'_trns' if trns else ''}{'_adam7' if interlace else ''}"
                    out[name] = encode_png_samples(s, ctype, depth, palette, t, interlace, k % 5)
                    k += 1
    return out


def _ibl_text(ref_file: str, height: int, width: int) -> str:
    """An sIBL descriptor of ``ref_file`` with the bench's sun as ``[Sun]``."""
    u, v = _sun_uv(SKY_SUN_DIRECTION)
    return (
        "[Header]\nICOfile =\nPREVIEWfile =\nName = \"procedural sky\"\n\n"
        f"[Background]\nBGfile = \"{ref_file}\"\n\n"
        f"[Reflection]\nREFfile = \"{ref_file}\"\nREFmap = 1\nREFu = 0\nREFv = 0\n"
        f"REFheight = {height}\nREFwidth = {width}\n\n"
        f"[Sun]\nSUNcolor = {','.join(f'{c:g}' for c in SKY_SUN_COLOR)}\n"
        f"SUNmulti = {SKY_SUN_MULTI:g}\nSUNu = {u:.9g}\nSUNv = {v:.9g}\n"
    )


def sky_ldr(h: int = 128, w: int = 256) -> np.ndarray:
    """``sky_equirect`` as an 8-bit (h, w, 3) panorama: gamma 1/2.2, clipped."""
    return np.clip(sky_equirect(h, w) ** (1 / 2.2) * 255 + 0.5, 0, 255).astype(np.uint8)


def write_image_fixtures(directory: str, subdiv: int = 6, seed: int = 0) -> dict[str, str]:
    """The textured scene's images in the formats other than PNG, written by
    the port's encoders into ``directory`` (files kept if already there),
    each beside a twin that holds its decoded pixels as PNG. Paths by name:

    - ``obj_jpg``: the textured blob whose MTL names a JPEG of its base
      colour (quality 75, 4:2:0); ``obj_png``: the same blob whose MTL
      names the PNG of that JPEG's decode;
    - ``glb_jpeg``: the textured blob as GLB with the JPEG embedded
      (``image/jpeg``); ``glb_png``: with the PNG twin embedded;
    - ``plane_tga``: ``checker_texture`` as an RGB TGA;
    - ``sky_jpg``: ``sky_ldr`` as JPEG and ``ibl_jpg`` an sIBL descriptor
      naming it (with the bench's sun); ``ibl_png``: the descriptor of the
      PNG of its decode.
    """
    from .image import decode_image, encode_png
    from .jpeg import encode_jpeg
    from .objfile import load_obj
    from .tga import encode_tga
    from .writers import atomic_write, write_glb

    os.makedirs(directory, exist_ok=True)
    stem = f"blob_s{subdiv}_seed{seed}"
    names = {"obj_jpg": f"{stem}_jpg.obj", "obj_png": f"{stem}_jpgtwin.obj",
             "glb_jpeg": f"{stem}_jpeg.glb", "glb_png": f"{stem}_jpegtwin.glb",
             "plane_tga": "checker.tga", "sky_jpg": "sky.jpg", "ibl_jpg": "sky_jpg.ibl",
             "ibl_png": "sky_jpgtwin.ibl"}
    paths = {k: os.path.join(directory, v) for k, v in names.items()}
    if all(os.path.exists(v) for v in paths.values()):
        return paths
    jpg = encode_jpeg(base_color_texture(seed)[..., :3])
    twin = encode_png(decode_image(jpg)[..., :3])
    tex = {"jpg": f"blob_basecolor_seed{seed}.jpg", "png": f"blob_basecolor_seed{seed}_jpg.png"}
    atomic_write(os.path.join(directory, tex["jpg"]), jpg)
    atomic_write(os.path.join(directory, tex["png"]), twin)
    p, f = _blob(subdiv, seed)
    for key, kind in (("obj_jpg", "jpg"), ("obj_png", "png")):
        mtl = os.path.splitext(names[key])[0] + ".mtl"
        _write_mtl(os.path.join(directory, mtl), "blob", tex[kind])
        _write_obj(paths[key], p, f, uvs=_spherical_uv(p), mtl=(mtl, "blob"))
    blob = load_obj(paths["obj_png"]).meshes[0][0]
    write_glb(paths["glb_jpeg"], blob, jpg, mime="image/jpeg")
    write_glb(paths["glb_png"], blob, twin)
    atomic_write(paths["plane_tga"], encode_tga(checker_texture()[..., :3]))
    sky = encode_jpeg(sky_ldr())
    atomic_write(paths["sky_jpg"], sky)
    atomic_write(os.path.join(directory, "sky_jpg.png"), encode_png(decode_image(sky)[..., :3]))
    h, w = sky_ldr().shape[:2]
    atomic_write(paths["ibl_jpg"], _ibl_text("sky.jpg", h, w))
    atomic_write(paths["ibl_png"], _ibl_text("sky_jpg.png", h, w))
    return paths


def write_webp_fixtures(directory: str, subdiv: int = 6) -> dict[str, str]:
    """``write_image_fixtures``'s scene with WebP in place of JPEG and TGA,
    from the committed WebP files that Pillow wrote (``image_fixtures``;
    the base colour of seed 0), each beside a twin that holds its decoded
    pixels as PNG. Paths by name:

    - ``obj_webp``: the textured blob whose MTL names the lossy WebP of its
      base colour; ``obj_png``: the same blob whose MTL names the PNG of
      that WebP's decode;
    - ``glb_webp``: the textured blob as GLB with the WebP embedded
      (``image/webp``); ``glb_png``: with the PNG twin embedded;
    - ``plane_webp``: ``checker_texture`` as a lossless WebP;
    - ``ibl_webp``: an sIBL descriptor whose panorama is ``sky_ldr`` as a
      lossy WebP (read through ``read_image_cv2``, as OpenCV reads it);
      ``ibl_bmp``: the descriptor of a BMP of its decode. The twin is a BMP,
      not a PNG: the light map's loader (the JAX package's
      ``_load_hdr_image``) linearises an 8-bit panorama only when its name
      ends in .png, .jpg or .jpeg, so a WebP's (or a BMP's) 0-255 values
      are taken as they are.
    """
    import shutil

    from . import image_fixtures
    from .bmp import encode_bmp
    from .image import decode_image, encode_png, read_image_cv2
    from .objfile import load_obj
    from .writers import atomic_write, write_glb

    os.makedirs(directory, exist_ok=True)
    stem = f"blob_s{subdiv}_seed0"
    names = {"obj_webp": f"{stem}_webp.obj", "obj_png": f"{stem}_webptwin.obj",
             "glb_webp": f"{stem}_webp.glb", "glb_png": f"{stem}_webptwin.glb",
             "plane_webp": "checker.webp", "ibl_webp": "sky_webp.ibl",
             "ibl_bmp": "sky_webptwin.ibl"}
    paths = {k: os.path.join(directory, v) for k, v in names.items()}
    if all(os.path.exists(v) for v in paths.values()):
        return paths
    for name in ("blob_basecolor.webp", "checker.webp", "sky.webp"):
        shutil.copyfile(image_fixtures.path(name), os.path.join(directory, name))
    with open(image_fixtures.path("blob_basecolor.webp"), "rb") as f:
        webp = f.read()
    twin = encode_png(decode_image(webp, "blob_basecolor.webp")[..., :3])
    tex = {"webp": "blob_basecolor.webp", "png": "blob_basecolor_webp.png"}
    atomic_write(os.path.join(directory, tex["png"]), twin)
    p, f = _blob(subdiv, 0)
    for key, kind in (("obj_webp", "webp"), ("obj_png", "png")):
        mtl = os.path.splitext(names[key])[0] + ".mtl"
        _write_mtl(os.path.join(directory, mtl), "blob", tex[kind])
        _write_obj(paths[key], p, f, uvs=_spherical_uv(p), mtl=(mtl, "blob"))
    blob = load_obj(paths["obj_png"]).meshes[0][0]
    write_glb(paths["glb_webp"], blob, webp, mime="image/webp")
    write_glb(paths["glb_png"], blob, twin)
    sky = read_image_cv2(os.path.join(directory, "sky.webp"))
    atomic_write(os.path.join(directory, "sky_webp.bmp"), encode_bmp(sky[..., ::-1].copy()))
    h, w = sky.shape[:2]
    atomic_write(paths["ibl_webp"], _ibl_text("sky.webp", h, w))
    atomic_write(paths["ibl_bmp"], _ibl_text("sky_webp.bmp", h, w))
    return paths


def write_jpeg_variant_fixtures(directory: str, subdiv: int = 6) -> dict[str, str]:
    """``write_image_fixtures``'s scene with its images as the JPEG variants
    the port reads since Pillow and OpenCV do (the committed files of
    ``image_fixtures``, which libjpeg-turbo and Pillow wrote), each beside a
    twin that holds its decoded pixels as PNG. Paths by name:

    - ``obj_arith``: the textured blob whose MTL names its base colour as an
      arithmetic-coded progressive JPEG; ``obj_png``: the same blob whose MTL
      names the PNG of that file's decode;
    - ``glb_cmyk``: the textured blob as GLB with the base colour embedded as
      an Adobe CMYK JPEG (``image/jpeg``); ``glb_png``: with its PNG twin;
    - ``plane_lossless``: ``checker_texture`` as a lossless JPEG (SOF3);
      ``plane_png``: its decode as PNG;
    - ``ibl_ycck``: an sIBL descriptor whose panorama is ``sky_ldr`` as a
      YCCK JPEG (read as OpenCV reads it: CMYK to BGR); ``ibl_png``: the
      descriptor of a PNG of that reading (a PNG is linearised as a JPEG
      is, so the two panoramas are the same floats).
    """
    import shutil

    from . import image_fixtures
    from .image import decode_image, encode_png, read_image_cv2
    from .objfile import load_obj
    from .writers import atomic_write, write_glb

    os.makedirs(directory, exist_ok=True)
    stem = f"blob_s{subdiv}_seed0"
    names = {"obj_arith": f"{stem}_arith.obj", "obj_png": f"{stem}_arithtwin.obj",
             "glb_cmyk": f"{stem}_cmyk.glb", "glb_png": f"{stem}_cmyktwin.glb",
             "plane_lossless": "checker_lossless.jpg", "plane_png": "checker_lossless.png",
             "ibl_ycck": "sky_ycck.ibl", "ibl_png": "sky_ycck_twin.ibl"}
    paths = {k: os.path.join(directory, v) for k, v in names.items()}
    if all(os.path.exists(v) for v in paths.values()):
        return paths
    for name in ("blob_arith.jpg", "checker_lossless.jpg", "sky_ycck.jpg"):
        shutil.copyfile(image_fixtures.path(name), os.path.join(directory, name))

    def twin(name):
        with open(image_fixtures.path(name), "rb") as f:
            data = f.read()
        return data, encode_png(decode_image(data, name)[..., :3])

    arith, arith_png = twin("blob_arith.jpg")
    cmyk, cmyk_png = twin("blob_cmyk.jpg")
    atomic_write(os.path.join(directory, "blob_arith.png"), arith_png)
    atomic_write(paths["plane_png"], twin("checker_lossless.jpg")[1])
    p, f = _blob(subdiv, 0)
    for key, tex in (("obj_arith", "blob_arith.jpg"), ("obj_png", "blob_arith.png")):
        mtl = os.path.splitext(names[key])[0] + ".mtl"
        _write_mtl(os.path.join(directory, mtl), "blob", tex)
        _write_obj(paths[key], p, f, uvs=_spherical_uv(p), mtl=(mtl, "blob"))
    blob = load_obj(paths["obj_png"]).meshes[0][0]
    write_glb(paths["glb_cmyk"], blob, cmyk, mime="image/jpeg")
    write_glb(paths["glb_png"], blob, cmyk_png)
    sky = read_image_cv2(os.path.join(directory, "sky_ycck.jpg"))
    atomic_write(os.path.join(directory, "sky_ycck.png"), encode_png(sky[..., ::-1].copy()))
    h, w = sky.shape[:2]
    atomic_write(paths["ibl_ycck"], _ibl_text("sky_ycck.jpg", h, w))
    atomic_write(paths["ibl_png"], _ibl_text("sky_ycck.png", h, w))
    return paths


def write_loader_fixtures(directory: str, subdiv: int = 6, seed: int = 0) -> dict[str, str]:
    """Write every format the loaders read into ``directory`` (files kept
    if already there) and return their paths by name. Each mesh is the
    procedural OBJ's document as the port's ``load_obj`` reads it, so the
    other formats hold the same positions and faces:

    - ``glb``: the textured blob (20 * 4^subdiv faces) with its PNG
      embedded; ``gltf``: the same as ``.gltf`` with an external ``.bin``
      (a name with a space, ``%``-escaped in the URI) and the PNG beside it;
      ``features_gltf``: the small glTF of ``_write_features_gltf``;
    - ``fbx`` (binary 7.4), ``fbx_7500`` (binary 7.5, 64-bit offsets,
      deflated arrays), ``fbx_ascii``, ``3ds`` and ``x``: the cube;
    - ``dae`` (textured), ``stl``, ``stl_ascii`` and ``off``: the sphere;
    - ``hdr``: the sky panorama, run-length Radiance; ``ibl``: an sIBL
      descriptor of it with the bench's sun as ``[Sun]``;
    - ``png_c<type>_d<depth>[_trns][_adam7]``: the codec's PNG variants.
    """
    from .image import encode_hdr
    from .objfile import load_obj
    from .writers import (
        atomic_write, write_3ds, write_dae, write_fbx_ascii, write_fbx_binary, write_glb,
        write_gltf, write_off, write_stl, write_x,
    )

    objs = write_meshes(directory, subdiv=subdiv, seed=seed)
    stem = f"blob_s{subdiv}_seed{seed}"
    tex = f"blob_basecolor_seed{seed}.png"
    paths = {
        "glb": f"{stem}.glb", "gltf": f"{stem}.gltf", "features_gltf": "features.gltf",
        "fbx": "cube.fbx", "fbx_7500": "cube_7500.fbx", "fbx_ascii": "cube_ascii.fbx",
        "3ds": "cube.3ds", "x": "cube.x", "dae": "sphere.dae", "stl": "sphere.stl",
        "stl_ascii": "sphere_ascii.stl", "off": "sphere.off", "hdr": "sky.hdr", "ibl": "sky.ibl",
    }
    paths = {k: os.path.join(directory, v) for k, v in paths.items()}
    missing = {k for k, v in paths.items() if not os.path.exists(v)}
    if missing & {"glb", "gltf"}:
        blob = load_obj(objs["blob_textured"]).meshes[0][0]
        with open(os.path.join(directory, tex), "rb") as f:
            png = f.read()
        write_glb(paths["glb"], blob, png)
        write_gltf(paths["gltf"], blob, f"{stem} buffer.bin", image_uri=tex)
    if "features_gltf" in missing:
        _write_features_gltf(paths["features_gltf"])
    if missing & {"fbx", "fbx_7500", "fbx_ascii", "3ds", "x"}:
        cube = load_obj(objs["cube"]).meshes[0][0]
        write_fbx_binary(paths["fbx"], cube, version=7400)
        write_fbx_binary(paths["fbx_7500"], cube, version=7500, compress=True)
        write_fbx_ascii(paths["fbx_ascii"], cube)
        write_3ds(paths["3ds"], cube, "cube")
        write_x(paths["x"], cube, "cube")
    if missing & {"dae", "stl", "stl_ascii", "off"}:
        sphere = load_obj(objs["sphere"]).meshes[0][0]
        write_dae(paths["dae"], sphere, image_file=tex)
        write_stl(paths["stl"], sphere)
        write_stl(paths["stl_ascii"], sphere, ascii=True)
        write_off(paths["off"], sphere)
    if missing & {"hdr", "ibl"}:
        atomic_write(paths["hdr"], encode_hdr(sky_equirect(), rle=True))
        atomic_write(paths["ibl"], _ibl_text("sky.hdr", 64, 128))
    rng = np.random.default_rng(seed + 17)
    for name, data in _png_variants(rng).items():
        p = paths[name] = os.path.join(directory, name + ".png")
        if not os.path.exists(p):
            atomic_write(p, data)
    return paths
