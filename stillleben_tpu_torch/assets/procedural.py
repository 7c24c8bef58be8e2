"""Procedural test and benchmark meshes, written as Wavefront OBJ files.

numpy only. The port reads the files with its own ``assets.mesh.Mesh`` and
the JAX package with ``stillleben_tpu.assets.mesh.Mesh``, so both packages
load the very same geometry and nothing needs a download:

- ``cube``: the 24-vertex cube of ``stillleben_tpu/assets/primitive.py:18``
  (corners at +-1, per-face normals and uvs);
- ``sphere``: the 16 x 32 UV sphere of ``primitive.py:48``;
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
"""

from __future__ import annotations

import os

import numpy as np

from .image import write_png


def _cube():
    positions, normals, uvs, faces = [], [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u_axis, v_axis = (axis + 1) % 3, (axis + 2) % 3
            base = len(positions)
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = n.copy()
                p[u_axis] = du * sign
                p[v_axis] = dv
                positions.append(p)
                normals.append(n)
                uvs.append([(du + 1) / 2, (dv + 1) / 2])
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.array(positions, np.float32), np.array(normals, np.float32),
            np.array(uvs, np.float32), np.array(faces, np.int64))


def _uv_sphere(rings: int = 16, segments: int = 32):
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    seg_t = np.linspace(0.0, 2 * np.pi, segments + 1)
    tt, pp = np.meshgrid(ring_t, seg_t, indexing="ij")
    positions = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], axis=-1).reshape(-1, 2).astype(np.float32)
    faces = []
    for r in range(rings):
        for s in range(segments):
            a = r * (segments + 1) + s
            b = a + segments + 1
            faces += [[a, b, a + 1], [a + 1, b, b + 1]]
    return positions, positions.copy(), uv, np.array(faces, np.int64)


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
