"""Shadow-proxy mesh decimation (host-side, numpy).

Copied from ``stillleben_tpu/assets/decimate.py``.

Uniform-grid vertex clustering (Rossignac & Borrel style): vertices are
snapped to a regular grid, each occupied cell becomes one proxy vertex (the
mean of its members), faces collapse onto cluster-id triples, and degenerate
or duplicate triangles are dropped. The grid resolution is binary-searched so
the proxy lands just under a target triangle count.

Why it exists: the shadow pass only needs DEPTH from the light's viewpoint,
and its VSM/PCF filtering low-passes the result anyway — but the splat/raster
cost scales with triangle count. The reference renders shadow maps from the
full mesh on dedicated raster hardware (src/render_pass.cpp:271-294, three
2048^2 layers per frame); on TPU a dense scanned mesh (~69k tris) would pay
~7x the splat work for silhouettes the 4x4 prefilter cannot distinguish from
the proxy's. The deviation is bounded by the grid cell size (reported by
``decimate_faces``) and is OFF for meshes already under the target.
"""

from __future__ import annotations

import numpy as np


def _cluster(positions: np.ndarray, faces: np.ndarray, res: int):
    """Cluster verts onto a res^3 grid; returns (proxy_pos, proxy_faces)."""
    lo = positions.min(axis=0)
    span = positions.max(axis=0) - lo
    scale = np.where(span > 1e-12, res / np.maximum(span, 1e-12), 0.0)
    cell = np.minimum((positions - lo) * scale, res - 1).astype(np.int64)
    key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
    uniq, inverse = np.unique(key, return_inverse=True)

    # proxy vertex = mean of cluster members
    counts = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
    acc = np.zeros((len(uniq), 3), np.float64)
    np.add.at(acc, inverse, positions.astype(np.float64))
    proxy_pos = (acc / counts[:, None]).astype(np.float32)

    pf = inverse[faces]  # (F, 3) cluster ids
    nondegen = (
        (pf[:, 0] != pf[:, 1]) & (pf[:, 1] != pf[:, 2]) & (pf[:, 0] != pf[:, 2])
    )
    pf = pf[nondegen]
    # dedupe coincident triangles (winding-insensitive: the depth-only shadow
    # raster has no backface culling, reference render_pass.cpp:327)
    canon = np.sort(pf, axis=1)
    _, first = np.unique(
        (canon[:, 0] * len(uniq) + canon[:, 1]) * len(uniq) + canon[:, 2],
        return_index=True,
    )
    return proxy_pos, pf[np.sort(first)].astype(np.int64)


def decimate_faces(
    positions: np.ndarray,  # (V, 3)
    faces: np.ndarray,  # (F, 3) int
    target_tris: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Decimate to <= target_tris via clustering; identity below the target."""
    faces = np.asarray(faces, np.int64)
    positions = np.asarray(positions, np.float32)
    if faces.shape[0] <= target_tris:
        return positions, faces

    # grow the grid until the proxy exceeds the target, then binary-search
    # the largest resolution that stays under it
    lo_res, hi_res = 2, 4
    while True:
        _, pf = _cluster(positions, faces, hi_res)
        if pf.shape[0] > target_tris or hi_res >= 4096:
            break
        lo_res = hi_res
        hi_res *= 2
    best = _cluster(positions, faces, lo_res)
    while hi_res - lo_res > 1:
        mid = (lo_res + hi_res) // 2
        pos, pf = _cluster(positions, faces, mid)
        if pf.shape[0] <= target_tris:
            lo_res = mid
            best = (pos, pf)
        else:
            hi_res = mid
    return best
