"""ctypes binding of the port's native convex decomposer (``csrc/sl_decompose.cpp``).

Counterpart of ``stillleben_tpu/assets/native_decompose.py`` over the
port's own copy of the source, built at first use with the JAX binding's
command by ``native_build.build_library`` (into the gitignored ``_build/``,
named by a hash of the source; a compile or load that fails raises with
the compiler's message: there is no fallback).
``decompose_native`` returns the same hull dicts as the JAX binding.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .native_build import BUILD_DIR, PKG_DIR, build_library

MAX_HULL_VERTS = 64
MAX_HULL_PLANES = 64

SOURCE = os.path.join(PKG_DIR, "csrc", "sl_decompose.cpp")
HEADER = os.path.join(PKG_DIR, "csrc", "sl_decompose.h")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> str:
    """Compile the source if this version is not built yet; returns the
    library's path. Raises ``RuntimeError`` with the compiler's output."""
    return build_library("sl_decompose", SOURCE, HEADER, BUILD_DIR, "the native convex decomposer")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.sl_decompose.restype = ctypes.c_int
            _lib = lib
        return _lib


def decompose_native(
    vertices: np.ndarray,
    faces: np.ndarray,
    concavity: float,
    max_hulls: int = 32,
    resolution: int = 48,
    force_single_hull: bool = False,
):
    """A list of dicts (vertices / planes / volume / center_of_mass /
    inertia), or None when the decomposer makes no hull of this mesh (it
    refuses fewer than 4 vertices, no triangles, or a flat point set)."""
    lib = load_library()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    mh = max_hulls
    out_verts = np.zeros((mh, MAX_HULL_VERTS, 3), np.float32)
    out_vc = np.zeros(mh, np.int32)
    out_planes = np.zeros((mh, MAX_HULL_PLANES, 4), np.float32)
    out_pc = np.zeros(mh, np.int32)
    out_vol = np.zeros(mh, np.float32)
    out_com = np.zeros((mh, 3), np.float32)
    out_inertia = np.zeros((mh, 3, 3), np.float32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.sl_decompose(
        ptr(v, ctypes.c_float), ctypes.c_int(v.shape[0]),
        ptr(f, ctypes.c_int), ctypes.c_int(f.shape[0]),
        ctypes.c_float(concavity), ctypes.c_int(mh), ctypes.c_int(resolution),
        ctypes.c_int(1 if force_single_hull else 0),
        ctypes.c_int(MAX_HULL_VERTS), ctypes.c_int(MAX_HULL_PLANES),
        ptr(out_verts, ctypes.c_float), ptr(out_vc, ctypes.c_int),
        ptr(out_planes, ctypes.c_float), ptr(out_pc, ctypes.c_int),
        ptr(out_vol, ctypes.c_float), ptr(out_com, ctypes.c_float),
        ptr(out_inertia, ctypes.c_float),
    )
    if n <= 0:
        return None
    hulls = []
    for i in range(n):
        nv, npl = int(out_vc[i]), int(out_pc[i])
        if nv < 4 or npl < 4:
            continue
        hulls.append(dict(
            vertices=out_verts[i, :nv].copy(),
            planes=out_planes[i, :npl].copy(),
            volume=float(out_vol[i]),
            center_of_mass=out_com[i].copy(),
            inertia=out_inertia[i].copy(),
        ))
    return hulls or None
