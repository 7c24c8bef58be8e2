"""Build and load the port's CUDA sources (``csrc/*.cu``) for sm_90a.

Each source has a plain C entry point; it is compiled by nvcc into its own
shared library under the gitignored ``_build/`` at first use and loaded
with ctypes. The library name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt;
the compile writes a temporary file and renames it into place.
``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("smoke.cu", "cell_raster.cu", "fine_raster.cu")

_loaded: dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return nvcc


def build(source: str) -> tuple[str, str]:
    """Compile ``csrc/<source>``; returns (library path, compiler output)."""
    path = os.path.join(CSRC, source)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, "(cached build)"
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, path]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, log


def build_all(sources=SOURCES) -> dict[str, tuple[str, str]]:
    """Build every source at once (one nvcc process each)."""
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        return dict(zip(sources, ex.map(build, sources)))


def load(source: str, symbol: str, argtypes) -> ctypes.CDLL:
    """Build (if needed) and load ``source``, typing its entry point
    ``symbol`` (returns a cudaError_t as int); cached per process."""
    if source not in _loaded:
        lib = ctypes.CDLL(build(source)[0])
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[source] = lib
    return _loaded[source]


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
