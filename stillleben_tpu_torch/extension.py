"""User-extension helper (reference python/stillleben/extension.py).

Counterpart of ``stillleben_tpu/extension.py``. The reference wraps
torch.utils.cpp_extension.load with stillleben's include paths so users can
JIT C++ extensions against libstillleben. Here native host helpers build
against the port's own headers in ``stillleben_tpu_torch/csrc/``
(``sl_decompose.h``, with its source ``sl_decompose.cpp`` beside it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def include_paths() -> list[str]:
    """Include directories for building native helpers against this package."""
    return [os.path.join(_PKG_DIR, "csrc")]


def load(name: str, sources: list[str], extra_cflags=None, **kwargs):
    """Build + load a C extension as a shared object and return its
    ``ctypes.CDLL`` handle (the reference's ``cpp_extension.load``): the
    sources compiled by g++ with ``include_paths()`` into the gitignored
    ``_build/``, under a name that carries a hash of the sources, the
    headers and the flags (an edited source is rebuilt and loaded anew).
    Raises ``RuntimeError`` with the compiler's output when g++ fails."""
    flags = list(CXX_FLAGS) + [f"-I{p}" for p in include_paths()] + list(extra_cflags or [])
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(os.path.join(d, f) for d in include_paths() for f in os.listdir(d)
                     if f.endswith((".h", ".cuh")))
    for path in list(sources) + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        cmd = ["g++", *flags, *sources, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"cannot build extension {name!r} (g++ exited "
                                   f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(out)
