"""The g++ build of the port's native host libraries (``csrc/*.cpp``).

A library is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into the gitignored ``_build/``. Its name carries a hash of
the source, the headers it includes and the flags, and the compile writes
a temporary file that is renamed into place, so concurrent processes can
build at once. A compile that fails raises ``RuntimeError`` with the compiler's
message: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


def build_library(stem: str, source: str | tuple[str, ...], headers: str | tuple[str, ...],
                  build_dir: str, what: str) -> str:
    """Compile ``source`` (one file, or every file linked into the library)
    into ``build_dir/lib<stem>_<hash>.so`` unless that version is built
    already; returns the library's path. ``headers``: the header, or every
    header, the sources include from the package."""
    sources = (source,) if isinstance(source, str) else tuple(source)
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for path in (*sources, *((headers,) if isinstance(headers, str) else headers)):
        with open(path, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so")
    os.close(fd)
    cmd = [CXX, *CXX_FLAGS, *sources, "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot build {what}: {' '.join(cmd)}: {e}")
        if proc.returncode != 0:
            raise RuntimeError(
                f"cannot build {what} ({CXX} exited {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path
