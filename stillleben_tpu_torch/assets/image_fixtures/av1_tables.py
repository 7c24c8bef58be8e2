"""The AV1 decoder's tables beyond the 8-bit ones, taken from two installed
libraries: ``csrc/sl_av1_tables_hbd.h``.

The specification's ``Dc_Qlookup`` and ``Ac_Qlookup`` of 10- and 12-bit
samples, its ``Quantizer_Matrix`` (15 levels, luma and chroma, 3344 weights
each: every transform size, the 64-sized ones reusing the 32-sized entries)
and the film grain's ``Gaussian_Sequence`` lie in Pillow 12.1.0's bundled
libavif 1.3.0 (its aom and dav1d) and in OpenCV 5.0.0's bundled aom 3.14.1.
This module reads them at their offsets in both files, checks that the two
copies agree, that each table starts and ends where the specification's
does, and that the bytes beside each belong to another table, and writes the
header. The header is committed: the port's decoder never reads a library.

    python -m stillleben_tpu_torch.assets.image_fixtures.av1_tables [--check]

``--check`` compares the committed header with what the libraries give
instead of writing it.

The weights are stored as aom stores them: the matrix of a transform of
width w and height h as w rows of h weights (the transpose of the
coefficients' order for a rectangular size; square ones are symmetric). The
check below holds every rectangular matrix to that layout: its weights vary
more smoothly as w rows of h than as h rows of w.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "csrc", "sl_av1_tables_hbd.h")

# (package whose wheel bundles the library, folder beside it, file name)
LIBAVIF = ("PIL", "pillow.libs", "libavif-01e67780.so.16.3.0")
LIBAOM = ("cv2", "opencv_python.libs", "libaom-a0d22147.so.3.14.1")

# the SHA-256 of the committed header (the tests and the card's smoke hold it)
HEADER_SHA256 = "917c125966abbd0369393a65f411e0284a80256c9a4cafdd46d894da2f934c71"

QM_LEVELS, QM_SIZE = 15, 3344
# byte offsets: the inverse weights; then the lookups, int16 little-endian,
# 256 entries each; then the Gaussian sequence (int16 in libavif, int32 in
# aom)
OFFSETS = {
    "libavif": {"qm": 4078880, "dc10": 4422528, "dc12": 4422016, "ac10": 4424896,
                "ac12": 4424384, "gauss": 4651456},
    "libaom": {"qm": 6668512, "dc10": 6871200, "dc12": 6870688, "ac10": 6869664,
               "ac12": 6869152, "gauss": 6939904},
}

# the transform sizes in the specification's order (TX_4X4 .. TX_64X16) as
# (width, height), and the size of each whose weights it reads
TX_SIZES = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
            (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
            (16, 64), (64, 16))
# the specification's probes: the first weights of level 0 (luma, chroma)
# and level 1 (luma) of the 4x4 transform; the first and last entries of
# each lookup and of the Gaussian sequence
PROBES = {
    "qm0y": (32, 43, 73, 97, 43, 67, 94, 110), "qm0uv": (35, 46, 57, 66, 46, 60, 69, 71),
    "qm1y": (32, 41, 69, 92, 41, 63, 88, 103),
    "dc10": ((4, 9, 10, 13, 15, 17), (4929, 5130, 5347)),
    "dc12": ((4, 12, 18, 25, 33, 41), (19718, 20521, 21387)),
    "ac10": ((4, 9, 11, 13, 16, 18), (7036, 7172, 7312)),
    "ac12": ((4, 13, 19, 27, 35, 44), (28143, 28687, 29247)),
    "gauss": ((56, 568, -180, 172, 124, -84), (288, 944, 428, -484)),
}


def adjusted(w: int, h: int) -> tuple[int, int]:
    """A transform's size as its weights are stored (64 reads 32)."""
    return min(w, 32), min(h, 32)


def qm_offsets() -> list[int]:
    """``Qm_Offset``: where each transform size's weights start in a level's
    3344, the distinct adjusted sizes in their first order."""
    starts: dict[tuple[int, int], int] = {}
    pos = 0
    for w, h in TX_SIZES:
        a = adjusted(w, h)
        if a not in starts:
            starts[a] = pos
            pos += a[0] * a[1]
    assert pos == QM_SIZE
    return [starts[adjusted(w, h)] for w, h in TX_SIZES]


def library_path(lib: tuple[str, str, str]) -> str:
    """The library's path beside its package, found without importing it."""
    spec = importlib.util.find_spec(lib[0])
    if spec is None or not spec.submodule_search_locations:
        raise FileNotFoundError(f"{lib[0]} is not installed")
    path = os.path.join(os.path.dirname(list(spec.submodule_search_locations)[0]), lib[1], lib[2])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _roughness(m: np.ndarray) -> int:
    return int(np.abs(np.diff(m, axis=0)).sum() + np.abs(np.diff(m, axis=1)).sum())


def _check_qm(qm: np.ndarray, after: np.ndarray) -> None:
    assert tuple(qm[0, 0, :8]) == PROBES["qm0y"] and tuple(qm[0, 1, :8]) == PROBES["qm0uv"]
    assert tuple(qm[1, 0, :8]) == PROBES["qm1y"]
    # the bytes after the span are aom's forward weights, each near 1024 /
    # its inverse: no sixteenth level
    product = qm.astype(np.int32) * after.astype(np.int32)
    assert 900 <= product.min() and product.max() <= 1130, (product.min(), product.max())
    offsets = qm_offsets()
    for level in range(QM_LEVELS):
        for plane in range(2):
            for (w, h), off in zip(TX_SIZES, offsets):
                aw, ah = adjusted(w, h)
                m = qm[level, plane, off:off + aw * ah].astype(np.int32)
                assert 30 <= m.min(), (level, plane, w, h)
                stored = m.reshape(aw, ah)  # w rows of h
                if aw == ah:
                    assert (stored == stored.T).all(), (level, plane, w, h)
                else:  # at the flattest levels the two readings may tie
                    r, r_t = _roughness(stored), _roughness(m.reshape(ah, aw))
                    assert r < r_t or (level > 0 and r == r_t), (level, plane, w, h)
    # the levels run from the steepest to the flattest
    spread = [int(qm[level, 0].max()) for level in range(QM_LEVELS)]
    assert spread == sorted(spread, reverse=True), spread


def _check_lookup(name: str, t: np.ndarray, after: np.ndarray) -> None:
    head, tail = PROBES[name]
    assert tuple(t[:len(head)]) == head and tuple(t[-len(tail):]) == tail, name
    assert (np.diff(t.astype(np.int32)) >= 0).all(), name
    # the next table starts over at 4
    assert after[0] == 4 and after[0] < t[-1], name


def read_tables() -> dict[str, np.ndarray]:
    """The tables from both libraries, checked; each as its libavif copy."""
    data = {"libavif": open(library_path(LIBAVIF), "rb").read(),
            "libaom": open(library_path(LIBAOM), "rb").read()}
    out: dict[str, np.ndarray] = {}
    per_lib: dict[str, dict[str, np.ndarray]] = {}
    n_qm = QM_LEVELS * 2 * QM_SIZE
    for lib, b in data.items():
        o = OFFSETS[lib]
        t = {"qm": np.frombuffer(b, np.uint8, n_qm, o["qm"]).reshape(QM_LEVELS, 2, QM_SIZE),
             "qm_after": np.frombuffer(b, np.uint8, n_qm, o["qm"] + n_qm).reshape(QM_LEVELS, 2,
                                                                                   QM_SIZE)}
        for k in ("dc10", "dc12", "ac10", "ac12"):
            t[k] = np.frombuffer(b, "<i2", 256, o[k])
            t[k + "_after"] = np.frombuffer(b, "<i2", 4, o[k] + 512)
        gdt = "<i2" if lib == "libavif" else "<i4"
        t["gauss"] = np.frombuffer(b, gdt, 2048, o["gauss"]).astype(np.int16)
        per_lib[lib] = t
    a, b = per_lib["libavif"], per_lib["libaom"]
    for k in ("qm", "dc10", "dc12", "ac10", "ac12", "gauss"):
        assert np.array_equal(a[k], b[k]), f"the two copies of {k} differ"
    for t in (a, b):
        _check_qm(t["qm"], t["qm_after"])
        for k in ("dc10", "dc12", "ac10", "ac12"):
            _check_lookup(k, t[k], t[k + "_after"])
        g = t["gauss"]
        head, tail = PROBES["gauss"]
        assert tuple(g[:6]) == head and tuple(g[-4:]) == tail
        assert -2048 <= g.min() and g.max() < 2048
    for k in ("qm", "dc10", "dc12", "ac10", "ac12", "gauss"):
        out[k] = a[k]
    return out


def _rows(values, per_row: int) -> str:
    vals = [str(int(v)) for v in np.asarray(values).ravel()]
    return ",\n".join("  " + ",".join(vals[i:i + per_row]) for i in range(0, len(vals), per_row))


def header_text(tables: dict[str, np.ndarray]) -> str:
    qm_lines = []
    for level in range(QM_LEVELS):
        for plane in range(2):
            qm_lines.append(f"  // level {level}, {'luma' if plane == 0 else 'chroma'}\n"
                            + _rows(tables["qm"][level, plane], 32))
    offsets = ", ".join(str(o) for o in qm_offsets())
    return (
        "// The AV1 specification's tables of 10- and 12-bit samples, quantizer\n"
        "// matrices and film grain, for the port's AV1 decoder (sl_av1.cpp).\n"
        "// Written by stillleben_tpu_torch/assets/image_fixtures/av1_tables.py from\n"
        f"// {LIBAVIF[2]} and {LIBAOM[2]}, whose copies agree;\n"
        "// do not edit.\n"
        "//\n"
        "// Quantizer_Matrix[level][plane > 0] holds a transform of width w and\n"
        "// height h (at most 32 each) from Qm_Offset[txSz] as w rows of h weights.\n\n"
        "#pragma once\n\n#include <stdint.h>\n\n"
        "// [0]: 10-bit samples, [1]: 12-bit\n"
        "static const int16_t Dc_Qlookup_Hbd[2][256] = {{\n"
        + _rows(tables["dc10"], 16) + "\n}, {\n" + _rows(tables["dc12"], 16) + "\n}};\n"
        "static const int16_t Ac_Qlookup_Hbd[2][256] = {{\n"
        + _rows(tables["ac10"], 16) + "\n}, {\n" + _rows(tables["ac12"], 16) + "\n}};\n\n"
        f"static const uint16_t Qm_Offset[19] = {{{offsets}}};\n"
        f"static const uint8_t Quantizer_Matrix[{QM_LEVELS}][2][{QM_SIZE}] = {{\n"
        + ",\n".join("{{\n" + qm_lines[2 * lv] + "\n}, {\n" + qm_lines[2 * lv + 1] + "\n}}"
                     for lv in range(QM_LEVELS))
        + "\n};\n\n"
        "static const int16_t Gaussian_Sequence[2048] = {\n" + _rows(tables["gauss"], 16)
        + "\n};\n")


def digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    text = header_text(read_tables())
    if "--check" in argv:
        with open(HEADER) as f:
            same = f.read() == text
        print("the header matches the libraries" if same else "the header differs")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(HEADER, digest(text))
    return 0


if __name__ == "__main__":
    sys.exit(main())
