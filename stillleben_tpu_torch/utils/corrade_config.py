"""Corrade::Utility::Configuration text format (reader/writer).

The port's own copy of ``stillleben_tpu/utils/corrade_config.py`` (numpy
only), so scene files written by either package read in the other.

The reference serializes scenes with Corrade's Configuration framework
(reference src/scene.cpp:761-869; format documented at
include/stillleben/scene.h:41-67). This module implements the same on-disk
text format so scene files round-trip between implementations:

* ``key=value`` lines; values may be double-quoted (quotes are stripped).
* ``#``/``;`` comment lines and blank lines are ignored on parse.
* ``[full/group/path]`` headers open a *new* group at that path. Repeated
  group names are allowed (the reference writes one ``[object]`` per object);
  intermediate path components bind to the most recently created group of
  that name, which reproduces Corrade's depth-first save order on re-parse.

Value stringification mirrors Magnum's ConfigurationValue specializations
(Magnum/Math/ConfigurationValue.h): vectors/colors are space-separated
components, matrices are the 16 components in column-major storage order,
quaternions are ``x y z w`` (vector part then scalar), bools are
``true``/``false``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "ConfigurationGroup",
    "parse",
    "save",
    "fmt_float",
    "fmt_vector",
    "fmt_matrix",
    "fmt_quaternion_wxyz",
    "fmt_bool",
    "parse_floats",
    "parse_matrix",
    "parse_quaternion_wxyz",
    "parse_bool",
]


class ConfigurationGroup:
    """A node in the configuration tree: ordered values + ordered subgroups."""

    def __init__(self) -> None:
        self._values: list[tuple[str, str]] = []
        self._groups: list[tuple[str, "ConfigurationGroup"]] = []

    # -- values ---------------------------------------------------------------------

    def set_value(self, key: str, value) -> None:
        self._values.append((str(key), _to_text(value)))

    def has_value(self, key: str) -> bool:
        return any(k == key for k, _ in self._values)

    def value(self, key: str, default: str | None = None) -> str | None:
        for k, v in self._values:
            if k == key:
                return v
        return default

    def values(self, key: str) -> list[str]:
        return [v for k, v in self._values if k == key]

    # -- groups ---------------------------------------------------------------------

    def add_group(self, name: str) -> "ConfigurationGroup":
        g = ConfigurationGroup()
        self._groups.append((name, g))
        return g

    def group(self, name: str) -> "ConfigurationGroup | None":
        for n, g in self._groups:
            if n == name:
                return g
        return None

    def groups(self, name: str | None = None) -> list["ConfigurationGroup"]:
        if name is None:
            return [g for _, g in self._groups]
        return [g for n, g in self._groups if n == name]

    def _last_group(self, name: str) -> "ConfigurationGroup | None":
        for n, g in reversed(self._groups):
            if n == name:
                return g
        return None

    # -- save -----------------------------------------------------------------------

    def _write(self, out: list[str], path: str) -> None:
        for k, v in self._values:
            out.append(f"{k}={v}")
        for name, g in self._groups:
            sub = f"{path}/{name}" if path else name
            out.append(f"[{sub}]")
            g._write(out, sub)


def save(root: ConfigurationGroup) -> str:
    out: list[str] = []
    root._write(out, "")
    return "\n".join(out) + "\n"


def parse(text: str) -> ConfigurationGroup:
    root = ConfigurationGroup()
    current = root
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("[") and line.endswith("]"):
            path = line[1:-1].strip().strip("/")
            node = root
            parts = path.split("/")
            for comp in parts[:-1]:
                nxt = node._last_group(comp)
                if nxt is None:
                    nxt = node.add_group(comp)
                node = nxt
            current = node.add_group(parts[-1])
            continue
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        if len(value) >= 2 and value[0] == '"' and value[-1] == '"':
            value = value[1:-1]
        current._values.append((key.strip(), value))
    return root


# -- Magnum-style value formatting ---------------------------------------------------


def fmt_float(x) -> str:
    """Magnum uses ostream default formatting (6 significant digits)."""
    x = float(x)
    if not np.isfinite(x):
        return "inf" if x > 0 else ("-inf" if x < 0 else "nan")
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return f"{x:.6g}"


def fmt_vector(v) -> str:
    v = np.asarray(v, np.float64).reshape(-1)
    return " ".join(fmt_float(x) for x in v)


def fmt_ivector(v) -> str:
    v = np.asarray(v).reshape(-1)
    return " ".join(str(int(x)) for x in v)


def fmt_matrix(m) -> str:
    """4x4 (row-major numpy) -> 16 components in column-major storage order."""
    m = np.asarray(m, np.float64).reshape(4, 4)
    return " ".join(fmt_float(x) for x in m.T.reshape(-1))


def fmt_quaternion_wxyz(q) -> str:
    """Our (w,x,y,z) quaternion -> Magnum's ``x y z w`` text order."""
    q = np.asarray(q, np.float64).reshape(4)
    return " ".join(fmt_float(x) for x in (q[1], q[2], q[3], q[0]))


def fmt_bool(b) -> str:
    return "true" if b else "false"


def _to_text(value) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, (bool, np.bool_)):
        return fmt_bool(value)
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return fmt_float(value)
    arr = np.asarray(value)
    if arr.ndim == 2 and arr.shape == (4, 4):
        return fmt_matrix(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return fmt_ivector(arr)
    return fmt_vector(arr)


# -- parsing helpers ------------------------------------------------------------------


def parse_floats(text: str, n: int | None = None) -> np.ndarray:
    vals = np.array([float(t) for t in text.split()], np.float32)
    if n is not None and vals.size != n:
        raise ValueError(f"expected {n} components, got {vals.size}: {text!r}")
    return vals


def parse_matrix(text: str) -> np.ndarray:
    """16 column-major components -> (4,4) row-major numpy matrix."""
    return parse_floats(text, 16).reshape(4, 4).T.copy()


def parse_quaternion_wxyz(text: str) -> np.ndarray:
    """Magnum ``x y z w`` text -> our (w,x,y,z) quaternion."""
    x, y, z, w = parse_floats(text, 4)
    return np.array([w, x, y, z], np.float32)


def parse_bool(text: str) -> bool:
    return text.strip().lower() in ("true", "1", "yes", "on")
