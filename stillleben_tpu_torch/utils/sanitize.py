"""Numerical sanitizers: the NaN/Inf audit of ``SL_SANITIZE=1``.

Counterpart of ``stillleben_tpu/utils/sanitize.py``, the part the host API
calls: ``enabled()`` and ``check_finite``. With ``SL_SANITIZE`` set,
``Scene.simulate_tabletop_scene`` checks the settled state and
``RenderPass.render`` every buffer of its frame (each check reads two
counts per tensor from the device: a debug mode). ``jax_debug_nans`` and
``checkify`` have no counterpart here.
"""

from __future__ import annotations

import os
from typing import Any

import torch


class NonFiniteError(FloatingPointError):
    """Raised by :func:`check_finite`; carries per-leaf NaN/Inf counts."""

    def __init__(self, name: str, bad: list[tuple[str, int, int]]):
        self.name = name
        self.bad = bad  # [(leaf_path, nan_count, inf_count), ...]
        lines = ", ".join(f"{path}: {n_nan} NaN / {n_inf} Inf" for path, n_nan, n_inf in bad)
        super().__init__(f"non-finite values in {name}: {lines}")


def enabled() -> bool:
    """True when the ``SL_SANITIZE`` environment variable asks for the checks."""
    return os.environ.get("SL_SANITIZE", "0") not in ("0", "")


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif hasattr(tree, "_fields"):  # a NamedTuple
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, leaf in enumerate(tree):
            yield from _leaves(leaf, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for key, leaf in tree.items():
            yield from _leaves(leaf, f"{path}[{key!r}]")


def check_finite(tree: Any, name: str = "output", raise_: bool = True):
    """Every floating tensor of ``tree`` (tensors in NamedTuples, tuples,
    lists and dicts) must be finite. Returns the offenders
    ``[(path, nan_count, inf_count), ...]``, or raises
    :class:`NonFiniteError` when ``raise_``."""
    bad = []
    for path, t in _leaves(tree):
        if not t.is_floating_point():
            continue
        n_nan, n_inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
        if n_nan or n_inf:
            bad.append((path, n_nan, n_inf))
    if bad and raise_:
        raise NonFiniteError(name, bad)
    return bad
