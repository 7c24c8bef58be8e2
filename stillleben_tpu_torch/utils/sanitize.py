"""Numerical sanitizers (the reference's sanitizer tooling: a tensor
program's failure mode is numerical, NaN silently propagating through a
pipeline and poisoning a dataset).

Counterpart of ``stillleben_tpu/utils/sanitize.py``, all three layers, each
opt-in and free when off:

1. ``debug_nans()``: the counterpart of ``jax_debug_nans``, a scoped
   ``TorchDispatchMode`` that checks every floating output of every aten op
   that computes values (not views, not uninitialized allocations) and
   raises ``FloatingPointError`` at the first op that outputs a NaN,
   naming it. Every op reads a flag back from the device: use it to
   localize, not in production.
2. ``check_finite(tree, name)``: NaN and Inf counts per tensor of a tree
   (two scalars read back per tensor); raises ``NonFiniteError`` naming
   every offending leaf. With ``SL_SANITIZE`` set,
   ``Scene.simulate_tabletop_scene`` checks the settled state and
   ``RenderPass.render`` every buffer of its frame.
3. ``checked(fn, nan=, div=, oob=)``: the checks that
   ``jax.experimental.checkify`` selects, under the same dispatch mode for
   the duration of each call: NaN outputs, division or remainder by zero,
   and out-of-range indices of gathers, scatters and indexing.
   The last two are checked before the op runs: on the card the op itself
   gives garbage (division) or a device assert that poisons the context
   (indexing), so the check raises ``CheckError`` instead.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


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


class CheckError(ValueError):
    """Raised by :func:`checked` for a division by zero or an index out of
    range (the role of checkify's ``JaxRuntimeError``)."""


# ops that divide by their second operand: true, floor and truncating
# division of any dtype (checkify's division check), and the remainders
# (integer remainder by zero raises on the CPU and gives garbage on the card)
_DIV_OPS = frozenset(("div", "div_", "floor_divide", "floor_divide_", "remainder", "remainder_",
                      "fmod", "fmod_"))
# ops that index their first operand's dimension ``dim`` (argument 1) with
# argument 2, each index in [0, size)
_DIM_INDEX_OPS = frozenset((
    "gather", "index_select", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_",
    "index_fill", "index_fill_", "index_reduce", "index_reduce_",
))
# advanced indexing, x[i] and x[i] = v: argument 1 lists one index per
# dimension, negative indices wrap
_ADVANCED_INDEX_OPS = frozenset(("index", "index_put", "index_put_", "_index_put_impl_",
                                 "_unsafe_index", "_unsafe_index_put"))

# ops whose outputs hold no computed values: uninitialized allocations, which
# may hold any bits until written (JAX has none); views are skipped as well
_UNINITIALIZED = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "empty_permuted", "resize_"))

_tls = threading.local()


def _out_of_range(func, idx: torch.Tensor, size: int, lo: int, what: str) -> None:
    if idx.numel() and bool(((idx < lo) | (idx >= size)).any()):
        bad = idx[(idx < lo) | (idx >= size)].flatten()[0]
        raise CheckError(f"out-of-bounds indexing in {func}: index {int(bad)} is out of "
                         f"bounds for {what} with size {size}")


def _check_indices(func, name: str, args) -> None:
    if name in _DIM_INDEX_OPS:
        src, dim, index = args[0], args[1], args[2]
        dim = dim % max(src.dim(), 1)
        size = src.shape[dim] if src.dim() else 1
        _out_of_range(func, index, size, 0, f"axis {dim}")
    elif name in _ADVANCED_INDEX_OPS:
        src, d = args[0], 0
        for idx in args[1]:
            if idx is None:
                d += 1
            elif idx.dtype in (torch.bool, torch.uint8):  # a mask spans idx.dim() axes
                d += idx.dim()
            else:
                size = src.shape[d]
                _out_of_range(func, idx, size, -size, f"axis {d}")
                d += 1
    elif name == "take":
        n = args[0].numel()
        _out_of_range(func, args[1], n, -n, "the flattened input")
    elif name == "embedding":
        _out_of_range(func, args[1], args[0].shape[0], 0, "axis 0 of the weight")


def _check_division(func, args) -> None:
    b = args[1]
    if bool((b == 0).any()) if isinstance(b, torch.Tensor) else b == 0:
        raise CheckError(f"division by zero in {func}")


class _Checks(TorchDispatchMode):
    """The dispatch mode of ``debug_nans`` and ``checked``. The innermost
    active scope of this thread checks with its flags; an enclosing one
    passes its ops through, so each op is checked once."""

    def __init__(self, nan: bool, div: bool, oob: bool):
        super().__init__()
        self.nan, self.div, self.oob = nan, div, oob
        self._outer = None

    def __enter__(self):
        self._outer = getattr(_tls, "active", None)
        _tls.active = self
        return super().__enter__()

    def __exit__(self, *exc):
        _tls.active = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_tls, "active", None) is not self:
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.oob:
            _check_indices(func, name, args)
        if self.div and name in _DIV_OPS:
            _check_division(func, args)
        out = func(*args, **kwargs)
        if self.nan and not func.is_view and name not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and t.numel() and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


def _scope(nan: bool | None = None, div: bool | None = None, oob: bool | None = None) -> _Checks:
    """A mode whose flags left at None are those of the enclosing scope
    (off without one)."""
    outer = getattr(_tls, "active", None)

    def flag(value, name):
        return bool(getattr(outer, name, False)) if value is None else value

    return _Checks(flag(nan, "nan"), flag(div, "div"), flag(oob, "oob"))


@contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking of every aten op's output (the counterpart of
    the ``jax_debug_nans`` toggle): raises ``FloatingPointError`` naming
    the first op that outputs a NaN. ``enable=False`` turns an enclosing
    scope's NaN check off inside; on exit the enclosing scope's checks
    apply again."""
    if not enable and getattr(_tls, "active", None) is None:
        yield
        return
    with _scope(nan=enable):
        yield


def checked(fn: Callable, *, nan: bool = True, div: bool = True, oob: bool = False) -> Callable:
    """Wrap ``fn`` so that its errors surface as Python exceptions, on every
    device: NaN outputs (``nan``, ``FloatingPointError``), division or
    remainder by zero (``div``) and out-of-range indices (``oob``), both
    ``CheckError``, raised before the op runs. Returns a callable with
    ``fn``'s signature and result."""

    def wrapper(*args, **kwargs):
        with _scope(nan=nan or None, div=div or None, oob=oob or None):
            return fn(*args, **kwargs)

    wrapper.__name__ = getattr(fn, "__name__", "checked_fn")
    return wrapper
