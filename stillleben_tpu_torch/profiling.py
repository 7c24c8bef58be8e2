"""Opt-in wall-clock profiling scopes.

Counterpart of ``stillleben_tpu/profiling.py`` (role of the reference's
python/stillleben/profiling.py): the same records, report and
``drain_records``. Scopes don't build a live object tree. Each ``Timer``
exit appends a flat ``(depth, label, seconds)`` record to a module buffer;
when the last open scope closes, the buffer is rendered as an indented
report and cleared. This keeps ``__exit__`` allocation-free inside hot
loops and lets callers fetch the raw records programmatically
(``drain_records``) instead of parsing stdout.

CUDA work is asynchronous, so a wall clock around a launch measures the
enqueue. ``Timer(name, sync=x)`` synchronizes the CUDA device of every
tensor in the tree ``x`` on exit, before it reads the clock (the
reference's explicit ``torch.cuda.synchronize()`` before timed blocks); CPU
tensors need nothing.
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator

import torch

_records: list[tuple[int, str, float]] = []
_depth = 0


def drain_records() -> list[tuple[int, str, float]]:
    """Return and clear the accumulated (depth, label, seconds) records."""
    global _records
    out, _records = _records, []
    return out


def _render(records) -> str:
    lines = ["profile:"]
    for depth, label, secs in records:
        lines.append(f"{'  ' * (depth + 1)}{label} {secs * 1e3:.1f} ms")
    return "\n".join(lines)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors in tuples,
    lists, NamedTuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _cuda_devices(leaf, out)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            _cuda_devices(leaf, out)
    return out


class Timer(ContextDecorator):
    """``with Timer("stage"): ...`` or ``@Timer("fn")``; no-op unless
    ``Timer.enabled`` is True."""

    enabled = False

    def __init__(self, name: str, sync=None):
        self.name = name
        self._sync = sync
        self._t0 = 0.0
        self._slot = -1

    def __enter__(self):
        global _depth
        if Timer.enabled:
            _records.append((_depth, self.name, 0.0))
            self._slot = len(_records) - 1
            _depth += 1
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _depth
        if not Timer.enabled:
            return
        if self._sync is not None:
            for dev in _cuda_devices(self._sync, set()):
                torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - self._t0
        _depth -= 1
        d, label, _ = _records[self._slot]
        _records[self._slot] = (d, label, elapsed)
        if _depth == 0:
            print(_render(drain_records()))
