"""Stage marks for timing a render from outside.

``frame.py`` and ``shading.py`` call ``mark(name)`` when a stage of the
frame ends. With no hook set (the default) a mark does nothing; a caller
that wants stage times sets ``set_hook(fn)`` and ``fn(name)`` records what
it needs (for example a CUDA event), then clears it with ``set_hook(None)``.
"""

from __future__ import annotations

_hook = None


def set_hook(fn) -> None:
    global _hook
    _hook = fn


def mark(name: str) -> None:
    if _hook is not None:
        _hook(name)
