"""Process context: the device and the global defaults.

Counterpart of ``stillleben_tpu/context.py`` (reference src/context.cpp,
python/src/py_context.cpp:60-112). The context names the torch device on
which scenes keep their physics state and render passes render: ``cuda:N``
unless the caller asks for another device by name (``init(device="cpu")``,
as the CPU tests do). Without a CUDA device, ``init()`` raises; it never
falls back to the CPU.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Default PBR material colour of a mesh without a material: reference
# src/context.cpp:382-384 (0x3bd267ff, a green).
DEFAULT_MATERIAL_COLOR = np.array(
    [0x3B / 255.0, 0xD2 / 255.0, 0x67 / 255.0, 1.0], dtype=np.float32
)

# Default physics material (reference src/context.cpp:250-252).
DEFAULT_STATIC_FRICTION = 0.3
DEFAULT_DYNAMIC_FRICTION = 0.2
DEFAULT_RESTITUTION = 0.1


class Context:
    """The global framework context; ``init`` makes the one instance."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.default_material_color = DEFAULT_MATERIAL_COLOR.copy()

    @property
    def platform(self) -> str:
        return self.device.type


_lock = threading.Lock()
_context: Context | None = None


def _cuda_device(index: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "stillleben_tpu_torch: no CUDA device; pass device='cpu' to init() to run on the CPU"
        )
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"stillleben_tpu_torch: no CUDA device {index}")
    return torch.device("cuda", index)


def init(device: torch.device | str | None = None) -> Context:
    """Create the global context on ``device`` (default ``cuda:0``), or
    return the existing one. Asking for another device than the existing
    context's replaces it."""
    global _context
    with _lock:
        if device is None:
            if _context is None:
                _context = Context(_cuda_device(0))
        else:
            dev = torch.device(device)
            if dev.type == "cuda":
                dev = _cuda_device(0 if dev.index is None else dev.index)
            if _context is None or _context.device != dev:
                _context = Context(dev)
    return _context


def init_cuda(device_index: int = 0, use_cuda: bool = True) -> Context:
    """The reference's CUDA init (python/src/py_context.cpp:87-100): the
    context on ``cuda:device_index``. ``use_cuda`` is accepted for
    compatibility; results are tensors on that card either way."""
    return init(torch.device("cuda", device_index))


def context() -> Context:
    """The global context, made by ``init()`` (on the card) if none exists."""
    return _context if _context is not None else init()


def _reset_context_for_tests() -> None:
    global _context
    with _lock:
        _context = None
