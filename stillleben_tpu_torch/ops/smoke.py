"""Toolchain check: ``o = 2 * x`` as a hand-written kernel and in PyTorch.

Replaces the toy Pallas kernel ``k`` of ``tools/tpu_smoke.py:73-76``.
``chip_smoke.py`` builds and launches it first, on an (8, 128) f32 tensor,
and requires it to equal ``double_reference`` exactly. No datagen path
runs it. CPU tensors take the plain version; CUDA tensors launch the
kernel (``double.launches`` counts those launches). ``empty_launch``
launches a kernel that does nothing: its time on the card is the launch
floor that bounds a kernel this small.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

SOURCE = "smoke.cu"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def double_reference(x: torch.Tensor) -> torch.Tensor:
    return 2 * x


def double(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("double: expected a contiguous float32 tensor")
    if x.device.type == "cpu":
        return double_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"double: unsupported device {x.device}")
    with torch.cuda.device(x.device):  # the entry point launches on the current device
        lib = nvcc.load(SOURCE, "sl_smoke", _ARGTYPES)
        o = torch.empty_like(x)
        err = lib.sl_smoke(x.data_ptr(), o.data_ptr(), x.numel(), nvcc.stream_of(x))
    nvcc.check(err, "smoke")
    double.launches += 1
    return o


double.launches = 0


def empty_launch(device="cuda") -> None:
    """Launch the empty kernel on ``device``'s current stream."""
    device = torch.device(device)
    with torch.cuda.device(device):
        lib = nvcc.load(SOURCE, "sl_smoke", _ARGTYPES)
        fn = lib.sl_empty
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(torch.cuda.current_stream(device).cuda_stream)
    nvcc.check(err, "empty")
