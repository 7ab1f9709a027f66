"""Wrapper of the CUDA kernel ``probe`` (``csrc/probe.cu``): ``x + 1`` over
an int32 tensor.

Replaces the Pallas TPU kernel that ``repro/kernels/__init__.py:
_pallas_available`` compiles and launches. ``backend._kernel_available``
launches it once on an (8, 128) int32 tensor to learn whether this process
can build and launch the port's CUDA kernels. The source's header says what
bounds it on the card.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`probe_plain`. It never falls back.
"""
from __future__ import annotations

import torch

from . import _cuda

PROBE_SHAPE = (8, 128)


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    return x + 1


def probe_call(x: torch.Tensor) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on a CUDA tensor, and the output it
    writes."""
    if x.device.type != "cuda":
        raise ValueError(f"probe launches on CUDA tensors, got {x.device}")
    _cuda.check(x, "x", torch.int32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    return (_cuda.Launch("probe", "probe_launch", (x.data_ptr(), x.numel(), out.data_ptr()),
                         (x, out)), out)


def probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """int32 ``x`` → ``x + 1``."""
    if x.device.type == "cpu":
        return probe_plain(x)
    launch, out = probe_call(x)
    launch()
    return out
