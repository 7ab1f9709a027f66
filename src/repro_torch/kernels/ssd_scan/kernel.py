"""Wrapper of the CUDA kernel ``ssd_state_scan`` (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan/kernel.py:
ssd_state_scan``: the Mamba-2 inter-chunk recurrence ``h_{c+1} = decay_c ⊙
h_c + state_c`` over (b, nc, H, P, N) float32, emitting the state entering
each chunk. The source's header says what bounds it on the card.

On a CUDA tensor the wrapper checks its inputs and launches the kernel; on
a CPU tensor it runs :func:`ssd_state_scan_plain`. It never falls back.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .ref import ssd_state_scan_ref

# The kernel's plain PyTorch version (same arguments, bit-identical result).
ssd_state_scan_plain = ssd_state_scan_ref


def ssd_state_scan_call(state_c, chunk_decay) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the (b, nc, H,
    P, N) float32 output it writes."""
    dev = state_c.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_state_scan launches on CUDA tensors, got {dev}")
    if state_c.dim() != 5:
        raise ValueError(f"state_c must be (b, nc, H, P, N), got {tuple(state_c.shape)}")
    b, nc, H, P, N = state_c.shape
    _cuda.check(state_c, "state_c", torch.float32, (b, nc, H, P, N), dev)
    _cuda.check(chunk_decay, "chunk_decay", torch.float32, (b, nc, H), dev)
    out = torch.empty_like(state_c)
    args = (state_c.data_ptr(), chunk_decay.data_ptr(), b, nc, H, P * N, out.data_ptr())
    return (_cuda.Launch("ssd_state_scan", "ssd_state_scan_launch", args,
                         (state_c, chunk_decay, out)), out)


def ssd_state_scan(state_c: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """state_c: (b, nc, H, P, N) float32; chunk_decay: (b, nc, H) float32 →
    h_prev (b, nc, H, P, N), the state entering each chunk.

    The reference's ``bh`` (heads per block, which must divide H there) is
    not taken: the CUDA kernel runs one thread per state element for any
    H."""
    if state_c.device.type == "cpu":
        return ssd_state_scan_plain(state_c, chunk_decay)
    launch, out = ssd_state_scan_call(state_c, chunk_decay)
    if out.numel():
        launch()
    return out
