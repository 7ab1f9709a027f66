"""Fixed-point quantization of the printed-MLP regime (paper §III-A).

The printed-MLP half of ``repro.core.quantize``; the LM pow2/int8
quantizers are not ported yet.
"""
from __future__ import annotations

import torch


def quantize_inputs(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[0,1] float32 → unsigned ``bits``-bit int32 (paper: 4-bit inputs).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    hi = 2**bits - 1
    return torch.clamp(torch.round(x * hi), 0, hi).to(torch.int32)


def qrelu(acc: torch.Tensor, rshift: torch.Tensor, out_bits: int) -> torch.Tensor:
    """QReLU: arithmetic right shift by the rescale gene, then clamp to
    ``[0, 2**out_bits - 1]`` (paper §III-B)."""
    return torch.clamp(torch.bitwise_right_shift(acc, rshift), 0, 2**out_bits - 1)
