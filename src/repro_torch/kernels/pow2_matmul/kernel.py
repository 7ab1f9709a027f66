"""Wrapper of the CUDA kernel ``pow2_matmul`` (``csrc/pow2_matmul.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pow2_matmul/kernel.py:
pow2_matmul``: x (M, K) float32 or bfloat16 × packed pow2 weights (K, N)
uint8 → (M, N) float32, the weights decoded on chip by exponent insertion
(``_decode_pow2``) and the sums accumulated in float32. The source's header
says what bounds it on the card.

On a CUDA tensor the wrapper checks its inputs and launches the kernel; on
a CPU tensor it runs :func:`pow2_matmul_plain`. It never falls back.
"""
from __future__ import annotations

import torch

from ...core.quantize import pow2_dequantize
from .. import _cuda
from .ref import pow2_matmul_ref

# The reference's in-kernel decode (uint8 codes → ±2^e by exponent-bit
# insertion, 0x7F → 0); the port's pow2_dequantize decodes the same way.
_decode_pow2 = pow2_dequantize

# The kernel's plain PyTorch version (same arguments; only the order of the
# float32 sums differs).
pow2_matmul_plain = pow2_matmul_ref

X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def pow2_matmul_call(x, w_packed) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the (M, N)
    float32 output it writes."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pow2_matmul launches on CUDA tensors, got {dev}")
    if x.dtype not in X_TYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    M, K = x.shape
    N = w_packed.shape[1]
    _cuda.check(x, "x", x.dtype, (M, K), dev)
    _cuda.check(w_packed, "w_packed", torch.uint8, (K, N), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), X_TYPES[x.dtype], w_packed.data_ptr(), M, N, K, out.data_ptr())
    return (_cuda.Launch("pow2_matmul", "pow2_matmul_launch", args, (x, w_packed, out)),
            out)


def pow2_matmul(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float32/bfloat16 × packed (K, N) uint8 → (M, N) float32.

    The reference's block sizes (``bm``, ``bn``, ``bk``, which must divide
    the shapes there) are not taken: the CUDA kernel chooses its own tiling
    and masks ragged edges, so every (M, K, N) runs."""
    if x.dim() != 2 or w_packed.dim() != 2 or x.shape[1] != w_packed.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w_packed {tuple(w_packed.shape)} "
                         f"are not (M, K) and (K, N)")
    if x.device.type == "cpu":
        return pow2_matmul_plain(x, w_packed)
    launch, out = pow2_matmul_call(x, w_packed)
    if out.numel():
        launch()
    return out
