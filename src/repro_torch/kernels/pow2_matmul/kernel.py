"""Wrapper of the CUDA kernel ``pow2_matmul`` (``csrc/pow2_matmul.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pow2_matmul/kernel.py:
pow2_matmul``: x (M, K) float32 or bfloat16 × packed pow2 weights (K, N)
uint8 → (M, N) float32, the weights decoded on chip by exponent insertion
(``_decode_pow2``) and the sums accumulated in float32. Two paths, one
launch each:

* bfloat16 runs the kernel built for Hopper: TMA loads of x and of the
  weight bytes into a ring of shared-memory stages, a producer warpgroup
  that decodes the bytes into a bf16 tile there (four codes per 32-bit
  word, :func:`decode_pow2_word`), two consumer warpgroups on ``wgmma``.
* float32 runs a pipelined SIMT kernel on the float32 pipe, the weights
  decoded in registers by the same word decode.

Both load 16 bytes at a time and TMA wants 16-byte row strides, so the
kernel takes K a multiple of 8 and weight rows of N rounded up to 16 bytes:
:func:`pad_operands` pads x with zero columns and the weights with ``0x7F``
(zero) rows and columns where the shapes are not so, and copies an operand
whose storage is not 16-byte aligned. The padding adds exact zeros to every
sum; the kernel writes the (M, N) output, masked. The source's header says
what bounds each path on the card.

On a CUDA tensor the wrapper checks its inputs and launches the kernel; on
a CPU tensor it runs :func:`pow2_matmul_plain`. It never falls back.
"""
from __future__ import annotations

import torch

from ...core.quantize import ZERO_CODE, pow2_dequantize
from .. import _cuda
from .ref import pow2_matmul_ref

# The reference's in-kernel decode of one code (uint8 code c → ±2^e by
# exponent-bit insertion: the sign from bit 7, the exponent field
# (c & 0x7F) + 64 in bf16 and float32 alike, code 0x7F → 0); the port's
# pow2_dequantize decodes the same way. The kernels decode four codes at
# once (decode_pow2_word).
_decode_pow2 = pow2_dequantize

# The kernel's plain PyTorch version (same arguments; only the order of the
# float32 sums differs).
pow2_matmul_plain = pow2_matmul_ref

X_TYPES = {torch.float32: 0, torch.bfloat16: 1}
K_ALIGN = 8      # x's columns: 16 bytes of bf16
N_ALIGN = 16     # the weights' columns: 16 bytes
TMA_ALIGN = 16   # bytes: the operands' storage
SM90_SMEM_BYTES = 230_528   # csrc/pow2_matmul.cu kSmemBytes: the bf16 kernel's block


def decode_pow2_word(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' decode of four codes at once (``decode_word`` in the
    source), spelled out in integer ops: ``w`` holds codes 0–3 in its bytes;
    the result is two words of two bf16 each, codes (0, 1) and (2, 3), the
    first of each pair in the low 16-bit half. With a pair u spread into the
    halves (``prmt``)

        ((u & 0x00800080) << 8) | (((u & 0x007F007F) + 0x00400040) << 7)
        = (u + (u & 0x00800080) + 0x00400040) << 7

    puts the sign at bit 15 and the exponent field (c & 0x7F) + 64 at bits
    7–14 of each half; a half is cleared where its code is 0x7F, found for
    all four bytes at once: the msb of byte i of
    ``(((~w & 0x7F7F7F7F) + 0x7F7F7F7F) | w) & 0x80808080`` is set where
    code i is not 0x7F, and ``prmt`` spreads it over the code's half. The
    ops run in int64, where the shifts do not overflow; each result is the
    unsigned 32-bit word as an int64."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    nz = ((((~w) & 0x7F7F7F7F) + 0x7F7F7F7F) | w) & 0x80808080

    def pair(u, b0, b1):
        v = ((u + (u & 0x00800080) + 0x00400040) << 7) & 0xFFFFFFFF
        keep = ((nz >> (8 * b0 + 7)) & 1) * 0xFFFF | ((nz >> (8 * b1 + 7)) & 1) * 0xFFFF0000
        return v & keep

    u0 = (w & 0xFF) | ((w >> 8) & 0xFF) << 16
    u1 = ((w >> 16) & 0xFF) | ((w >> 24) & 0xFF) << 16
    return pair(u0, 0, 1), pair(u1, 2, 3)


def pad_operands(x: torch.Tensor, w_packed: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) and w (K, N) as the kernel takes them: x (M, K8) with zero
    columns past K, w (K8, N16) with ``0x7F`` rows and columns past K and N
    (K8 = K rounded up to 8, at least 8; N16 = N rounded up to 16), each
    with 16-byte aligned storage. An operand that already is comes back as
    it is."""
    M, K = x.shape
    N = w_packed.shape[1]
    k8 = max(K_ALIGN, -(-K // K_ALIGN) * K_ALIGN)
    n16 = -(-N // N_ALIGN) * N_ALIGN
    if k8 != K or x.data_ptr() % TMA_ALIGN:
        p = x.new_zeros((M, k8))
        p[:, :K] = x
        x = p
    if (k8, n16) != (K, N) or w_packed.data_ptr() % TMA_ALIGN:
        p = w_packed.new_full((k8, n16), ZERO_CODE)
        p[:K, :N] = w_packed
        w_packed = p
    return x, w_packed


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
    if x.dtype == torch.bfloat16:
        _cuda.check_smem(SM90_SMEM_BYTES, dev, "pow2_matmul (bfloat16)")
    x, w_packed = pad_operands(x, w_packed)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), X_TYPES[x.dtype], w_packed.data_ptr(), M, N, x.shape[1],
            out.data_ptr())
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
