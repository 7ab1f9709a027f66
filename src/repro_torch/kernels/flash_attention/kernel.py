"""Wrapper of the CUDA kernel ``flash_attention`` (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention``: the causal FlashAttention forward over (BH, S, D)
queries and keys and (BH, S, Dv) values, float32 or bfloat16, with the
online softmax state (m, l, acc) kept across the key tiles and the tiles
past the diagonal skipped. Forward only, as the reference. Two paths, one
launch each:

* bfloat16 runs the kernel built for Hopper: TMA loads over 3-D tensor maps
  into a ring of shared-memory stages, a producer warpgroup beside two
  consumer warpgroups, both products on ``wgmma``, p kept in registers.
  TMA wants the rows' byte strides to be multiples of 16, so the wrapper
  pads D and Dv up to multiples of 8 with zero columns (:func:`tma_operands`)
  and keeps the scale of the unpadded D: the zeros add exact zeros to every
  score and output column, and the output is sliced back.
* float32 runs a SIMT kernel on the float32 pipe (register tiles of 8
  query rows × 4 keys and 8 rows × 8 output columns, K and V tiles by
  ``cp.async``). Its 16-byte pieces want rows of a multiple of 16 bytes
  too: the wrapper pads D and Dv to multiples of 4 the same way.

The source's header says what bounds each on the card.

On a CUDA tensor the wrapper checks its inputs and launches the kernel; on
a CPU tensor it runs :func:`flash_attention_plain`. It never falls back.
"""
from __future__ import annotations

import math

import torch

from .. import _cuda
from .ref import flash_attention_ref

MAX_DV = 128     # csrc/flash_attention.cu kMaxDv: accumulator columns per row
MAX_D = 128      # query/key width the kernels' shared memory is sized for
QKV_TYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16   # bytes: the kernels' global addresses and row strides are multiples of it

# The kernel's plain PyTorch version (same arguments; the sums and the
# softmax run in another order).
flash_attention_plain = flash_attention_ref


def check_blocks(S: int, block_q: int, block_k: int) -> None:
    """The reference's block check: ``min(block, S)`` divides S."""
    bq, bk = min(block_q, S), min(block_k, S)
    if min(bq, bk) < 1 or S % bq or S % bk:
        raise ValueError(f"blocks (block_q, block_k) = {(bq, bk)} must divide S = {S}")


def tma_operands(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor as the kernels' 16-byte loads take it (TMA in bf16,
    ``cp.async`` in float32): its last dimension padded with zero columns
    to a multiple of 16 bytes (8 bf16 or 4 float32 columns) and its storage
    16-byte aligned; a tensor that already is comes back as it is."""
    out = []
    for t in ts:
        w = t.shape[-1]
        cols = TMA_ALIGN // t.element_size()
        wp = -(-w // cols) * cols
        if wp != w or t.data_ptr() % TMA_ALIGN:
            p = t.new_zeros((*t.shape[:-1], wp))
            p[..., :w] = t
            t = p
        out.append(t)
    return tuple(out)


def flash_attention_call(q, k, v) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the (BH, S,
    Dv) output (q's type) it writes: a view of the padded output the launch
    writes where Dv is padded (see :func:`tma_operands`)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got {dev}")
    if q.dtype not in QKV_TYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    BH, S, D = q.shape
    Dv = v.shape[-1]
    if not (1 <= D <= MAX_D and 1 <= Dv <= MAX_DV) or BH > 65535:
        raise ValueError(f"flash_attention takes D, Dv in [1, {MAX_D}] and BH <= 65535, "
                         f"got D={D}, Dv={Dv}, BH={BH}")
    _cuda.check(q, "q", q.dtype, (BH, S, D), dev)
    _cuda.check(k, "k", q.dtype, (BH, S, D), dev)
    _cuda.check(v, "v", q.dtype, (BH, S, Dv), dev)
    scale = 1.0 / math.sqrt(D)
    q, k, v = tma_operands(q, k, v)
    out = torch.empty((BH, S, v.shape[-1]), dtype=q.dtype, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), QKV_TYPES[q.dtype], BH, S, q.shape[-1],
            v.shape[-1], scale, out.data_ptr())
    return (_cuda.Launch("flash_attention", "flash_attention_launch", args, (q, k, v, out)),
            out[..., :Dv])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal attention. q: (BH, S, D); k: (BH, S, D); v: (BH, S, Dv) →
    (BH, S, Dv) in q's type. Batch × heads flattened into the leading dim
    (GQA replication outside).

    The block sizes are checked as the reference checks them; the CUDA
    kernel chooses its own tiling (the function does not depend on it)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    check_blocks(q.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    launch, out = flash_attention_call(q, k, v)
    if out.numel():
        launch()
    return out.contiguous()
