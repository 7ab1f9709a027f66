"""Public op: causal flash attention with kernel/plain dispatch."""
from __future__ import annotations

from ..backend import use_kernel_on
from .kernel import flash_attention
from .ref import flash_attention_ref


def causal_attention(q, k, v, *, use_kernel=None, block_q=128, block_k=128):
    """Causal attention over (BH, S, D) / (BH, S, Dv). ``use_kernel``: None
    launches the CUDA kernel on CUDA tensors and runs the plain version on
    CPU tensors; True needs CUDA tensors."""
    if use_kernel_on(use_kernel, q.device, "causal_attention"):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               block_q=block_q, block_k=block_k)
    return flash_attention_ref(q, k, v)
