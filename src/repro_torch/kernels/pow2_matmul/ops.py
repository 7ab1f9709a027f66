"""Public op: pow2-quantized linear with kernel/plain dispatch, and the
weights' storage format."""
from __future__ import annotations

from ...core.quantize import pow2_quantize
from ..backend import use_kernel_on
from .kernel import pow2_matmul
from .ref import pow2_matmul_ref


def pow2_linear(x, w_packed, *, use_kernel: bool | None = None):
    """x: (..., K) × packed (K, N) → (..., N) float32. ``use_kernel``: None
    launches the CUDA kernel on CUDA tensors and runs the plain version on
    CPU tensors; True needs CUDA tensors."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if use_kernel_on(use_kernel, x.device, "pow2_linear"):
        out = pow2_matmul(x2.contiguous(), w_packed.contiguous())
    else:
        out = pow2_matmul_ref(x2, w_packed)
    return out.reshape(*lead, w_packed.shape[-1])


def pack_weights(w):
    """Float weights → packed pow2 uint8 (storage format)."""
    return pow2_quantize(w)
