"""Plain PyTorch version of the pow2 matmul: the function the CUDA kernel
computes (``kernel.py``: a Hopper tensor-core path for bf16 x and a SIMT
path for float32 x, over operands the wrapper pads), written without a
tiling."""
from __future__ import annotations

import torch

from ...core.quantize import pow2_dequantize


def pow2_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """x (M, K) × packed (K, N) uint8 → (M, N) float32: the weights decoded
    (exactly) to x's type, then a float32 product with float32 accumulation
    (x and the weights cast to float32, exact for bf16). Unlike the kernel,
    it decodes the whole weight tensor into device memory. The caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False on the card."""
    w = pow2_dequantize(w_packed, x.dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))
