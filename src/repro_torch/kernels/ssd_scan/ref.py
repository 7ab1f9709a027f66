"""Plain PyTorch version of the SSD inter-chunk state scan."""
from __future__ import annotations

import torch


def ssd_state_scan_ref(state_c: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """state_c: (b, nc, H, P, N) float32; chunk_decay: (b, nc, H) float32 →
    h_prev, the state entering each chunk (chunk 0 is 0):
    ``h_{c+1} = decay_c ⊙ h_c + state_c``, a multiply and an add, each
    rounded (the CUDA kernel's order, so the two agree bit for bit)."""
    b, nc, H, P, N = state_c.shape
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=state_c.device)
    out = torch.empty((b, nc, H, P, N), dtype=torch.float32, device=state_c.device)
    for c in range(nc):
        out[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    return out
