"""Public op: SSD state scan with kernel/plain dispatch."""
from __future__ import annotations

from ..backend import use_kernel_on
from .kernel import ssd_state_scan
from .ref import ssd_state_scan_ref


def state_scan(state_c, chunk_decay, *, use_kernel=None):
    """(b, nc, H, P, N) chunk states × (b, nc, H) chunk decays → the state
    entering each chunk. ``use_kernel``: None launches the CUDA kernel on
    CUDA tensors and runs the plain version on CPU tensors; True needs
    CUDA tensors."""
    if use_kernel_on(use_kernel, state_c.device, "state_scan"):
        return ssd_state_scan(state_c.contiguous(), chunk_decay.contiguous())
    return ssd_state_scan_ref(state_c, chunk_decay)
