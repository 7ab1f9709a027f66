"""The port's device rule, shared by ``core`` and ``launch``: every entry
point runs on the card unless the caller asks for the CPU, and what the port
does not have yet raises with the ROADMAP item that will bring it.

Importing this module touches no device.
"""
from __future__ import annotations

import torch


def device_of(device) -> torch.device:
    """An entry point's device; a CUDA request without a card raises (the
    port never carries on on the CPU unless asked to). A CUDA device comes
    back in its tensors' own form, with its index (``"cuda"`` is the
    current card), so it compares equal to ``tensor.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain PyTorch paths")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the PyTorch port yet "
                               f"(ROADMAP {item})")
