"""Backend names and their resolution, one authority for every dispatcher.

Port of ``BackendPolicy``/``resolve_backends`` (``repro/kernels/__init__.py``).
The names are the reference's minus ``"interpret"``, which has no meaning
without Pallas. ``"auto"`` resolves by the device of the tensors at hand:
the hand-written CUDA kernel on a CUDA tensor (as the reference picks its
Pallas kernel on the TPU), the plain PyTorch path elsewhere. ``"kernel"``
on a tensor off the card raises. There is no availability probe and no
fallback chain: nothing on the main path degrades from kernel to plain.
"""
from __future__ import annotations

import dataclasses

import torch

FITNESS_BACKENDS = ("auto", "kernel", "ref", "jnp")
VARIATION_BACKENDS = ("auto", "kernel", "ref", "ops")
GENERATION_BACKENDS = ("auto", "kernel", "ref", "phases")
RANKING_BACKENDS = ("auto", "sweep", "matrix")

BACKEND_CHOICES = {
    "fitness": FITNESS_BACKENDS,
    "variation": VARIATION_BACKENDS,
    "generation": GENERATION_BACKENDS,
    "ranking": RANKING_BACKENDS,
}

# "auto" off the card, per dispatch path
_PLAIN = {"fitness": "ref", "variation": "ref", "generation": "ref"}

@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    """One validated backend name per dispatch path; unknown names raise
    ``ValueError`` at construction."""

    fitness: str = "auto"
    variation: str = "auto"
    generation: str = "auto"
    ranking: str = "auto"

    def __post_init__(self):
        for path, choices in BACKEND_CHOICES.items():
            name = getattr(self, path)
            if name not in choices:
                raise ValueError(
                    f"unknown {path} backend {name!r}: expected one of "
                    f"{choices}")


def resolve_backends(policy=None, **overrides) -> BackendPolicy:
    """Loose per-path names (``fitness=…``; ``None`` keeps the policy's
    choice) over ``policy`` (None: all auto) → a validated policy."""
    base = policy if policy is not None else BackendPolicy()
    bad = set(overrides) - set(BACKEND_CHOICES)
    if bad:
        raise ValueError(f"unknown backend paths {sorted(bad)}: expected "
                         f"a subset of {sorted(BACKEND_CHOICES)}")
    kept = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(base, **kept) if kept else base


def pick(path: str, name: str | None, device: torch.device) -> str:
    """The concrete backend of ``path`` for tensors on ``device``."""
    if name not in BACKEND_CHOICES[path] and name is not None:
        raise ValueError(f"unknown {path} backend {name!r}; want "
                         f"{BACKEND_CHOICES[path]}")
    on_card = torch.device(device).type == "cuda"
    if name is None or name == "auto":
        if path == "ranking":
            return "sweep"
        return "kernel" if on_card else _PLAIN[path]
    if name == "kernel" and not on_card:
        raise RuntimeError(f"{path} backend 'kernel' runs a CUDA kernel and "
                           f"needs CUDA tensors, got {device}")
    return name
