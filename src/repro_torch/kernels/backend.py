"""Backend names and their resolution, one authority for every dispatcher.

Port of ``BackendPolicy``/``resolve_backends`` (``repro/kernels/__init__.py``).
The names are the reference's minus ``"interpret"``, which has no meaning
without Pallas. ``"auto"`` resolves by the device of the tensors at hand:
the hand-written CUDA kernel on a CUDA tensor (as the reference picks its
Pallas kernel on the TPU), the plain PyTorch path elsewhere. ``"kernel"``
on a tensor off the card raises.

The fallback chains are the reference's opt-in: ``resolve_backends(...,
fallback=True)`` degrades a backend this process cannot launch along
:data:`FALLBACK_CHAINS`, warning once per downgrade, after the probe
kernel (``csrc/probe.cu``) has answered. The default ``fallback=False``
changes nothing, and no entry point of the port turns it on.
"""
from __future__ import annotations

import dataclasses
import warnings

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


# Degradation order per dispatch path: a requested backend that is not
# available falls through to the next name in its chain. The port has no
# "interpret", so a CUDA kernel degrades straight to its plain PyTorch path;
# "auto" and the plain names are not chained, and names outside a chain are
# never downgraded. Ranking's "sweep" is plain PyTorch but stays chained to
# "matrix", the reference's escape hatch.
FALLBACK_CHAINS = {
    "fitness": ("kernel", "ref"),
    "variation": ("kernel", "ref"),
    "generation": ("kernel", "ref"),
    "ranking": ("sweep", "matrix"),
}

# (mode -> bool) memo of the probe; tests reset it
_KERNEL_OK: dict = {}
# downgrades already warned about, so a long-lived process warns once each
_WARNED: set = set()


def _kernel_available(mode: str = "compiled") -> bool:
    """Can this process build the CUDA kernels and launch one? The probe
    kernel adds 1 to an (8, 128) int32 tensor on the card and element
    [0, 0] must come back 1. Without CUDA the answer is False and nothing
    is built; any exception (no nvcc, a refused build or launch) counts as
    unavailable. Memoized per mode; "compiled" is the port's only mode."""
    if mode in _KERNEL_OK:
        return _KERNEL_OK[mode]
    ok = False
    if mode == "compiled" and torch.cuda.is_available():
        try:
            from .probe import PROBE_SHAPE, probe_kernel

            x = torch.zeros(PROBE_SHAPE, dtype=torch.int32, device="cuda")
            ok = int(probe_kernel(x)[0, 0]) == 1
        except Exception:
            ok = False
    _KERNEL_OK[mode] = ok
    return ok


def backend_available(path: str, name: str, probe=None) -> bool:
    """Is backend ``name`` expected to work for ``path`` in this process?
    ``probe``: an injectable ``(path, name) -> bool`` for tests; by default
    "kernel" asks the probe kernel and every plain name is available."""
    if probe is not None:
        return bool(probe(path, name))
    if name == "kernel":
        return _kernel_available("compiled")
    return True


def _fallback_for(path: str, name: str, probe) -> str:
    chain = FALLBACK_CHAINS.get(path, ())
    if name not in chain:
        return name
    for cand in chain[chain.index(name):]:
        if backend_available(path, cand, probe):
            if cand != name and (path, name, cand) not in _WARNED:
                _WARNED.add((path, name, cand))
                warnings.warn(f"{path} backend {name!r} unavailable on this host; "
                              f"falling back to {cand!r}", RuntimeWarning, stacklevel=3)
            return cand
    # nothing in the chain probes healthy: keep the last (plain) entry, so a
    # failure, if any, surfaces in the dispatch itself
    last = chain[-1]
    if last != name and (path, name, last) not in _WARNED:
        _WARNED.add((path, name, last))
        warnings.warn(f"{path} backend {name!r} unavailable and no probed fallback; "
                      f"using {last!r}", RuntimeWarning, stacklevel=3)
    return last


def apply_fallbacks(policy: BackendPolicy, probe=None) -> BackendPolicy:
    """Degrade every unavailable backend of ``policy`` along
    :data:`FALLBACK_CHAINS` (a new policy; warns once per process per
    (path, from, to) downgrade)."""
    repl = {}
    for path in BACKEND_CHOICES:
        name = getattr(policy, path)
        picked = _fallback_for(path, name, probe)
        if picked != name:
            repl[path] = picked
    return dataclasses.replace(policy, **repl) if repl else policy


def resolve_backends(policy=None, *, fallback: bool = False, probe=None,
                     **overrides) -> BackendPolicy:
    """Loose per-path names (``fitness=…``; ``None`` keeps the policy's
    choice) over ``policy`` (None: all auto) → a validated policy.

    ``fallback=True`` also degrades backends this process cannot launch
    along :data:`FALLBACK_CHAINS` (kernel → ref; ranking: sweep → matrix),
    warning once per downgrade; ``probe`` is the injectable availability
    predicate of :func:`backend_available`."""
    base = policy if policy is not None else BackendPolicy()
    bad = set(overrides) - set(BACKEND_CHOICES)
    if bad:
        raise ValueError(f"unknown backend paths {sorted(bad)}: expected "
                         f"a subset of {sorted(BACKEND_CHOICES)}")
    kept = {k: v for k, v in overrides.items() if v is not None}
    out = dataclasses.replace(base, **kept) if kept else base
    return apply_fallbacks(out, probe) if fallback else out


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


def use_kernel_on(use_kernel: bool | None, device, op: str) -> bool:
    """Whether an LM-side op (``state_scan``, ``causal_attention``,
    ``pow2_linear``) launches its CUDA kernel: ``None`` picks the kernel for
    a CUDA tensor and the plain version elsewhere; ``True`` off the card
    raises; ``False`` runs the plain version on either device."""
    on_card = torch.device(device).type == "cuda"
    if use_kernel is None:
        return on_card
    if use_kernel and not on_card:
        raise RuntimeError(f"{op}: use_kernel=True runs a CUDA kernel and needs "
                           f"CUDA tensors, got {device}")
    return bool(use_kernel)
