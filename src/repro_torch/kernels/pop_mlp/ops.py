"""Public op: population fitness with backend dispatch.

Backends (``GAConfig.backends.fitness``):
  "auto"   — the CUDA kernel on a CUDA tensor, "ref" elsewhere (default)
  "kernel" — the CUDA kernel ``pop_mlp_correct`` (CUDA tensors only)
  "ref"    — the population/sample-tiled PyTorch path
  "jnp"    — the untiled oracle (the reference's name; no row skip)

``n_valid_rows`` (an int or a () int32 device tensor) is the dedup fast
path: rows past it are not evaluated and come back 0 on "kernel"/"ref"
(callers overwrite them). ``n_valid_samples`` bounds the counted samples
the same way. ``out_mask`` ((n_out,)) pins invalid output columns to
INT32_MIN before the argmax on every backend.
"""
from __future__ import annotations

from ..backend import FITNESS_BACKENDS as BACKENDS, pick
from .kernel import pop_mlp_correct
from .ref import pop_mlp_correct_ref, pop_mlp_correct_tiled

__all__ = ["BACKENDS", "population_correct"]


def population_correct(pop, x_int, labels, *, spec, backend=None,
                       pop_tile: int = 64, sample_tile: int = 256,
                       n_valid_rows=None, n_valid_samples=None,
                       out_mask=None):
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts."""
    backend = pick("fitness", backend, pop.device)
    if backend == "kernel":
        return pop_mlp_correct(pop, x_int, labels, spec=spec,
                               n_valid_rows=n_valid_rows,
                               n_valid_samples=n_valid_samples,
                               out_mask=out_mask)
    if backend == "ref":
        return pop_mlp_correct_tiled(pop, x_int, labels, spec=spec,
                                     pop_tile=pop_tile,
                                     sample_tile=sample_tile,
                                     n_valid_rows=n_valid_rows,
                                     n_valid_samples=n_valid_samples,
                                     out_mask=out_mask)
    return pop_mlp_correct_ref(pop, x_int, labels, spec=spec,
                               out_mask=out_mask)
