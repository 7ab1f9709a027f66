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

With ``dev`` ((K, G) device-variation deltas, ``engine.device_deltas``)
and ``gene_high`` ((G,) exclusive gene bounds) every chromosome is scored
on the K perturbed device instances: (P, K) counts, through the CUDA
kernel ``pop_mlp_correct_mc`` ("kernel") or its tiled plain version
("ref"). The "jnp" oracle has no instance axis and rejects ``dev``.
"""
from __future__ import annotations

import torch

from .. import _cuda
from ..backend import FITNESS_BACKENDS as BACKENDS, pick
from .kernel import pop_mlp_correct, pop_mlp_correct_mc
from .ref import pop_mlp_correct_ref, pop_mlp_correct_tiled
from .ref import pop_mlp_correct_mc as pop_mlp_correct_mc_ref

__all__ = ["BACKENDS", "population_correct"]


def population_correct(pop, x_int, labels, *, spec, backend=None,
                       pop_tile: int = 64, sample_tile: int = 256,
                       n_valid_rows=None, n_valid_samples=None,
                       out_mask=None, dev=None, gene_high=None):
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts, or (P, K)
    with ``dev``.

    With a leading lane axis on every operand — pop (L, P, G), x_int
    (L, S, n_in), labels (L, S), n_valid_samples (L,), out_mask (L, n_out),
    dev (L, K, G), gene_high (L, G) — each lane is scored on its own data
    → (L, P) or (L, P, K); ``n_valid_rows`` bounds every lane. The
    "kernel" backend scores all lanes in one launch."""
    backend = pick("fitness", backend, pop.device)
    if pop.dim() == 3 and backend != "kernel":
        at = _cuda.lane_item
        return torch.stack([population_correct(
            pop[i], x_int[i], labels[i], spec=spec, backend=backend, pop_tile=pop_tile,
            sample_tile=sample_tile, n_valid_rows=n_valid_rows,
            n_valid_samples=at(n_valid_samples, i), out_mask=at(out_mask, i),
            dev=at(dev, i), gene_high=at(gene_high, i)) for i in range(pop.shape[0])])
    if dev is not None:
        if backend == "jnp":
            raise ValueError("the 'jnp' fitness oracle has no "
                             "device-instance axis; use ref/kernel/auto "
                             "for dev != None")
        if gene_high is None:
            raise ValueError("dev needs gene_high (per-gene exclusive "
                             "upper bounds, GeneTable.high)")
        if backend == "kernel":
            return pop_mlp_correct_mc(pop, x_int, labels, dev, gene_high,
                                      spec=spec, n_valid_rows=n_valid_rows,
                                      n_valid_samples=n_valid_samples,
                                      out_mask=out_mask)
        return pop_mlp_correct_mc_ref(pop, x_int, labels, spec=spec, dev=dev,
                                      gene_high=gene_high, pop_tile=pop_tile,
                                      sample_tile=sample_tile,
                                      n_valid_rows=n_valid_rows,
                                      n_valid_samples=n_valid_samples,
                                      out_mask=out_mask)
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
