"""Plain PyTorch population fitness.

``pop_mlp_correct_ref``   — the untiled oracle (materializes
                            (pop, samples, fan_in, fan_out) intermediates).
``pop_mlp_correct_tiled`` — the tiled path: population and sample tiles keep
                            intermediates small, and the dedup/suite bounds
                            cut the work. It is also the plain version of the
                            CUDA kernel ``pop_mlp_correct``.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from ...core.mlp import population_accuracy, population_correct_counts


def pop_mlp_correct_ref(pop, x_int, labels, *, spec: GenomeSpec,
                        out_mask=None):
    acc = population_accuracy(spec, pop, x_int, labels, out_mask=out_mask)
    return torch.round(acc * labels.shape[0]).to(torch.int32)


def _bound(v, n: int) -> int:
    """A row/sample bound as a host int clamped to [0, n] (reads a device
    scalar back: the plain path may synchronise, the kernel never does)."""
    return n if v is None else max(0, min(n, int(v)))


def pop_mlp_correct_tiled(pop, x_int, labels, *, spec: GenomeSpec,
                          pop_tile: int = 64, sample_tile: int = 256,
                          n_valid_rows=None, n_valid_samples=None,
                          out_mask=None):
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts, tiled.

    Rows at or past ``n_valid_rows`` are not evaluated and count 0 (the
    reference leaves them unspecified; callers overwrite them). Samples at
    or past ``n_valid_samples`` are not counted; the reference skips whole
    sample tiles past it, which gives the same counts whenever those
    samples are padding (label −1), the only way the engine sets it.
    ``out_mask`` pins invalid output columns (``core.mlp.mask_logits``).
    """
    P = pop.shape[0]
    n_rows = _bound(n_valid_rows, P)
    n_samp = _bound(n_valid_samples, labels.shape[0])
    counts = torch.zeros(P, dtype=torch.int32, device=pop.device)
    for p0 in range(0, n_rows, pop_tile):
        rows = pop[p0:min(p0 + pop_tile, n_rows)]
        for s0 in range(0, n_samp, sample_tile):
            s1 = min(s0 + sample_tile, n_samp)
            counts[p0:p0 + rows.shape[0]] += population_correct_counts(
                spec, rows, x_int[s0:s1], labels[s0:s1], out_mask=out_mask)
    return counts
