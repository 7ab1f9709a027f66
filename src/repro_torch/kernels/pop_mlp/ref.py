"""Plain PyTorch population fitness.

``pop_mlp_correct_ref``   — the untiled oracle (materializes
                            (pop, samples, fan_in, fan_out) intermediates).
``pop_mlp_correct_tiled`` — the tiled path: population and sample tiles keep
                            intermediates small, and the dedup/suite bounds
                            cut the work. It is also the plain version of the
                            CUDA kernel ``pop_mlp_correct``.
``pop_mlp_correct_mc``    — the same tiling over K device instances → (P, K);
                            the plain version of ``pop_mlp_correct_mc``'s
                            CUDA kernel.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from ...core.mlp import (population_accuracy, population_correct_counts,
                         population_correct_counts_mc)


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
    count = lambda rows, x, y: population_correct_counts(spec, rows, x, y,
                                                         out_mask=out_mask)
    return _tiled(count, (), pop, x_int, labels, pop_tile, sample_tile,
                  n_valid_rows, n_valid_samples)


def pop_mlp_correct_mc(pop, x_int, labels, *, spec: GenomeSpec, dev,
                       gene_high, pop_tile: int = 64, sample_tile: int = 256,
                       n_valid_rows=None, n_valid_samples=None,
                       out_mask=None):
    """(P, G) × (K, G) deltas → (P, K) int32 correct counts, tiled as
    :func:`pop_mlp_correct_tiled`. ``n_valid_rows`` counts chromosomes: a
    row past it is not evaluated on any instance (all K columns 0). Column
    k equals the nominal count of ``apply_device_deltas(pop, dev[k],
    gene_high)``; ``dev``'s row 0 is all zero, so column 0 is nominal."""
    count = lambda rows, x, y: population_correct_counts_mc(
        spec, rows, dev, gene_high, x, y, out_mask=out_mask)
    return _tiled(count, (dev.shape[0],), pop, x_int, labels, pop_tile,
                  sample_tile, n_valid_rows, n_valid_samples)


def _tiled(count, val_shape, pop, x_int, labels, pop_tile, sample_tile,
           n_valid_rows, n_valid_samples):
    """Sum ``count(rows, x, y)`` over population and sample tiles inside
    the row and sample bounds into a zeroed (P,) + val_shape tensor."""
    P = pop.shape[0]
    n_rows = _bound(n_valid_rows, P)
    n_samp = _bound(n_valid_samples, labels.shape[0])
    counts = torch.zeros((P,) + val_shape, dtype=torch.int32, device=pop.device)
    for p0 in range(0, n_rows, pop_tile):
        rows = pop[p0:min(p0 + pop_tile, n_rows)]
        for s0 in range(0, n_samp, sample_tile):
            s1 = min(s0 + sample_tile, n_samp)
            counts[p0:p0 + rows.shape[0]] += count(rows, x_int[s0:s1], labels[s0:s1])
    return counts
