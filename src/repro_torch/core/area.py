"""FA-count hardware-cost model (paper §III-C, Eq. (2)), PyTorch port of
``repro.core.area``.

Area(θ) = Σ_{l,j} AdderArea(θ_j^{(l)}): the non-zero bits of every (masked,
shifted) summand and of the bias are histogrammed per adder column, reduced
3:2 for a fixed number of rounds, and the final carry-propagate row adds one
FA per column still ≥ 2 high. All integer, batched over the population and
the neurons of a layer at once.

Column guard: the reference raises on eager input whose ``shift + bit``
overflows the column budget and clamps into the top column under jit; every
main-path call runs under jit, so the port always clamps (a raise would need
a host read of the data on the card). Genes within their bounds never reach
the clamp; the eager raise is not carried over.
"""
from __future__ import annotations

import torch

from .genome import GenomeSpec

# --- EGFET calibration (constants only set absolute scale) ---
EGFET_FA_AREA_CM2 = 0.008   # cm² per full adder
EGFET_FA_POWER_MW = 0.027   # mW  per full adder (1 V)

_N_COLS = 32          # column budget: in_bits(≤8) + max shift(6) + log2 fan-in + carries
_REDUCE_ROUNDS = 16   # ≥ log_{3/2}(max column height); 16 covers height ≤ 2^9


def _column_histogram(masks, exps, bias, bshift, in_bits: int) -> torch.Tensor:
    """Non-zero bit count per adder column for every neuron.

    masks, exps: (P, fan_in, fan_out) int32; bias: (P, fan_out);
    bshift: (P,) → (P, fan_out, _N_COLS) int32. Summand i sets column
    ``j + k_i`` for each set bit j of its mask; the bias sets the columns
    ``[bshift, bshift + bias_bits)`` holding its |magnitude| bits."""
    P, fi, fo = masks.shape
    dev = masks.device
    j = torch.arange(in_bits, dtype=torch.int32, device=dev)
    bits = (masks[..., None] >> j) & 1                          # (P, fi, fo, ib)
    col = torch.clamp(j + exps[..., None], 0, _N_COLS - 1)      # column guard
    cols = torch.zeros(P, fo, _N_COLS, dtype=torch.int32, device=dev)
    cols.scatter_add_(2, col.permute(0, 2, 1, 3).reshape(P, fo, fi * in_bits).long(),
                      bits.permute(0, 2, 1, 3).reshape(P, fo, fi * in_bits))
    bmag = torch.abs(bias)[..., None]                           # (P, fo, 1)
    c = torch.arange(_N_COLS, dtype=torch.int32, device=dev)
    bsh = bshift[:, None, None]
    shift_amt = torch.clamp(c - bsh, 0, 30)
    bbits = (bmag >> shift_amt) & 1
    return cols + torch.where(c >= bsh, bbits, 0)


def _reduce_columns(cols: torch.Tensor):
    """3:2 reduction until all columns ≤ 2 high; returns (n_FA, final cols)
    over the leading axes."""
    total = torch.zeros(cols.shape[:-1], dtype=torch.int32, device=cols.device)
    for _ in range(_REDUCE_ROUNDS):
        fa = cols // 3
        rem = cols - 2 * fa                      # 3 eaten, 1 sum bit stays
        carries = torch.nn.functional.pad(fa[..., :-1], (1, 0))
        cols = rem + carries
        total = total + fa.sum(-1, dtype=torch.int32)
    # final two-row carry-propagate adder: one FA per column still ≥ 2 high
    cpa = (cols >= 2).sum(-1, dtype=torch.int32)
    return total + cpa, cols


def population_area(spec: GenomeSpec, pop: torch.Tensor) -> torch.Tensor:
    """FA counts for a population (P, n_genes) → (P,) int32."""
    total = torch.zeros(pop.shape[0], dtype=torch.int32, device=pop.device)
    for l, sl in enumerate(spec.layers):
        masks, _, exps, bias, bshift, _ = spec.layer_params(pop, l)
        cols = _column_histogram(masks, exps, bias, bshift, sl.in_bits)
        n_fa, _ = _reduce_columns(cols)
        total = total + n_fa.sum(-1, dtype=torch.int32)
    return total


def mlp_fa_count(spec: GenomeSpec, genome: torch.Tensor) -> torch.Tensor:
    """Total FA count of one chromosome (Eq. (2))."""
    return population_area(spec, genome[None])[0]
