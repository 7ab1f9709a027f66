"""Public op: fused GA variation with backend dispatch.

Backends (``GAConfig.backends.variation``):
  "auto"   — the CUDA kernel on a CUDA tensor, "ref" elsewhere (default)
  "kernel" — the CUDA kernel ``pop_variation_kernel`` (CUDA tensors only)
  "ref"    — the fused PyTorch path (``ref.pop_variation_ref``)
  "ops"    — the chained operator calls of ``core.operators`` (oracle)

All backends share the key schedule (``operators.variation_keys``) and the
gene-addressed draw contract, so they give identical children.
"""
from __future__ import annotations

import torch

from ...core.genome import (GenomeSpec, _slot_keys, SLOT_CROSS_SWAP,
                            SLOT_MUT_DO, SLOT_MUT_VAL)
from ...core import prng
from ...core.nsga2 import tournament_select
from ...core.operators import make_offspring, variation_keys
from ..backend import VARIATION_BACKENDS as BACKENDS, pick
from .kernel import pop_variation_kernel
from .ref import pop_variation_ref

__all__ = ["BACKENDS", "population_variation"]

_VARIATION_SLOTS = (SLOT_CROSS_SWAP, SLOT_MUT_DO, SLOT_MUT_VAL)


def parent_frame(key, pop, rank, crowd, pc):
    """Tournament parents and crossover gates of one offspring key, as the
    child frame → (a_rows, b_rows, do_rows, k_var).

    Row p < P/2 is pair p as (a=pa, b=pb); row P/2 + p the same pair with
    the roles flipped. ``k_var`` is the gene-draw key. The reference draws
    the per-pair gate at shape (P/2, 1) in its variation dispatcher and at
    (P/2,) in its generation kernel path: the same bits
    (``prng.random_bits``), so this one draw serves both."""
    P = pop.shape[0]
    if P % 2:
        raise ValueError(f"variation needs an even population, got {P}")
    k_sel, k_cx, k_var = variation_keys(key)
    parents = tournament_select(k_sel, rank, crowd, P)
    pa = pop[parents[: P // 2]]
    pb = pop[parents[P // 2:]]
    do_cx = prng.uniform(k_cx, (P // 2,)) < pc
    return (torch.cat([pa, pb], dim=0), torch.cat([pb, pa], dim=0),
            torch.cat([do_cx, do_cx]), k_var)


def population_variation(key, pop, rank, crowd, *, genes, pc, pm,
                         backend=None):
    """(P, G) population + ranking → (P, G) int32 children.

    key: the generation's offspring key (split via ``variation_keys``).
    pc / pm: () float32 crossover and per-gene mutation probabilities.
    genes: ``GeneTable`` (or a ``GenomeSpec``, whose identity table is used).
    """
    t = genes.table(pop.device) if isinstance(genes, GenomeSpec) else genes
    backend = pick("variation", backend, pop.device)
    P = pop.shape[0]
    if P % 2:
        raise ValueError(f"variation needs an even population, got {P}")
    if backend == "ops":
        return make_offspring(key, pop, rank, crowd, t, pc, pm)
    a_rows, b_rows, do_rows, k_var = parent_frame(key, pop, rank, crowd, pc)
    if backend == "ref":
        half = P // 2
        return pop_variation_ref(k_var, a_rows[:half], b_rows[:half],
                                 do_rows[:half, None], t, pm)
    return pop_variation_kernel(a_rows, b_rows, do_rows, t.low, t.high,
                                t.is_mask, t.mask_bits, t.ids,
                                _slot_keys(k_var, _VARIATION_SLOTS), pm)
