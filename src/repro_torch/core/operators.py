"""Genetic operators on flat integer chromosomes (paper §IV-A), PyTorch
port of ``repro.core.operators``.

Mask genes mutate by single-bit flips, every other gene by a bounded random
reset. All gene-shaped randomness goes through
:func:`genome.gene_uniform`, addressed by (key, draw slot, table id, row),
and one generation key splits via :func:`variation_keys` into the
tournament, crossover-do and gene-draw keys. That shared schedule makes
this chain of separate operator calls (the variation dispatcher's "ops"
oracle) bit-identical to the fused paths and to the CUDA kernel.
"""
from __future__ import annotations

import torch

from . import prng
from .genome import (GenomeSpec, GeneTable, gene_uniform,
                     SLOT_CROSS_SWAP, SLOT_MUT_DO, SLOT_MUT_VAL)
from .nsga2 import tournament_select


def _as_table(genes, device) -> GeneTable:
    return genes.table(device) if isinstance(genes, GenomeSpec) else genes


def variation_keys(key):
    """(k_sel, k_cx, k_var): tournament, crossover-do, and gene-draw keys."""
    return tuple(prng.split(key, 3))


def uniform_crossover(key_do, key_genes, a, b, pc, ids: torch.Tensor):
    """Pairwise uniform crossover of (n, genes) parent pools."""
    do = prng.uniform(key_do, (a.shape[0], 1)) < pc
    take_b = gene_uniform(key_genes, ids, a.shape[0], slot=SLOT_CROSS_SWAP) < 0.5
    child1 = torch.where(do & take_b, b, a)
    child2 = torch.where(do & take_b, a, b)
    return child1, child2


def mutate(key_genes, pop: torch.Tensor, genes, pm_gene) -> torch.Tensor:
    """Per-gene mutation: bit-flip for masks, random reset otherwise; one
    value draw serves as the flipped-bit position or the reset value."""
    t = _as_table(genes, pop.device)
    P = pop.shape[0]
    do = gene_uniform(key_genes, t.ids, P, slot=SLOT_MUT_DO) < pm_gene
    u = gene_uniform(key_genes, t.ids, P, slot=SLOT_MUT_VAL)
    bitpos = torch.floor(u * torch.clamp_min(t.mask_bits, 1)).to(torch.int32)
    flipped = torch.bitwise_xor(pop, torch.bitwise_left_shift(
        torch.ones_like(bitpos), bitpos))
    lo = t.low.to(torch.float32)
    hi = t.high.to(torch.float32)
    reset = torch.floor(lo + u * (hi - lo)).to(torch.int32)
    mutated = torch.where(t.is_mask, flipped, reset)
    return torch.where(do, mutated, pop)


def clip_genes(pop: torch.Tensor, genes) -> torch.Tensor:
    """Clamp to [low, high); pins padding genes to the canonical zero."""
    t = _as_table(genes, pop.device)
    return torch.minimum(torch.maximum(pop, t.low), t.high - 1)


def make_offspring(key, pop: torch.Tensor, rank, crowd, genes,
                   pc, pm_gene) -> torch.Tensor:
    """Tournament → crossover → mutation → clip as chained operator calls."""
    t = _as_table(genes, pop.device)
    P = pop.shape[0]
    k_sel, k_cx, k_var = variation_keys(key)
    parents = tournament_select(k_sel, rank, crowd, P)
    pa = pop[parents[: P // 2]]
    pb = pop[parents[P // 2:]]
    c1, c2 = uniform_crossover(k_cx, k_var, pa, pb, pc, t.ids)
    children = torch.cat([c1, c2], dim=0)
    children = mutate(k_var, children, t, pm_gene)
    return clip_genes(children, t)
