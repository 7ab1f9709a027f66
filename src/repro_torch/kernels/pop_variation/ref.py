"""Plain PyTorch fused variation pass (the dispatcher's "ref" backend).

Given tournament-gathered parent pools, crossover → mutation → clip over
the counter-based slot draws of ``genome.gene_uniform`` — bit-identical to
the chained operators (``core.operators``, the "ops" oracle), since slot
draws are row/length-addressed.
"""
from __future__ import annotations

import torch

from ...core.genome import (GeneTable, gene_uniform, SLOT_CROSS_SWAP,
                            SLOT_MUT_DO, SLOT_MUT_VAL)


def pop_variation_ref(key_genes, pa, pb, do_cx, table: GeneTable, pm_gene):
    """pa, pb: (P/2, G) parent pools; do_cx: (P/2, 1) bool per-pair gate;
    pm_gene: () float32 → (P, G) int32 children."""
    P2, G = pa.shape
    P = 2 * P2
    swap = do_cx & (gene_uniform(key_genes, table.ids, P2,
                                 slot=SLOT_CROSS_SWAP) < 0.5)
    children = torch.cat([torch.where(swap, pb, pa),
                          torch.where(swap, pa, pb)], dim=0)
    do_mut = gene_uniform(key_genes, table.ids, P, slot=SLOT_MUT_DO) < pm_gene
    u_val = gene_uniform(key_genes, table.ids, P, slot=SLOT_MUT_VAL)
    bitpos = torch.floor(u_val * torch.clamp_min(table.mask_bits, 1)).to(torch.int32)
    flipped = torch.bitwise_xor(children, torch.bitwise_left_shift(
        torch.ones_like(bitpos), bitpos))
    lo = table.low.to(torch.float32)
    hi = table.high.to(torch.float32)
    reset = torch.floor(lo + u_val * (hi - lo)).to(torch.int32)
    children = torch.where(do_mut, torch.where(table.is_mask, flipped, reset),
                           children)
    return torch.minimum(torch.maximum(children, table.low), table.high - 1)
