"""O(P log P) sweep-based constrained 2-objective NSGA-II front ranking.

PyTorch port of ``repro.kernels.pop_ranking.sweep`` (see its docstring for
the construction): feasible rows sort by (obj₀, obj₁) and are ranked by a
patience-sorting pass over an integer dominance key; infeasible rows peel
as dense violation layers after the last feasible front. Ranks equal
``nsga2.nondominated_rank(nsga2.dominance_matrix(obj, viol))``.

The reference's length-P ``lax.scan`` is a Python loop here. Each step is
a compare-and-sum plus a one-element ``scatter_reduce`` that stay on the
device (no host read), but on the card the loop makes a few small
launches per row: P = 512 rows make some two thousand launches per call.
"""
from __future__ import annotations

import torch

from ...core.nsga2 import crowding_distance, lexsort

_IMAX = 2**31 - 1


def _sort_and_key(obj: torch.Tensor, viol: torch.Tensor):
    """Feasible-first (k1, k2) lexsort + the integer dominance key."""
    P = obj.shape[0]
    feas = viol <= 0.0
    v = viol.to(torch.float32)
    k1 = torch.where(feas, obj[:, 0].to(torch.float32), v)
    k2 = torch.where(feas, obj[:, 1].to(torch.float32), v)
    order = lexsort((k2, k1, ~feas))
    k1s, k2s, fs = k1[order], k2[order], feas[order]
    newpair = torch.cat([torch.zeros(1, dtype=torch.int64, device=obj.device),
                         ((k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])).long()])
    pair_id = torch.cumsum(newpair, 0)
    f2 = torch.searchsorted(torch.sort(k2s).values, k2s, side="left")
    key = f2 * (P + 1) + pair_id
    return k1s, fs, key, order


def sweep_rank(obj: torch.Tensor, viol: torch.Tensor) -> torch.Tensor:
    """Constrained non-dominated front index per individual (0 = best);
    obj (P, 2), viol (P,) → (P,) int32."""
    P, M = obj.shape
    if M != 2:
        raise ValueError(f"sweep ranking is 2-objective only, got M={M}")
    dev = obj.device
    k1s, fs, key, order = _sort_and_key(obj, viol)

    # patience sort: staircase[r] = least key placed on front r so far. The
    # count of cells below a key is at most the number of steps already
    # taken, so the one-element scatter never leaves the table.
    staircase = torch.full((P,), _IMAX, dtype=torch.int64, device=dev)
    ranks_f = torch.empty(P, dtype=torch.int64, device=dev)
    put = torch.where(fs, key, _IMAX)       # infeasible rows place nothing
    for i in range(P):
        r = (staircase < key[i]).sum()
        ranks_f[i] = r
        staircase.scatter_reduce_(0, r.view(1), put[i].view(1), "amin")

    # infeasible layers start after the last feasible front
    prev_k1 = torch.cat([k1s[:1], k1s[:-1]])
    prev_f = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), fs[:-1]])
    n_fronts = torch.where(fs, ranks_f, -1).max() + 1
    first = torch.arange(P, device=dev) == 0
    new_layer = ~fs & (first | prev_f | (k1s != prev_k1))
    layer = torch.cumsum(new_layer.long(), 0) - 1
    rank_s = torch.where(fs, ranks_f, n_fronts + layer)
    out = torch.empty(P, dtype=torch.int32, device=dev)
    out[order] = rank_s.to(torch.int32)
    return out


def sweep_ranking(obj: torch.Tensor, viol: torch.Tensor):
    """(rank, crowd) via the sweep (crowding shared with the matrix path)."""
    rank = sweep_rank(obj, viol)
    return rank, crowding_distance(obj, rank)
