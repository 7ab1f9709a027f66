"""Public op: constrained NSGA-II ranking with backend dispatch.

Backends (``GAConfig.backends.ranking``):
  "auto"   — the sweep (ranking has no kernel and no device split)
  "sweep"  — the O(P log P) sort-and-sweep (``pop_ranking.sweep``)
  "matrix" — the dominance-matrix + front-peel oracle (``core.nsga2``)

Both give identical ranks, crowding and survivors (the front index is a
well-defined integer; crowding and selection are shared downstream).
"""
from __future__ import annotations

import torch

from ...core.nsga2 import (crowding_distance, dominance_matrix,
                           evaluate_ranking, ranking_from_dom,
                           subset_ranking, survivor_select)
from ..backend import RANKING_BACKENDS as BACKENDS, pick
from .sweep import sweep_rank, sweep_ranking

__all__ = ["BACKENDS", "fold_objectives", "population_ranking",
           "rank_select_rerank"]


def fold_objectives(obj):
    """(N, 3) [nominal err, area, robust err] → (N, 2) exact lexicographic
    fold ``dense_rank(e_nom) * N + dense_rank(e_rob)`` (float32-exact for
    N ≤ 4096); (N, 2) passes through untouched."""
    if obj.shape[-1] == 2:
        return obj
    if obj.shape[-1] != 3:
        raise ValueError(f"ranking expects 2 or 3 objectives, got "
                         f"M={obj.shape[-1]}")
    n = obj.shape[0]
    if n > 4096:
        raise ValueError(f"the 3-objective fold is float32-exact only for "
                         f"pools of at most 4096, got {n}")

    def dense(col):
        col = col.contiguous()
        return torch.searchsorted(torch.sort(col).values, col, side="left")

    comp = (dense(obj[:, 0]) * n + dense(obj[:, 2])).to(torch.float32)
    return torch.stack([comp, obj[:, 1]], dim=-1)


def population_ranking(obj, viol, *, backend: str | None = None):
    """(P, 2|3) objectives + (P,) violations → ((P,) rank, (P,) crowd)."""
    obj = fold_objectives(obj)
    if pick("ranking", backend, obj.device) == "sweep":
        return sweep_ranking(obj, viol)
    return evaluate_ranking(obj, viol)


def rank_select_rerank(obj, viol, mu: int, *, backend: str | None = None):
    """Rank the pool, keep the top-``mu`` by (rank ↑, crowding ↓), re-rank
    the survivors → (keep, rank, crowd)."""
    obj = fold_objectives(obj)
    if pick("ranking", backend, obj.device) == "sweep":
        rank, crowd = sweep_ranking(obj, viol)
        keep = survivor_select(rank, crowd, mu)
        rank2 = sweep_rank(obj[keep], viol[keep])
        return keep, rank2, crowding_distance(obj[keep], rank2)
    dom = dominance_matrix(obj, viol)
    rank, crowd = ranking_from_dom(dom, obj)
    keep = survivor_select(rank, crowd, mu)
    rank2, crowd2 = subset_ranking(dom, obj, keep)
    return keep, rank2, crowd2
