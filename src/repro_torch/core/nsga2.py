"""Vectorised NSGA-II primitives (Deb et al. 2002) — paper §IV-A.

PyTorch port of ``repro.core.nsga2``: the constrained-dominance matrix and
front peel (the O(P²) oracle of the ranking dispatcher), crowding distance,
binary tournaments and (μ+λ) survivor truncation.

Sorting: ``jnp.argsort``/``jnp.lexsort`` are stable, so every sort here is
``torch.sort(stable=True)`` and :func:`lexsort` chains stable sorts from
the last key to the first (numpy's convention: the last key is primary).
Signed zeros: torch orders ``-0.0`` and ``+0.0`` as equal, and no sort key
here ever holds both. Objectives are ``1 - acc`` (``1 - 1`` is ``+0.0``)
and an int FA count cast to float (``+0.0``); violations are
``max(0, ·)`` of a difference that is never ``-0.0``; and ``-crowd`` holds
only ``-0.0`` zeros, since every crowding distance is ``+0.0`` or a sum of
non-negative terms.
"""
from __future__ import annotations

import torch

from . import prng


def lexsort(keys) -> torch.Tensor:
    """Stable indirect sort on several keys, the LAST one primary (as
    ``jnp.lexsort``). Bool keys sort False first."""
    idx = None
    for k in keys:
        k = k.to(torch.int32) if k.dtype == torch.bool else k
        kk = k if idx is None else k[idx]
        o = torch.sort(kk, stable=True).indices
        idx = o if idx is None else idx[o]
    return idx


def dominance_matrix(obj: torch.Tensor, viol: torch.Tensor) -> torch.Tensor:
    """dom[i, j] = True iff i constrained-dominates j."""
    feas = viol <= 0.0
    le = torch.all(obj[:, None, :] <= obj[None, :, :], dim=-1)
    lt = torch.any(obj[:, None, :] < obj[None, :, :], dim=-1)
    obj_dom = le & lt
    fi, fj = feas[:, None], feas[None, :]
    vi, vj = viol[:, None], viol[None, :]
    dom = (fi & ~fj) | (~fi & ~fj & (vi < vj)) | (fi & fj & obj_dom)
    return dom & ~torch.eye(obj.shape[0], dtype=torch.bool, device=obj.device)


def nondominated_rank(dom: torch.Tensor) -> torch.Tensor:
    """Front index per individual (0 = best) by peeling zero-indegree
    nodes; the float32 peel product is integer-exact (counts ≤ P < 2²⁴).
    The loop tests its condition on the host each front: this is the
    oracle path, the sweep (``kernels.pop_ranking``) is the fast one."""
    P = dom.shape[0]
    unranked = P
    domf = dom.to(torch.float32)
    rank = torch.full((P,), unranked, dtype=torch.int32, device=dom.device)
    n_dom = domf.sum(dim=0)
    r = 0
    while r < P and bool((rank == unranked).any()):
        front = (n_dom == 0.0) & (rank == unranked)
        rank = torch.where(front, r, rank)
        removed = front.to(torch.float32) @ domf
        n_dom = torch.where(front, float(P + 1), n_dom - removed)
        r += 1
    return rank


def crowding_distance(obj: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance with per-front normalisation (boundaries +inf)."""
    P, M = obj.shape
    dev = obj.device
    dist = torch.zeros(P, dtype=torch.float32, device=dev)
    rank_l = rank.long()
    false = torch.zeros(1, dtype=torch.bool, device=dev)
    for m in range(M):
        key = obj[:, m].to(torch.float32)
        order = lexsort((key, rank))
        skey, srank = key[order], rank_l[order]
        same = srank[1:] == srank[:-1]
        same_prev = torch.cat([false, same])
        same_next = torch.cat([same, false])
        prev_val = torch.cat([skey[:1], skey[:-1]])
        next_val = torch.cat([skey[1:], skey[-1:]])
        # segment min/max over fronts; empty segments keep ±inf (JAX's identities)
        fmin = torch.full((P + 1,), float("inf"), device=dev).scatter_reduce(
            0, rank_l, key, "amin", include_self=False)
        fmax = torch.full((P + 1,), float("-inf"), device=dev).scatter_reduce(
            0, rank_l, key, "amax", include_self=False)
        denom = torch.clamp_min((fmax - fmin)[srank], 1e-12)
        contrib = torch.where(same_prev & same_next,
                              (next_val - prev_val) / denom, float("inf"))
        dist[order] += contrib          # order is a permutation: no collisions
    return dist


def ranking_from_dom(dom: torch.Tensor, obj: torch.Tensor):
    """(rank, crowd) from a precomputed dominance matrix."""
    rank = nondominated_rank(dom)
    return rank, crowding_distance(obj, rank)


def evaluate_ranking(obj: torch.Tensor, viol: torch.Tensor):
    return ranking_from_dom(dominance_matrix(obj, viol), obj)


def subset_ranking(dom: torch.Tensor, obj: torch.Tensor, keep: torch.Tensor):
    """Re-rank the ``keep`` subset reusing the pool's dominance matrix
    (constrained dominance is pairwise)."""
    return ranking_from_dom(dom[keep][:, keep], obj[keep])


def tournament_select(key, rank, crowd, n: int) -> torch.Tensor:
    """Binary tournaments → (n,) parent indices."""
    P = rank.shape[0]
    idx = prng.randint(key, (n, 2), 0, P).long()
    a, b = idx[:, 0], idx[:, 1]
    a_wins = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] > crowd[b]))
    return torch.where(a_wins, a, b)


def survivor_select(rank, crowd, mu: int) -> torch.Tensor:
    """Top-μ indices by (rank ↑, crowding ↓)."""
    return lexsort((-crowd, rank))[:mu]
