"""Plain PyTorch generation step (the reference's ``pop_generation_jnp``).

One NSGA-II (μ+λ) generation: variation (through the variation dispatcher)
→ duplicate-suppressed fitness → ranking → survivor selection.
``use_cache=True`` (the "ref" backend) routes fitness through the
cross-generation :class:`~repro_torch.core.dedup.EvalCache`;
``use_cache=False`` (the "phases" backend) is the per-phase chain with
within-generation dedup only and the cache carried through untouched.
Cached values are exact integer counts, so both give identical states.
"""
from __future__ import annotations

import dataclasses

import torch

from ...core.dedup import dedup_eval
from ..pop_ranking import rank_select_rerank
from ..pop_variation import population_variation


def _rank_and_select(state, pop, counts, c_obj, c_viol, key, cache,
                     n_eval, n_hit, backend=None):
    """Shared (μ+λ) tail: rank the pool, keep the best P, emit aux =
    (best_err, best_area, n_eval, n_hit)."""
    P = state.pop.shape[0]
    obj = torch.cat([state.obj, c_obj], dim=0)
    viol = torch.cat([state.viol, c_viol], dim=0)
    keep, rank2, crowd2 = rank_select_rerank(obj, viol, P, backend=backend)
    new = dataclasses.replace(state, pop=pop[keep], obj=obj[keep],
                              viol=viol[keep], rank=rank2, crowd=crowd2,
                              counts=counts[keep], key=key,
                              gen=state.gen + 1, cache=cache)
    aux = (new.obj[:, 0].min(), new.obj[:, 1].min(), n_eval, n_hit)
    return new, aux


def pop_generation_ref(problem, state, use_cache: bool = True):
    """One generation → (new_state, (best_err, best_area, n_eval, n_hit))."""
    from ...core import engine, prng  # lazy: engine dispatches back into us

    cfg = problem.cfg
    P = state.pop.shape[0]
    key, k_off = prng.split(state.key)
    children = population_variation(
        k_off, state.pop, state.rank, state.crowd, genes=problem.genes,
        pc=problem.crossover_rate, pm=problem.mutation_rate_gene,
        backend=cfg.backends.variation)
    pop = torch.cat([state.pop, children], dim=0)

    mode = engine.dedup_mode(cfg)
    cache = state.cache
    n_hit = torch.zeros((), dtype=torch.int32, device=pop.device)
    eval_fn = lambda rows, n: engine.population_counts(problem, rows, n)
    if mode == "cache" and use_cache and cache is not None:
        counts, n_eval, n_hit, cache = dedup_eval(
            eval_fn, pop, known=state.counts, gene_mask=problem.genes.valid,
            cache=cache, gen=state.gen + 1, ids=problem.genes.ids)
        c_obj, c_viol = engine.objectives(
            problem, children, engine.counts_accuracy(problem, counts[P:]))
    elif mode != "off":
        counts, n_eval = dedup_eval(
            eval_fn, pop, known=state.counts, gene_mask=problem.genes.valid,
            ids=problem.genes.ids)
        c_obj, c_viol = engine.objectives(
            problem, children, engine.counts_accuracy(problem, counts[P:]))
    else:   # unused placeholders of the state's count shape ((P,) or (P, K))
        counts = torch.zeros((2 * P,) + state.counts.shape[1:], dtype=torch.int32,
                             device=pop.device)
        c_obj, c_viol = engine.fitness(problem, children)
        n_eval = torch.tensor(P, dtype=torch.int32, device=pop.device)
    return _rank_and_select(state, pop, counts, c_obj, c_viol, key, cache,
                            n_eval, n_hit, backend=cfg.backends.ranking)
