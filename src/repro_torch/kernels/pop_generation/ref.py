"""Plain PyTorch generation step (the reference's ``pop_generation_jnp``).

One NSGA-II (μ+λ) generation: variation (through the variation dispatcher)
→ duplicate-suppressed fitness → ranking → survivor selection.
``use_cache=True`` (the "ref" backend) routes fitness through the
cross-generation :class:`~repro_torch.core.dedup.EvalCache`;
``use_cache=False`` (the "phases" backend) is the per-phase chain with
within-generation dedup only and the cache carried through untouched.
Cached values are exact integer counts, so both give identical states.

Over the lanes of a batched problem the variation and the fitness are each
one dispatch for all lanes (one launch of each kernel on the card); the
tournament, the dedup packing, the objectives and the ranking run lane by
lane.
"""
from __future__ import annotations

import dataclasses

import torch

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


def pop_generation_ref(problem, lanes, states, use_cache: bool = True):
    """One generation of every lane of ``problem`` (``lanes``: its single
    problems, ``states``: one GAState each; one of each for a single
    problem) → (new states, auxes), one entry per lane; aux = (best_err,
    best_area, n_eval, n_hit)."""
    from ...core import engine, prng  # lazy: engine dispatches back into us

    cfg = problem.cfg
    d = engine.lane_data(problem)
    split = [prng.split(s.key) for s in states]
    children = population_variation(
        torch.stack([k_off for _, k_off in split]), torch.stack([s.pop for s in states]),
        torch.stack([s.rank for s in states]), torch.stack([s.crowd for s in states]),
        genes=d.genes, pc=d.crossover_rate, pm=d.mutation_rate_gene,
        backend=cfg.backends.variation)
    pops = [torch.cat([s.pop, ch], dim=0) for s, ch in zip(states, children)]

    mode = engine.dedup_mode(cfg)
    L = len(states)
    dev = problem.device
    caches = [s.cache for s in states]
    n_hits = [torch.zeros((), dtype=torch.int32, device=dev)] * L
    known = [s.counts for s in states]
    if mode == "cache" and use_cache and caches[0] is not None:
        res = engine.dedup_lanes(problem, lanes, pops, known=known, cache=caches,
                                 gen=[s.gen + 1 for s in states])
        counts, n_evals, n_hits, caches = map(list, zip(*res))
    elif mode != "off":
        counts, n_evals = map(list, zip(*engine.dedup_lanes(problem, lanes, pops,
                                                            known=known)))
    if mode != "off":
        P = states[0].pop.shape[0]
        scored = [engine.objectives(p, ch, engine.counts_accuracy(p, c[P:]))
                  for p, ch, c in zip(lanes, children, counts)]
    else:   # unused placeholders of the state's count shape ((P,) or (P, K))
        counts = [torch.zeros((pop.shape[0],) + s.counts.shape[1:], dtype=torch.int32,
                              device=dev) for s, pop in zip(states, pops)]
        scored = engine.fitness_lanes(problem, lanes, list(children))
        n_evals = [torch.tensor(ch.shape[0], dtype=torch.int32, device=dev)
                   for ch in children]
    out = [_rank_and_select(s, pop, c, obj, viol, key, cache, n_eval, n_hit,
                            backend=cfg.backends.ranking)
           for s, pop, c, (obj, viol), (key, _), cache, n_eval, n_hit
           in zip(states, pops, counts, scored, split, caches, n_evals, n_hits)]
    return [o[0] for o in out], [o[1] for o in out]

