"""Public op: one full NSGA-II generation with backend dispatch.

Backends (``GAConfig.backends.generation``):
  "auto"   — the megakernel path on a CUDA tensor, "ref" elsewhere (default)
  "kernel" — variation + fitness fused in the CUDA kernel
             ``pop_generation_kernel`` (CUDA tensors only; its ``n_dev``
             branch under device-variation fitness)
  "ref"    — the plain generation with the cross-generation EvalCache
  "phases" — the per-phase chain (variation dispatcher → within-generation
             dedup → ranking), cache untouched

All backends give identical states. The accounting aux differs by design:
the kernel path evaluates every child (n_eval = P, n_hit = 0) and carries
the cache through untouched; "ref" reports genuine evaluations and hits.
On a batched problem every backend launches each of its kernels once per
generation for all lanes.
"""
from __future__ import annotations

import torch

from ...core import prng
from ..backend import GENERATION_BACKENDS as BACKENDS, pick
from ..pop_variation.ops import lane_frames
from .kernel import pop_generation_kernel
from .ref import _rank_and_select, pop_generation_ref

__all__ = ["BACKENDS", "generation_lanes", "population_generation"]


def _generation_kernel_lanes(problem, lanes, states):
    """Megakernel path: parent gather in PyTorch per lane, variation +
    fitness of every lane in one launch, ranking through the
    ``pop_ranking`` dispatcher per lane."""
    from ...core import engine  # lazy: engine dispatches back into us

    cfg = problem.cfg
    d = engine.lane_data(problem)
    split = [prng.split(s.key) for s in states]
    a_rows, b_rows, do_rows, keys = lane_frames(
        torch.stack([k_off for _, k_off in split]), torch.stack([s.pop for s in states]),
        torch.stack([s.rank for s in states]), torch.stack([s.crowd for s in states]),
        d.crossover_rate)
    t = d.genes
    children, child_counts = pop_generation_kernel(
        a_rows, b_rows, do_rows, t.low, t.high, t.is_mask, t.mask_bits, t.ids, keys,
        d.mutation_rate_gene, d.x, d.labels, spec=problem.spec,
        n_valid_samples=d.n_valid_samples, out_mask=d.out_mask, dev=d.deltas)
    dedup = engine.dedup_mode(cfg) != "off"
    out = []
    for p, s, (key, _), ch, cc in zip(lanes, states, split, children, child_counts):
        P = s.pop.shape[0]
        pop = torch.cat([s.pop, ch], dim=0)
        if dedup:
            counts = torch.cat([s.counts, cc])
        else:   # unused placeholders of the state's count shape ((P,) or (P, K))
            counts = torch.zeros((2 * P,) + s.counts.shape[1:], dtype=torch.int32,
                                 device=pop.device)
        c_obj, c_viol = engine.objectives(p, ch, engine.counts_accuracy(p, cc))
        n_eval = torch.tensor(P, dtype=torch.int32, device=pop.device)
        n_hit = torch.zeros((), dtype=torch.int32, device=pop.device)
        out.append(_rank_and_select(s, pop, counts, c_obj, c_viol, key, s.cache,
                                    n_eval, n_hit, backend=cfg.backends.ranking))
    return [o[0] for o in out], [o[1] for o in out]


def generation_lanes(problem, lanes, states, *, backend=None):
    """One generation of every lane of ``problem`` (``lanes``: its single
    problems, ``states``: one GAState each) → (new states, auxes), lists
    with one entry per lane. ``backend`` overrides
    ``problem.cfg.backends.generation``."""
    if backend is None:
        backend = problem.cfg.backends.generation
    backend = pick("generation", backend, problem.device)
    if backend in ("ref", "phases"):
        return pop_generation_ref(problem, lanes, states, use_cache=backend == "ref")
    return _generation_kernel_lanes(problem, lanes, states)


def population_generation(problem, state, *, backend=None):
    """(Problem, GAState) → (new GAState, aux) — ONE (μ+λ) generation;
    aux = (best_err, best_area, n_eval, n_hit), each with the lane axis on
    a batched problem. ``backend`` overrides
    ``problem.cfg.backends.generation``."""
    from ...core import engine

    new, aux = generation_lanes(problem, problem.lanes(),
                                engine.split_state(problem, state), backend=backend)
    return engine.join_lanes(problem, new, aux)
