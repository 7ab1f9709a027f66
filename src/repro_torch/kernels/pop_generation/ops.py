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
"""
from __future__ import annotations

import torch

from ...core import prng
from ...core.genome import _slot_keys
from ..backend import GENERATION_BACKENDS as BACKENDS, pick
from ..pop_variation.ops import _VARIATION_SLOTS, parent_frame
from .kernel import pop_generation_kernel
from .ref import pop_generation_ref, _rank_and_select

__all__ = ["BACKENDS", "population_generation"]


def _generation_kernel(problem, state):
    """Megakernel path: parent gather in PyTorch, variation + fitness in
    one launch, ranking through the ``pop_ranking`` dispatcher."""
    from ...core import engine  # lazy: engine dispatches back into us

    cfg = problem.cfg
    t = problem.genes
    P = state.pop.shape[0]
    key, k_off = prng.split(state.key)
    a_rows, b_rows, do_rows, k_var = parent_frame(
        k_off, state.pop, state.rank, state.crowd, problem.crossover_rate)
    children, child_counts = pop_generation_kernel(
        a_rows, b_rows, do_rows, t.low, t.high, t.is_mask, t.mask_bits,
        t.ids, _slot_keys(k_var, _VARIATION_SLOTS),
        problem.mutation_rate_gene, problem.x_int, problem.labels,
        spec=problem.spec, n_valid_samples=problem.n_valid_samples,
        out_mask=problem.out_mask,
        dev=engine.device_deltas(problem) if engine.variation_on(cfg) else None)
    pop = torch.cat([state.pop, children], dim=0)
    if engine.dedup_mode(cfg) != "off":
        counts = torch.cat([state.counts, child_counts])
    else:   # unused placeholders of the state's count shape ((P,) or (P, K))
        counts = torch.zeros((2 * P,) + state.counts.shape[1:], dtype=torch.int32,
                             device=pop.device)
    c_obj, c_viol = engine.objectives(
        problem, children, engine.counts_accuracy(problem, child_counts))
    n_eval = torch.tensor(P, dtype=torch.int32, device=pop.device)
    n_hit = torch.zeros((), dtype=torch.int32, device=pop.device)
    return _rank_and_select(state, pop, counts, c_obj, c_viol, key,
                            state.cache, n_eval, n_hit,
                            backend=cfg.backends.ranking)


def population_generation(problem, state, *, backend=None):
    """(Problem, GAState) → (new GAState, aux) — ONE (μ+λ) generation;
    aux = (best_err, best_area, n_eval, n_hit). ``backend`` overrides
    ``problem.cfg.backends.generation``."""
    if backend is None:
        backend = problem.cfg.backends.generation
    backend = pick("generation", backend, state.pop.device)
    if backend == "ref":
        return pop_generation_ref(problem, state, use_cache=True)
    if backend == "phases":
        return pop_generation_ref(problem, state, use_cache=False)
    return _generation_kernel(problem, state)
