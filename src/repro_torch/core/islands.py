"""Island-parallel NSGA-II on a :class:`~repro_torch.launch.mesh.DeviceMesh`,
PyTorch port of ``repro.core.islands``.

The reference shards the population into one island per device with
``shard_map`` and moves migrants over a ``lax.ppermute`` ring. Here the
islands are the lanes of one batched problem on the mesh's device
(``engine.stack_problems``, as ``engine.run_batch`` stacks seeds), so each
generation launches every kernel of its path once for all islands:

  * island ``i`` initializes exactly like ``GATrainer`` with seed
    ``seed + i`` and ``island_pop`` rows; doping genomes dope every island
    alike;
  * each round runs ``migrate_every`` generations of every island through
    ``engine.run_scanned`` with ``gen`` reset to 0 (the EvalCache's
    eviction stamps restart each round, as in the reference); the key
    carries over and each island keeps its own cache;
  * then, with more than one island, each island's best ``n_migrants``
    rows (rank ascending, crowding descending, ties by index: the
    reference's ``jnp.lexsort((-crowd, rank))``) replace the worst rows of
    the next island along the last axis name (and, with two or more axis
    names, along the first too: islands laid out row-major over
    ``axis_names``), a ``torch.roll`` on the lane axis; rank and crowding
    are then recomputed. One island skips migration and the re-rank, so a
    1-island run is bit for bit a ``GATrainer.run`` of the same seed;
  * the global Pareto front is peeled on the host from the feasible rows
    of every island (the all-feasible fallback of ``GATrainer.front``).

Every island's carry is bit-identical to the reference's ``shard_map``
islands, round by round. Nothing is read back to the host inside a round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine, prng
from .dedup import EvalCache
from .engine import GAConfig, GAState, Problem
from .genome import GenomeSpec, MLPTopology
from .pareto import pareto_front
from .quantize import quantize_inputs
from ..launch import mesh as mesh_mod

__all__ = ["IslandConfig", "build_island_step", "run_islands"]


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    ga: GAConfig = GAConfig()
    island_pop: int = 64          # rows per island
    migrate_every: int = 10
    n_migrants: int = 4
    rounds: int = 10              # migration rounds; total gens = rounds × migrate_every


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(n, rows, ...) → (n·rows, ...)."""
    return t.reshape((-1,) + t.shape[2:])


def _lanes(t: torch.Tensor, n: int) -> torch.Tensor:
    """(n·rows, ...) → (n, rows, ...)."""
    return t.reshape((n, -1) + t.shape[1:])


def _carry_state(carry, n_islands: int, probes: int) -> GAState:
    """The batched GAState (one lane per island, ``gen`` 0) of a carry
    ``(pop, obj, viol, counts, rank, crowd, key[, rows, vals, stamp])``."""
    pop, obj, viol, counts, rank, crowd, key, *cache = carry
    lanes = lambda t: _lanes(t, n_islands)    # noqa: E731
    return GAState(lanes(pop), lanes(obj), lanes(viol), lanes(rank), lanes(crowd),
                   lanes(counts), key,
                   torch.zeros(n_islands, dtype=torch.int32, device=pop.device),
                   EvalCache(*map(lanes, cache), probes) if cache else None)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (n, m) of each island of ``t`` (n, rows, ...)."""
    return torch.take_along_dim(t, idx.reshape(idx.shape + (1,) * (t.dim() - 2)), dim=1)


def _put(t: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t`` with rows ``idx`` (n, m; distinct in each island) set to ``src``."""
    return t.scatter(1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand_as(src), src)


def _ring_order(rank: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """(n, rows) → each island's rows by rank ascending, then crowding
    descending, ties by index: ``jnp.lexsort((-crowd, rank))`` as two stable
    sorts (float keys compare as the reference's do: -0.0 equals 0.0)."""
    by_crowd = torch.argsort(-crowd, dim=-1, stable=True)
    by_rank = torch.argsort(torch.take_along_dim(rank, by_crowd, dim=-1), dim=-1,
                            stable=True)
    return torch.take_along_dim(by_crowd, by_rank, dim=-1)


def _send(payload: torch.Tensor, layout: tuple) -> torch.Tensor:
    """Each island's payload moved one step along the ring of the last
    axis name, then along the first (``ppermute`` i → i + 1 on each)."""
    grid = payload.reshape(layout + payload.shape[1:])
    grid = torch.roll(grid, 1, dims=len(layout) - 1)
    if len(layout) > 1:
        grid = torch.roll(grid, 1, dims=0)
    return grid.reshape(payload.shape)


def _migrate(cfg: IslandConfig, layout: tuple, pop, obj, viol, counts, rank, crowd):
    """Ring migration over the islands (n, rows, ...) → the new
    (pop, obj, viol, counts, rank, crowd)."""
    from ..kernels.pop_ranking import population_ranking  # lazy: kernels import core

    m = cfg.n_migrants
    order = _ring_order(rank, crowd)
    best, worst = order[:, :m], order[:, order.shape[1] - m:]
    pop, obj, viol, counts = (_put(t, worst, _send(_rows(t, best), layout))
                              for t in (pop, obj, viol, counts))
    ranked = [population_ranking(o, v, backend=cfg.ga.backends.ranking)
              for o, v in zip(obj, viol)]
    rank = torch.stack([r for r, _ in ranked])
    crowd = torch.stack([c for _, c in ranked])
    return pop, obj, viol, counts, rank, crowd


def build_island_step(spec: GenomeSpec, cfg: IslandConfig, mesh, x_int, labels,
                      baseline_acc: float, axis_names: tuple[str, ...] = ("data",)):
    """Returns (init_fn, round_fn) running one migration round per call.

    The carry holds the islands' rows flattened on the leading axis,
    ``(pop, obj, viol, counts, rank, crowd, key)`` with pop (n·island_pop,
    G), obj (n·island_pop, M), counts (n·island_pop,) or (n·island_pop, K)
    and key (n, 2), plus the islands' EvalCache slices ``(rows, vals,
    stamp)`` (n·slots, ...) in the default dedup mode: the reference's
    carry, leaf for leaf. ``init_fn(seed, doping_seeds=None)`` scores each
    island's initial population once; ``round_fn(*carry)`` returns the
    next carry."""
    mesh = mesh_mod.as_device_mesh(mesh)
    dev = mesh.device
    n = mesh.entries(axis_names)
    layout = tuple(mesh.shape[a] for a in axis_names)
    problem = Problem(torch.as_tensor(x_int, device=dev).to(torch.int32),
                      torch.as_tensor(labels, device=dev).to(torch.int32),
                      torch.tensor(baseline_acc, dtype=torch.float32, device=dev),
                      spec, cfg.ga)
    # one lane per island, every lane the same problem
    batched = engine.stack_problems([engine.batch_problem(problem)] * n)

    def init(seed: int, doping_seeds=None):
        keys = torch.stack([prng.PRNGKey(seed + i, dev) for i in range(n)])
        states, _ = engine.init_state(batched, keys, doping_seeds, cfg.island_pop)
        carry = tuple(map(_flat, (states.pop, states.obj, states.viol, states.counts,
                                  states.rank, states.crowd))) + (states.key,)
        if states.cache is not None:
            carry += tuple(map(_flat, (states.cache.rows, states.cache.vals,
                                       states.cache.stamp)))
        return carry

    def round_fn(*carry):
        state = _carry_state(carry, n, cfg.ga.cache_probes)
        state, _ = engine.run_scanned(batched, state, cfg.migrate_every)
        leaves = (state.pop, state.obj, state.viol, state.counts, state.rank, state.crowd)
        if n > 1:
            leaves = _migrate(cfg, layout, *leaves)
        out = tuple(map(_flat, leaves)) + (state.key,)
        if state.cache is not None:   # migrants carry their counts; caches stay local
            out += tuple(map(_flat, (state.cache.rows, state.cache.vals,
                                     state.cache.stamp)))
        return out

    return init, round_fn


def run_islands(topo: MLPTopology, x01, labels, mesh,
                cfg: IslandConfig | None = None, baseline_acc: float = 1.0,
                axis_names: tuple[str, ...] = ("data",), seed: int = 0,
                doping_seeds=None):
    """Drive ``rounds`` migration rounds on ``mesh``'s device and return
    (the global Pareto front, the GenomeSpec)."""
    cfg = cfg if cfg is not None else IslandConfig()
    mesh = mesh_mod.as_device_mesh(mesh)
    spec = GenomeSpec(topo)
    x = torch.as_tensor(np.asarray(x01, np.float32), device=mesh.device)
    init, round_fn = build_island_step(spec, cfg, mesh, quantize_inputs(x, topo.input_bits),
                                       labels, baseline_acc, axis_names)
    carry = init(seed, doping_seeds)
    for _ in range(cfg.rounds):
        carry = round_fn(*carry)
    pop, obj, viol = (t.cpu().numpy() for t in carry[:3])
    # global peel of the feasible rows, with GATrainer.front's fallback
    obj = obj.astype(np.float64)
    feas = viol <= 0
    if not feas.any():
        feas = np.ones_like(feas)
    return pareto_front(obj[feas], extras={"genomes": pop[feas]}), spec
