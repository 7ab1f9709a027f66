"""The GA engine: config, state and problem dataclasses, fitness and
objectives, init, and the NSGA-II generation step, PyTorch port of
``repro.core.engine`` for ``variation_mode="off"``.

State is a plain dataclass of tensors on one device; :func:`run_scanned`
is a Python loop over :func:`generation` (the reference's ``lax.scan``).
Every float32 hyperparameter (crossover and mutation rates, the accuracy
bound, the baseline, ``inv_n``) is a () float32 tensor, never a Python
float, so the objective chain rounds exactly as the reference's does.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import prng
from .area import population_area
from .dedup import EvalCache, cache_init, dedup_eval
from .genome import GeneTable, GenomeSpec, MLPTopology, random_population
from .mlp import population_correct_counts
from .pareto import pareto_front
from .quantize import quantize_inputs
from ..kernels.backend import BackendPolicy

NO_BUDGET = np.int32(2**31 - 1)

_LEGACY_BACKEND_FIELDS = (("fitness", "fitness_backend"),
                          ("variation", "variation_backend"),
                          ("generation", "generation_backend"),
                          ("ranking", "ranking_backend"))


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not in the PyTorch port yet "
                               f"(ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Every field of ``repro.core.engine.GAConfig``, so configs carry
    across; fields whose path is not ported raise ``NotImplementedError``."""

    pop_size: int = 256
    generations: int = 150
    crossover_rate: float = 0.7      # paper §V-A ("0.7")
    mutation_rate_gene: float = 0.02  # paper's "0.2" read per-chromosome
    doping_frac: float = 0.10        # paper §IV-A (~10 % nearly non-approximate)
    max_acc_loss: float = 0.10       # paper §IV-A (10 % feasibility bound)
    acc_only: bool = False           # Table III "GA" column: no area objective
    seed: int = 0
    log_every: int = 10
    # deprecated aliases of the BackendPolicy fields (see the reference)
    fitness_backend: str | None = None
    variation_backend: str | None = None
    generation_backend: str | None = None
    ranking_backend: str | None = None
    pop_tile: int = 64               # population tile of the "ref" fitness path
    sample_tile: int = 256           # sample tile of the "ref" fitness path
    dedup: bool | str = True         # True/"cache", "legacy" or False
    cache_slots: int = 4096          # EvalCache capacity (rounded to 2^k)
    cache_probes: int = 4            # open-addressing probe depth
    scan: bool = True                # record per-generation aux (unique_evals)
    batch_axis: str | None = None
    variation_mode: str = "off"
    n_device_samples: int = 8
    device_seed: int = 0
    variation_scale: float = 0.2
    generations_budget: int | None = None
    backends: BackendPolicy | None = None

    def __post_init__(self):
        pol = self.backends if self.backends is not None else BackendPolicy()
        legacy = {path: getattr(self, field)
                  for path, field in _LEGACY_BACKEND_FIELDS}
        given = {path: v for path, v in legacy.items()
                 if v is not None and v != getattr(pol, path)}
        if given:
            warnings.warn(
                "GAConfig(*_backend=...) is deprecated; pass "
                "GAConfig(backends=BackendPolicy(...)) instead",
                DeprecationWarning, stacklevel=3)
            pol = dataclasses.replace(pol, **given)
        object.__setattr__(self, "backends", pol)
        for path, field in _LEGACY_BACKEND_FIELDS:
            object.__setattr__(self, field, getattr(pol, path))
        if self.variation_mode not in ("off", "mean", "worst"):
            raise ValueError(
                f"unknown GAConfig.variation_mode {self.variation_mode!r}: "
                "expected 'off', 'mean' or 'worst'")
        if self.variation_mode != "off":
            raise _not_ported("device-variation fitness (variation_mode)", "A10")
        if self.generations_budget is not None:
            raise _not_ported("per-lane generation budgets", "A12")
        if self.batch_axis is not None:
            raise _not_ported("whole-run batching (batch_axis)", "A11")

    def with_backends(self, backends) -> "GAConfig":
        """Swap the whole :class:`BackendPolicy` (clears the mirrored
        legacy fields first, as the reference does)."""
        clear = {field: None for _, field in _LEGACY_BACKEND_FIELDS}
        return dataclasses.replace(self, backends=backends, **clear)


@dataclasses.dataclass
class GAState:
    pop: torch.Tensor        # (P, n_genes) int32
    obj: torch.Tensor        # (P, 2) float32 [error, area]
    viol: torch.Tensor       # (P,) float32
    rank: torch.Tensor       # (P,) int32
    crowd: torch.Tensor      # (P,) float32
    counts: torch.Tensor     # (P,) int32 correct counts (zeros, dedup off)
    key: torch.Tensor        # (2,) int64 uint32 key words
    gen: torch.Tensor        # () int32
    cache: EvalCache | None = None


def device_of(device) -> torch.device:
    """An entry point's device; a CUDA request without a card raises (the
    port never carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain PyTorch paths")
    return dev


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Problem:
    """One (dataset, topology, config) GA problem: data tensors on one
    device plus the swept hyperparameters as () float32 tensors (filled
    from ``cfg`` when not given)."""

    x_int: torch.Tensor          # (S, n_in) int32 quantized inputs
    labels: torch.Tensor         # (S,) int32; −1 marks padded samples
    baseline_acc: torch.Tensor   # () float32
    spec: GenomeSpec
    cfg: GAConfig
    crossover_rate: torch.Tensor = None
    mutation_rate_gene: torch.Tensor = None
    max_acc_loss: torch.Tensor = None
    genes: GeneTable = None
    out_mask: torch.Tensor = None
    inv_n: torch.Tensor = None
    n_valid_samples: torch.Tensor = None
    variation_scale: torch.Tensor = None
    generations_budget: torch.Tensor = None

    def __post_init__(self):
        dev = self.x_int.device
        padded = ((self.out_mask is not None and bool((self.out_mask == 0).any()))
                  or (self.n_valid_samples is not None
                      and int(self.n_valid_samples) != self.labels.shape[0]))
        if self.cfg.backends.fitness == "jnp" and padded:
            raise _not_ported("the 'jnp' fitness oracle on a padded problem",
                              "A11")
        if self.crossover_rate is None:
            self.crossover_rate = _f32(self.cfg.crossover_rate, dev)
        if self.mutation_rate_gene is None:
            self.mutation_rate_gene = _f32(self.cfg.mutation_rate_gene, dev)
        if self.max_acc_loss is None:
            self.max_acc_loss = _f32(self.cfg.max_acc_loss, dev)
        if self.genes is None:
            self.genes = self.spec.table(dev)
        if self.out_mask is None:
            self.out_mask = torch.ones(self.spec.topo.sizes[-1], dtype=torch.int32,
                                       device=dev)
        if self.inv_n is None:
            self.inv_n = _f32(1.0 / self.labels.shape[0], dev)
        if self.n_valid_samples is None:
            self.n_valid_samples = torch.tensor(self.labels.shape[0],
                                                dtype=torch.int32, device=dev)
        if self.variation_scale is None:
            self.variation_scale = _f32(self.cfg.variation_scale, dev)
        if self.generations_budget is None:
            self.generations_budget = torch.tensor(NO_BUDGET, dtype=torch.int32,
                                                   device=dev)

    @property
    def device(self) -> torch.device:
        return self.x_int.device

    def with_hypers(self, crossover_rate=None, mutation_rate_gene=None,
                    max_acc_loss=None, baseline_acc=None,
                    variation_scale=None) -> "Problem":
        """Replace the swept hyperparameters (None keeps the current value;
        a Python float becomes a () float32 tensor)."""
        kw = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
              for k, v in [("crossover_rate", crossover_rate),
                           ("mutation_rate_gene", mutation_rate_gene),
                           ("max_acc_loss", max_acc_loss),
                           ("baseline_acc", baseline_acc),
                           ("variation_scale", variation_scale)]
              if v is not None}
        return dataclasses.replace(self, **kw)

    def replace_cfg(self, **kw) -> "Problem":
        """New Problem with ``cfg`` fields replaced."""
        return dataclasses.replace(self, cfg=dataclasses.replace(self.cfg, **kw))

    @classmethod
    def from_data(cls, topo: MLPTopology, x01, labels,
                  cfg: GAConfig | None = None,
                  baseline_acc: float | None = None,
                  spec: GenomeSpec | None = None,
                  device="cuda") -> "Problem":
        """Build from float [0,1] features on ``device`` (chance-level
        baseline if None)."""
        dev = device_of(device)
        cfg = cfg if cfg is not None else GAConfig()
        spec = spec if spec is not None else GenomeSpec(topo)
        x = torch.as_tensor(np.asarray(x01, np.float32), device=dev)
        x_int = quantize_inputs(x, topo.input_bits)
        y = torch.as_tensor(np.asarray(labels), device=dev).to(torch.int32)
        return cls(x_int, y, _f32(1.0 if baseline_acc is None else baseline_acc, dev),
                   spec, cfg)


def dedup_mode(cfg: GAConfig) -> str:
    """Resolve ``cfg.dedup`` to "off" | "legacy" | "cache" (the "jnp"
    fitness oracle has no row skip, so dedup is off there)."""
    if cfg.dedup not in (True, False, "cache", "legacy"):
        raise ValueError(f"unknown GAConfig.dedup {cfg.dedup!r}: expected "
                         "True, False, 'cache' or 'legacy'")
    if not cfg.dedup or cfg.backends.fitness == "jnp":
        return "off"
    return "legacy" if cfg.dedup == "legacy" else "cache"


def use_dedup(cfg: GAConfig) -> bool:
    return dedup_mode(cfg) != "off"


# -- fitness ----------------------------------------------------------------

def population_counts(problem: Problem, pop, n_valid=None):
    """(N, G) → (N,) int32 correct counts via the fitness dispatcher; rows
    at or past ``n_valid`` are not evaluated (callers overwrite them)."""
    from ..kernels.pop_mlp import population_correct  # lazy: kernels import core

    cfg = problem.cfg
    return population_correct(
        pop, problem.x_int, problem.labels, spec=problem.spec,
        backend=cfg.backends.fitness, pop_tile=cfg.pop_tile,
        sample_tile=cfg.sample_tile, n_valid_rows=n_valid,
        n_valid_samples=problem.n_valid_samples, out_mask=problem.out_mask)


def counts_accuracy(problem: Problem, counts):
    """int32 correct counts → accuracy ``counts * inv_n``, returned as the
    EXACT product in float64 (a count below 2**24 times the float32
    ``inv_n`` fits in 48 bits), unrounded.

    The reference computes this product in float32 under jit, where XLA
    contracts it with the subtraction that consumes it (``1 - acc``,
    ``baseline - acc``) into one fused multiply-add: a single rounding of
    the exact value. :func:`objectives` reproduces that by subtracting in
    float64 (exact: the operands span fewer than 53 bits) and rounding
    once."""
    return counts.to(torch.float64) * problem.inv_n.to(torch.float64)


def objectives(problem: Problem, pop, acc):
    """(pop, accuracy) → ((N, 2) float32 [error, area], (N,) violation).

    ``acc`` is the exact float64 product of :func:`counts_accuracy` or a
    float32 accuracy; ``1 - acc`` and ``baseline - acc`` are exact in
    float64, so one rounding to float32 gives the fused result for the
    former and the plain float32 difference for the latter."""
    acc = acc.to(torch.float64)
    err = (1.0 - acc).to(torch.float32)
    if problem.cfg.acc_only:
        area = torch.zeros_like(err)
    else:
        area = population_area(problem.spec, pop).to(torch.float32)
    obj = torch.stack([err, area], dim=-1)
    gap = (problem.baseline_acc.to(torch.float64) - acc).to(torch.float32)
    viol = torch.clamp_min(gap - problem.max_acc_loss, 0.0)
    return obj, viol


def fitness(problem: Problem, pop):
    """(N, G) → ((N, 2) objectives, (N,) violation) — non-dedup path."""
    if problem.cfg.backends.fitness == "jnp":
        # the oracle's mean is the count times float32 1/S, which XLA fuses
        # into the objective subtractions like the count path's product
        acc = counts_accuracy(problem, population_correct_counts(
            problem.spec, pop, problem.x_int, problem.labels))
    else:
        acc = counts_accuracy(problem, population_counts(problem, pop))
    return objectives(problem, pop, acc)


# -- init -------------------------------------------------------------------

def _doping_array(doping_seeds, device):
    if doping_seeds is None:
        return None
    if isinstance(doping_seeds, torch.Tensor):
        return doping_seeds.to(device=device, dtype=torch.int32)
    if not isinstance(doping_seeds, np.ndarray):
        doping_seeds = np.stack([np.asarray(s) for s in doping_seeds])
    return torch.as_tensor(np.asarray(doping_seeds, np.int32), device=device)


def initial_population(problem: Problem, key, doping_seeds=None,
                       pop_size: int | None = None):
    """Random population doped with ~doping_frac nearly non-approximate
    chromosomes (paper §IV-A)."""
    cfg = problem.cfg
    P = cfg.pop_size if pop_size is None else pop_size
    pop = random_population(key, problem.genes, P)
    dope = _doping_array(doping_seeds, problem.device)
    if dope is not None:
        n_dope = max(1, int(cfg.doping_frac * P))
        reps = torch.as_tensor(np.resize(np.arange(dope.shape[0]), n_dope),
                               device=problem.device)
        pop[:n_dope] = dope[reps]
    return pop


def initial_counts(problem: Problem, pop, cache: EvalCache | None = None):
    """Integer correct counts (+ rows evaluated) of an initial population;
    with a ``cache`` its unique rows are inserted (stamp 0) and
    ``(counts, n_eval, cache)`` is returned."""
    eval_fn = lambda rows, n: population_counts(problem, rows, n)
    if cache is not None:
        counts, n_eval, _, cache = dedup_eval(
            eval_fn, pop, gene_mask=problem.genes.valid, cache=cache, gen=0,
            ids=problem.genes.ids)
        return counts, n_eval, cache
    if use_dedup(problem.cfg):
        return dedup_eval(eval_fn, pop, gene_mask=problem.genes.valid,
                          ids=problem.genes.ids)
    return (population_counts(problem, pop),
            torch.tensor(pop.shape[0], dtype=torch.int32, device=pop.device))


def init_state(problem: Problem, key, doping_seeds=None,
               pop_size: int | None = None):
    """Root PRNG key → (GAState, n_evaluated_rows)."""
    from ..kernels.pop_ranking import population_ranking  # lazy: kernels import core

    cfg = problem.cfg
    key, k_pop = prng.split(key)
    pop = initial_population(problem, k_pop, doping_seeds, pop_size)
    cache = None
    dev = problem.device
    if cfg.backends.fitness == "jnp":
        counts = torch.zeros(pop.shape[0], dtype=torch.int32, device=dev)
        n_eval = torch.tensor(pop.shape[0], dtype=torch.int32, device=dev)
        obj, viol = fitness(problem, pop)
    else:
        if dedup_mode(cfg) == "cache":
            cache = cache_init(cfg.cache_slots, problem.genes.low.shape[0],
                               cfg.cache_probes, device=dev)
            counts, n_eval, cache = initial_counts(problem, pop, cache)
        else:
            counts, n_eval = initial_counts(problem, pop)
        obj, viol = objectives(problem, pop, counts_accuracy(problem, counts))
    rank, crowd = population_ranking(obj, viol, backend=cfg.backends.ranking)
    return GAState(pop, obj, viol, rank, crowd, counts, key,
                   torch.zeros((), dtype=torch.int32, device=dev), cache), n_eval


# -- the generation step ----------------------------------------------------

def generation(problem: Problem, state: GAState):
    """One (μ+λ) NSGA-II generation → (state, aux) with aux = (best_err,
    best_area, n_evaluated_rows, n_cache_hits), all () device tensors;
    the ``pop_generation`` dispatcher picks the backend."""
    from ..kernels.pop_generation import population_generation
    return population_generation(problem, state)


def run_scanned(problem: Problem, state: GAState, generations: int):
    """All ``generations`` in a Python loop → (final state, aux) with each
    aux entry stacked to shape (generations,). Nothing is read back to the
    host inside the loop."""
    auxes = []
    for _ in range(generations):
        state, aux = generation(problem, state)
        auxes.append(aux)
    if not auxes:
        return state, tuple(torch.empty(0, device=problem.device) for _ in range(4))
    return state, tuple(torch.stack(col) for col in zip(*auxes))


# -- host-side output -------------------------------------------------------

def front_of(state: GAState):
    """Feasible estimated Pareto front (paper Fig. 2 output)."""
    obj = state.obj.cpu().numpy()
    pops = state.pop.cpu().numpy()
    feas = state.viol.cpu().numpy() <= 0
    if not feas.any():
        feas = np.ones_like(feas)
    return pareto_front(obj[feas], extras={"genomes": pops[feas]})
