"""The GA engine: config, state and problem dataclasses, fitness and
objectives, init, and the NSGA-II generation step, PyTorch port of
``repro.core.engine``, device-variation Monte-Carlo fitness
(``variation_mode="mean"``/``"worst"``) included.

State is a plain dataclass of tensors on one device; :func:`run_scanned`
is a Python loop over :func:`generation` (the reference's ``lax.scan``).
Every float32 hyperparameter (crossover and mutation rates, the accuracy
bound, the baseline, ``inv_n``) is a () float32 tensor, never a Python
float, so the objective chain rounds exactly as the reference's does.

Batching (the reference's ``vmap`` over whole runs) is an explicit leading
lane axis: a batched :class:`Problem` (:func:`stack_problems`, its config
tagged with :data:`BATCH_AXIS`) and its :class:`GAState` carry an (L, ...)
axis on every tensor leaf. Each generation launches every CUDA kernel of
its path once for all lanes (under the budget gate, for the lanes with
budget left: :func:`run_scanned`); the glue around them (tournament, dedup
packing, objectives, ranking) runs lane by lane. :func:`run_batch` batches
seeds, ``sweep.run_grid``/``sweep.run_suite`` hyperparameters and
datasets; ``repro_torch.serve`` admits and retires lanes between
segments. :func:`validate_state` checks a lane's invariants.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import prng
from .area import population_area
from .dedup import EvalCache, cache_init, dedup_eval_lanes
from .genome import (SLOT_DEVICE, GeneTable, GenomeSpec, MLPTopology,
                     gene_uniform, pad_positions, padded_table, random_population)
from .mlp import population_correct_counts
from .pareto import pareto_front
from .quantize import quantize_inputs
from ..device import device_of
from ..kernels.backend import BackendPolicy

NO_BUDGET = np.int32(2**31 - 1)
BATCH_AXIS = "ga_runs"   # the tag of a lane-stacked problem (the reference's vmap axis)

_LEGACY_BACKEND_FIELDS = (("fitness", "fitness_backend"),
                          ("variation", "variation_backend"),
                          ("generation", "generation_backend"),
                          ("ranking", "ranking_backend"))


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """Every field of ``repro.core.engine.GAConfig``, so configs carry
    across; values the reference refuses raise ``ValueError`` here too."""

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
    # None: no budget gate. An int turns the gate on: the
    # ``Problem.generations_budget`` leaf (defaulted from it, set per lane)
    # bounds the generations ``run_scanned`` runs on each lane
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
        if int(self.n_device_samples) < 1:
            raise ValueError("GAConfig.n_device_samples must be >= 1, got "
                             f"{self.n_device_samples}")
        if not 0.0 <= float(self.variation_scale) <= 1.0:
            raise ValueError("GAConfig.variation_scale must lie in [0, 1], "
                             f"got {self.variation_scale}")
        if self.variation_mode != "off" and pol.fitness == "jnp":
            raise ValueError(
                "variation_mode != 'off' needs a count-based fitness "
                "backend (auto/kernel/ref): the 'jnp' oracle has no "
                "device-instance axis")
        if self.batch_axis not in (None, BATCH_AXIS):
            raise ValueError(f"GAConfig.batch_axis must be None or {BATCH_AXIS!r}, "
                             f"the port's one lane axis; got {self.batch_axis!r}")

    def with_backends(self, backends) -> "GAConfig":
        """Swap the whole :class:`BackendPolicy` (clears the mirrored
        legacy fields first, as the reference does)."""
        clear = {field: None for _, field in _LEGACY_BACKEND_FIELDS}
        return dataclasses.replace(self, backends=backends, **clear)


_STATE_TENSORS = ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen")


@dataclasses.dataclass
class GAState:
    pop: torch.Tensor        # (P, n_genes) int32
    obj: torch.Tensor        # (P, 2) float32 [error, area]; (P, 3) with the
    #                          robust error under device variation
    viol: torch.Tensor       # (P,) float32
    rank: torch.Tensor       # (P,) int32
    crowd: torch.Tensor      # (P,) float32
    counts: torch.Tensor     # (P,) int32 correct counts, (P, K) per device
    #                          instance under device variation (zeros, dedup off)
    key: torch.Tensor        # (2,) int64 uint32 key words
    gen: torch.Tensor        # () int32
    cache: EvalCache | None = None


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Problem:
    """One (dataset, topology, config) GA problem: data tensors on one
    device plus the swept hyperparameters as () float32 tensors (filled
    from ``cfg`` when not given).

    A batched problem (:func:`stack_problems`) carries a leading lane axis
    (L) on every tensor leaf and shares ``spec`` and ``cfg``;
    :meth:`lane` peels one lane off as a single problem."""

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
        if self.cfg.backends.fitness == "jnp" and (
                (self.out_mask is not None and bool((self.out_mask == 0).any()))
                or (self.n_valid_samples is not None
                    and bool((self.n_valid_samples != self.labels.shape[-1]).any()))):
            raise ValueError(_JNP_PADDED)
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
            budget = (NO_BUDGET if self.cfg.generations_budget is None
                      else self.cfg.generations_budget)
            self.generations_budget = torch.tensor(budget, dtype=torch.int32, device=dev)

    @property
    def device(self) -> torch.device:
        return self.x_int.device

    @property
    def n_lanes(self) -> int | None:
        """The lane count of a batched problem, None for a single one."""
        return self.x_int.shape[0] if self.x_int.dim() == 3 else None

    def lane(self, i: int) -> "Problem":
        """Lane ``i`` of a batched problem as a single problem (views of
        the leaves; memoized)."""
        memo = self.__dict__.setdefault("_lanes", {})
        if i not in memo:
            cfg = dataclasses.replace(self.cfg, batch_axis=None)
            memo[i] = Problem(
                self.x_int[i], self.labels[i], self.baseline_acc[i], self.spec, cfg,
                self.crossover_rate[i], self.mutation_rate_gene[i], self.max_acc_loss[i],
                self.genes.lane(i), self.out_mask[i], self.inv_n[i],
                self.n_valid_samples[i], self.variation_scale[i],
                self.generations_budget[i])
        return memo[i]

    def lanes(self) -> list:
        """Every lane as a single problem: ``[self]`` for a single problem.
        A problem tagged with :data:`BATCH_AXIS` must be stacked."""
        if self.n_lanes is None:
            if self.cfg.batch_axis is not None:
                raise ValueError("a problem tagged with the batch axis runs only "
                                 "stacked (stack_problems)")
            return [self]
        return [self.lane(i) for i in range(self.n_lanes)]

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


_JNP_PADDED = ("padded problems need a count-based fitness backend "
               "(ref/kernel/auto), not 'jnp'")


def pad_problem(problem: Problem, spec_pad: GenomeSpec,
                n_samples: int | None = None) -> Problem:
    """Embed ``problem`` into the padded layout of ``spec_pad``; the result
    runs bit-identically to the original.

    Genes keep their draw ids and bounds at the embedded positions
    (padding is canonical zero: ``genome.padded_table``), extra input
    columns are zero, ``out_mask`` pins padded output columns below any
    real logit, and ``inv_n``/``n_valid_samples`` keep the original sample
    count. ``n_samples`` pads the sample axis too (features 0, label −1,
    never matched), so datasets of several sizes stack on one lane axis.
    The "jnp" oracle averages over the padded axis, so it is refused."""
    if problem.cfg.backends.fitness == "jnp":
        raise ValueError(_JNP_PADDED)
    inner = problem.spec
    pos = pad_positions(inner, spec_pad)
    genes = padded_table(inner, spec_pad, pos, device=problem.device)
    x, labels = problem.x_int, problem.labels
    S = x.shape[0]
    pad_cols = spec_pad.topo.sizes[0] - x.shape[1]
    pad_rows = 0 if n_samples is None else n_samples - S
    if pad_rows < 0:
        raise ValueError(f"n_samples={n_samples} < dataset size {S}")
    if pad_cols or pad_rows:
        x = torch.nn.functional.pad(x, (0, pad_cols, 0, pad_rows))
        labels = torch.nn.functional.pad(labels, (0, pad_rows), value=-1)
    out_mask = torch.zeros(spec_pad.topo.sizes[-1], dtype=torch.int32,
                           device=problem.device)
    out_mask[: inner.topo.sizes[-1]] = 1
    return Problem(x, labels, problem.baseline_acc, spec_pad, problem.cfg,
                   problem.crossover_rate, problem.mutation_rate_gene,
                   problem.max_acc_loss, genes, out_mask, problem.inv_n,
                   problem.n_valid_samples, problem.variation_scale,
                   problem.generations_budget)


# -- fitness ----------------------------------------------------------------

def variation_on(cfg: GAConfig) -> bool:
    """Whether device-variation Monte-Carlo fitness is active."""
    return cfg.variation_mode != "off"


def device_deltas(problem: Problem):
    """(K, G) int32 exponent perturbations of the K sampled device
    instances (K = ``cfg.n_device_samples``); row 0 is the nominal device
    (all zero).

    Gene-addressed draws under ``SLOT_DEVICE`` keyed by the static
    ``cfg.device_seed`` (not the run key), so every run path and seed sees
    the same K devices. A uniform u maps to −1 when u < scale/2 and +1
    when u ≥ 1 − scale/2, in float32 against the () float32
    ``variation_scale``. Only valid exponent genes perturb."""
    cfg = problem.cfg
    t = problem.genes
    key = prng.PRNGKey(cfg.device_seed, problem.device)
    u = gene_uniform(key, t.ids, cfg.n_device_samples, slot=SLOT_DEVICE)
    half = 0.5 * problem.variation_scale                  # exact in float32
    delta = (u >= 1.0 - half).to(torch.int32) - (u < half).to(torch.int32)
    live = torch.as_tensor(problem.spec.is_exp, device=problem.device) & t.valid
    delta = torch.where(live[None, :], delta, 0)
    delta[0] = 0
    return delta


@dataclasses.dataclass
class LaneData:
    """A problem's kernel operands with a leading lane axis (L = 1 for a
    single problem): what one launch for all lanes reads."""

    x: torch.Tensor                   # (L, S, n_in) int32
    labels: torch.Tensor              # (L, S) int32
    out_mask: torch.Tensor            # (L, n_out) int32
    n_valid_samples: torch.Tensor     # (L,) int32
    genes: GeneTable                  # (L, G) leaves
    crossover_rate: torch.Tensor      # (L,) float32
    mutation_rate_gene: torch.Tensor  # (L,) float32
    deltas: torch.Tensor | None       # (L, K, G) int32 under device variation


def lane_data(problem: Problem) -> LaneData:
    """The lane-axis operands of ``problem`` (memoized; views of a single
    problem's leaves)."""
    memo = problem.__dict__
    if "_lane_data" not in memo:
        lanes = problem.lanes()
        if problem.n_lanes is None:
            one = lambda t: t[None]
            genes = GeneTable(*map(one, problem.genes.leaves()))
        else:
            one = lambda t: t
            genes = problem.genes
        deltas = (torch.stack([device_deltas(p) for p in lanes])
                  if variation_on(problem.cfg) else None)
        memo["_lane_data"] = LaneData(
            one(problem.x_int), one(problem.labels), one(problem.out_mask),
            one(problem.n_valid_samples), genes, one(problem.crossover_rate),
            one(problem.mutation_rate_gene), deltas)
    return memo["_lane_data"]


def population_counts(problem: Problem, pop, n_valid=None):
    """(N, G) → (N,) int32 correct counts via the fitness dispatcher, or
    (N, K) per device instance under device-variation fitness; rows at or
    past ``n_valid`` are not evaluated (callers overwrite them).

    With (L, N, G) rows (one lane of rows per lane of ``problem``; L = 1
    for a single problem) every lane is scored in one evaluation → (L, N)
    or (L, N, K); ``n_valid`` then bounds every lane."""
    from ..kernels.pop_mlp import population_correct  # lazy: kernels import core

    cfg = problem.cfg
    d = lane_data(problem)
    rows = pop if pop.dim() == 3 else pop[None]
    counts = population_correct(
        rows, d.x, d.labels, spec=problem.spec, backend=cfg.backends.fitness,
        pop_tile=cfg.pop_tile, sample_tile=cfg.sample_tile, n_valid_rows=n_valid,
        n_valid_samples=d.n_valid_samples, out_mask=d.out_mask, dev=d.deltas,
        gene_high=d.genes.high)
    return counts if pop.dim() == 3 else counts[0]


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
    former and the plain float32 difference for the latter.

    Under device-variation fitness ``acc`` is (N, K) (column 0 nominal)
    and the objectives are (N, 3) [nominal error, area, robust error]; the
    robust accuracy (:func:`robust_accuracy`) bounds the violation."""
    acc = acc.to(torch.float64)
    if problem.cfg.acc_only:
        area = torch.zeros(acc.shape[0], dtype=torch.float32, device=acc.device)
    else:
        area = population_area(problem.spec, pop).to(torch.float32)
    base = problem.baseline_acc.to(torch.float64)
    if acc.dim() == 2:
        rob = robust_accuracy(acc, problem.cfg.variation_mode)
        obj = torch.stack([(1.0 - acc[:, 0]).to(torch.float32), area,
                           fused_f32(1.0, -rob)], dim=-1)
        gap = fused_f32(base, -rob)
    else:
        obj = torch.stack([(1.0 - acc).to(torch.float32), area], dim=-1)
        gap = (base - acc).to(torch.float32)
    viol = torch.clamp_min(gap - problem.max_acc_loss, 0.0)
    return obj, viol


def fused_f32(a, b) -> torch.Tensor:
    """float32 rounding of the exact sum ``a + b`` of two float64 values,
    rounded once, as a float32 fused multiply-add rounds (``b`` the exact
    product). The float64 sum is made round-to-odd (Knuth's two-sum gives
    its exact error; an inexact even result steps one ulp towards the
    exact value), and a round-to-odd value 29 bits wider than float32
    rounds to float32 as the exact sum does."""
    a = torch.as_tensor(a, dtype=torch.float64, device=b.device)
    d = a + b
    bb = d - a
    err = (a - (d - bb)) + (b - bb)
    bits = d.view(torch.int64)
    step = torch.where((err > 0) == (d > 0), 1, -1)
    odd = torch.where((err != 0) & (bits % 2 == 0), bits + step, bits)
    return odd.view(torch.float64).to(torch.float32)


def robust_accuracy(acc, mode: str) -> torch.Tensor:
    """(N, K) exact float64 accuracies ``c_k * inv_n`` → (N,) robust
    accuracy as float64 holding the value the reference's float32 chain
    feeds, unrounded, into ``1 - rob`` and ``baseline - rob``.

    XLA:CPU computes the reference's ``jnp.mean`` (K >= 2) as a chain of
    float32 fused multiply-adds ``s = fma(c_k, inv_n, s)`` over k = 0..K-1,
    then multiplies by the float32 reciprocal ``fl(1/K)`` and fuses that
    product into both subtractions; with K = 1 the reduction vanishes and
    the product ``c_0 * inv_n`` itself is fused. ``"worst"`` is the
    minimum of the float32-rounded products (rounding is monotone, so the
    order does not matter), unrounded again at K = 1.
    tests/test_torch_device_variation.py holds every form against the
    reference's jitted objectives at K = 1, 2, 4, 6, 8 and 12."""
    K = acc.shape[1]
    if K == 1:
        return acc[:, 0]
    if mode == "worst":
        return acc.to(torch.float32).amin(dim=-1).to(torch.float64)
    s = torch.zeros(acc.shape[0], dtype=torch.float64, device=acc.device)
    for k in range(K):
        s = fused_f32(acc[:, k], s).to(torch.float64)
    recip = torch.tensor(1.0 / K, dtype=torch.float32).item()   # fl(1/K)
    return s * recip                  # exact: two float32 significands


def fitness_lanes(problem: Problem, lanes: list, pops: list) -> list:
    """:func:`fitness` of each lane's rows, scored in one evaluation."""
    if problem.cfg.backends.fitness == "jnp":
        return [fitness(p, pop) for p, pop in zip(lanes, pops)]
    counts = population_counts(problem, torch.stack(pops))
    return [objectives(p, pop, counts_accuracy(p, c))
            for p, pop, c in zip(lanes, pops, counts)]


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


def dedup_lanes(problem: Problem, lanes: list, pops: list, **kw) -> list:
    """``dedup.dedup_eval`` of each lane's rows with ONE fitness evaluation
    bounded by the widest lane's count; ``kw`` holds per-lane lists
    (``known``, ``cache``, ``gen``)."""
    return dedup_eval_lanes(lambda rows, n: population_counts(problem, rows, n), pops,
                            gene_mask=[p.genes.valid for p in lanes],
                            ids=[p.genes.ids for p in lanes], **kw)


def initial_counts(problem: Problem, lanes: list, pops: list, caches=None) -> list:
    """Integer correct counts (+ rows evaluated) of each lane's initial
    population, scored in one evaluation; with ``caches`` each lane's
    unique rows are inserted (stamp 0) and ``(counts, n_eval, cache)`` is
    returned per lane."""
    if caches is not None:
        res = dedup_lanes(problem, lanes, pops, cache=caches, gen=[0] * len(pops))
        return [(c, n, cache) for c, n, _, cache in res]
    if use_dedup(problem.cfg):
        return dedup_lanes(problem, lanes, pops)
    counts = population_counts(problem, torch.stack(pops))
    return [(c, torch.tensor(pop.shape[0], dtype=torch.int32, device=pop.device))
            for c, pop in zip(counts, pops)]


def init_state(problem: Problem, key, doping_seeds=None,
               pop_size: int | None = None):
    """Root PRNG key → (GAState, n_evaluated_rows).

    On a batched problem ``key`` is (L, 2), one key per lane, and the
    state and the count carry the lane axis; (n, G) ``doping_seeds`` dope
    every lane alike, (L, n, G) give each lane its own rows."""
    lanes = problem.lanes()
    dope = _doping_array(doping_seeds, problem.device)
    if problem.n_lanes is None:
        keys, dopes = [key], [dope]
    else:
        keys = list(key)
        dopes = list(dope) if dope is not None and dope.dim() == 3 else [dope] * len(lanes)
    states, n0 = _init_lanes(problem, lanes, keys, dopes, pop_size)
    if problem.n_lanes is None:
        return states[0], n0[0]
    return stack_states(states), torch.stack(n0)


def _init_lanes(problem: Problem, lanes: list, keys: list, dopes: list,
                pop_size: int | None):
    from ..kernels.pop_ranking import population_ranking  # lazy: kernels import core

    cfg = problem.cfg
    dev = problem.device
    split = [prng.split(key) for key in keys]
    pops = [initial_population(p, k_pop, dope, pop_size)
            for p, (_, k_pop), dope in zip(lanes, split, dopes)]
    caches = [None] * len(lanes)
    if cfg.backends.fitness == "jnp":
        counts = [torch.zeros(pop.shape[0], dtype=torch.int32, device=dev) for pop in pops]
        n0 = [torch.tensor(pop.shape[0], dtype=torch.int32, device=dev) for pop in pops]
        scored = [fitness(p, pop) for p, pop in zip(lanes, pops)]
    else:
        if dedup_mode(cfg) == "cache":
            val_shape = (cfg.n_device_samples,) if variation_on(cfg) else ()
            caches = [cache_init(cfg.cache_slots, p.genes.low.shape[0], cfg.cache_probes,
                                 val_shape=val_shape, device=dev) for p in lanes]
            res = initial_counts(problem, lanes, pops, caches)
            caches = [r[2] for r in res]
        else:
            res = initial_counts(problem, lanes, pops)
        counts, n0 = [r[0] for r in res], [r[1] for r in res]
        scored = [objectives(p, pop, counts_accuracy(p, c))
                  for p, pop, c in zip(lanes, pops, counts)]
    states = []
    for pop, (obj, viol), c, (key, _), cache in zip(pops, scored, counts, split, caches):
        rank, crowd = population_ranking(obj, viol, backend=cfg.backends.ranking)
        states.append(GAState(pop, obj, viol, rank, crowd, c, key,
                              torch.zeros((), dtype=torch.int32, device=dev), cache))
    return states, n0


# -- the generation step ----------------------------------------------------

def generation(problem: Problem, state: GAState):
    """One (μ+λ) NSGA-II generation → (state, aux) with aux = (best_err,
    best_area, n_evaluated_rows, n_cache_hits), all () device tensors;
    the ``pop_generation`` dispatcher picks the backend."""
    from ..kernels.pop_generation import population_generation
    return population_generation(problem, state)


def lane_active(problem: Problem, state: GAState) -> torch.Tensor:
    """() bool (or (L,) on a batched problem): whether a lane still has
    generation budget left."""
    return state.gen < problem.generations_budget


def lane_subset(problem: Problem, idx: tuple) -> Problem:
    """Lanes ``idx`` of a batched problem as a batched problem of their own
    (``problem`` itself when ``idx`` is every lane, or ``problem`` is a
    single one); memoized per subset, so each subset's :func:`lane_data` is
    built once."""
    if problem.n_lanes is None or idx == tuple(range(problem.n_lanes)):
        return problem
    memo = problem.__dict__.setdefault("_subsets", {})
    if idx not in memo:
        memo[idx] = stack_problems([problem.lane(i) for i in idx])
    return memo[idx]


def _passthrough_aux(state: GAState) -> tuple:
    """The aux entry of a lane that did not run: its best objectives, no
    rows evaluated, no cache hits (device tensors)."""
    zero = torch.zeros((), dtype=torch.int32, device=state.obj.device)
    return state.obj[:, 0].min(), state.obj[:, 1].min(), zero, zero


def run_scanned(problem: Problem, state: GAState, generations: int):
    """All ``generations`` in a Python loop → (final state, aux) with each
    aux entry stacked to shape (generations,), or (L, generations) on a
    batched problem.

    With ``cfg.generations_budget`` None every lane runs every generation
    and nothing is read back to the host. With the budget gate on (an int),
    lane i is active while ``gen < generations_budget``: each lane's ``gen``
    and budget are read to the host ONCE, at the start of the call (the
    call's only host read), and lane i then runs the first
    ``max(0, budget_i - gen_i)`` generations of the call, since its ``gen``
    advances only while it runs. Each generation hands only the active
    lanes to ``generation_lanes`` (:func:`lane_subset`), so every kernel
    launch and the shared dedup bound cover exactly those lanes, and a
    generation with no active lane runs nothing. An inactive lane passes
    through bitwise (every leaf, its EvalCache included) with aux
    ``(min error, min area, 0, 0)``; an active lane runs the plain
    generation. So calling again on the returned state resumes where each
    lane's budget says, which is what ``repro_torch.serve`` segments on."""
    from ..kernels.pop_generation import generation_lanes

    lanes = problem.lanes()
    states = split_state(problem, state)
    L = len(lanes)
    if problem.cfg.generations_budget is None:
        runs = [generations] * L
    else:
        left = (problem.generations_budget - state.gen).reshape(-1).tolist()
        runs = [min(generations, max(0, n)) for n in left]
    auxes = [[] for _ in range(L)]
    for t in range(generations):
        idx = tuple(i for i in range(L) if runs[i] > t)
        if idx:
            new, aux = generation_lanes(lane_subset(problem, idx), [lanes[i] for i in idx],
                                        [states[i] for i in idx])
            for i, s, a in zip(idx, new, aux):
                states[i] = s
                auxes[i].append(a)
        for i in range(L):
            if runs[i] <= t:
                auxes[i].append(_passthrough_aux(states[i]))
    if generations:
        per_lane = [tuple(torch.stack([a[k] for a in lane_aux]) for k in range(4))
                    for lane_aux in auxes]
    else:
        per_lane = [tuple(torch.empty(0, device=problem.device) for _ in range(4))
                    for _ in lanes]
    return join_lanes(problem, states, per_lane)


# -- whole-run batching over lanes -------------------------------------------

def batch_problem(problem: Problem) -> Problem:
    """``problem`` tagged with :data:`BATCH_AXIS`, as a lane of
    :func:`stack_problems` (a tagged problem runs only stacked)."""
    if problem.cfg.batch_axis == BATCH_AXIS:
        return problem
    return problem.replace_cfg(batch_axis=BATCH_AXIS)


def stack_problems(problems) -> Problem:
    """Stack single problems of one layout leaf-wise: every tensor leaf
    gains a leading (L,) lane axis. Their topologies and configs must
    agree; the result is tagged with :data:`BATCH_AXIS`."""
    problems = list(problems)
    p0 = problems[0]
    cfg = dataclasses.replace(p0.cfg, batch_axis=BATCH_AXIS)
    for p in problems:
        if p.n_lanes is not None:
            raise ValueError("stack_problems stacks single problems")
        if p.spec.topo != p0.spec.topo:
            raise ValueError(f"lanes must share one layout: {p.spec.topo.sizes} vs "
                             f"{p0.spec.topo.sizes}")
        if dataclasses.replace(p.cfg, batch_axis=BATCH_AXIS) != cfg:
            raise ValueError(f"lanes must share one GAConfig (got {p.cfg} vs {p0.cfg})")
    st = lambda name: torch.stack([getattr(p, name) for p in problems])
    return Problem(st("x_int"), st("labels"), st("baseline_acc"), p0.spec, cfg,
                   st("crossover_rate"), st("mutation_rate_gene"), st("max_acc_loss"),
                   GeneTable.stack([p.genes for p in problems]), st("out_mask"),
                   st("inv_n"), st("n_valid_samples"), st("variation_scale"),
                   st("generations_budget"))


def _cache_leaves(cache: EvalCache) -> tuple:
    return cache.rows, cache.vals, cache.stamp


def state_at(states: GAState, i: int) -> GAState:
    """Peel lane ``i`` off a batched GAState (views)."""
    cache = None
    if states.cache is not None:
        cache = EvalCache(*(a[i] for a in _cache_leaves(states.cache)), states.cache.probes)
    return GAState(*(getattr(states, f)[i] for f in _STATE_TENSORS), cache)


def stack_states(states: list) -> GAState:
    """Per-lane GAStates → one batched GAState."""
    st = lambda f: torch.stack([getattr(s, f) for s in states])
    cache = None
    if states[0].cache is not None:
        cache = EvalCache(*(torch.stack(a) for a in zip(*(_cache_leaves(s.cache)
                                                           for s in states))),
                          states[0].cache.probes)
    return GAState(*(st(f) for f in _STATE_TENSORS), cache)


def join_lanes(problem: Problem, states: list, auxes: list):
    """Per-lane generation results → (state, aux) in the problem's form:
    the lane's own for a single problem, stacked on the lane axis else."""
    if problem.n_lanes is None:
        return states[0], auxes[0]
    return stack_states(states), tuple(torch.stack(c) for c in zip(*auxes))


def split_state(problem: Problem, state: GAState) -> list:
    """The state of each lane of ``problem``: ``[state]`` for a single one."""
    if problem.n_lanes is None:
        return [state]
    return [state_at(state, i) for i in range(problem.n_lanes)]


def run_batch(problem: Problem, seeds, generations: int | None = None,
              doping_seeds=None):
    """Whole runs of one problem over a seed axis, as L lanes of one
    batched run: every generation launches each kernel of its path once
    for all seeds.

    Returns (states, aux, init_evals): every GAState leaf and aux entry
    gains a leading (N,) axis (:func:`state_at` peels a run). Each run is
    bit-identical to its own ``init_state`` + ``run_scanned`` and to
    ``GATrainer.run`` with that seed, dedup on or off: the lanes share one
    dedup evaluation bound per generation and gather only their own rows.
    The reference's ``jit`` argument steers XLA only and is not taken."""
    if problem.n_lanes is not None:
        raise ValueError("run_batch takes a single (unstacked) problem")
    gens = problem.cfg.generations if generations is None else generations
    seeds = [int(s) for s in seeds]
    batched = stack_problems([batch_problem(problem)] * len(seeds))
    keys = torch.stack([prng.PRNGKey(s, problem.device) for s in seeds])
    states, n0 = init_state(batched, keys, doping_seeds)
    states, aux = run_scanned(batched, states, gens)
    return states, aux, n0


# -- lane health validation (the serve supervisor's boundary check) ---------

# check names, index-aligned with the validate_state result vector
VALIDATION_CHECKS = ("finite_objectives", "genome_in_bounds",
                     "counts_in_range", "cache_accounting")


def validate_state(problem: Problem, state: GAState) -> torch.Tensor:
    """Engine-invariant checks of one lane → (len(VALIDATION_CHECKS),) bool,
    index-aligned with the names; on a batched problem and state, every
    lane in one pass → (L, len(VALIDATION_CHECKS)) bool. Nothing is read
    back to the host.

    A healthy state never trips them (every generation keeps them), while
    a poisoned lane fails:

      * ``finite_objectives`` — every objective is finite and every
        violation finite and non-negative (crowding is not checked: its
        boundary rows are +inf by design);
      * ``genome_in_bounds`` — every gene lies in its table's
        ``[low, high)`` (padding genes' ``[0, 1)`` pins them to zero);
      * ``counts_in_range`` — the correct counts lie in
        ``[0, n_valid_samples]`` ((P,) or (P, K));
      * ``cache_accounting`` — live EvalCache entries (stamp >= 0) hold
        counts in that range and no stamp exceeds the lane's ``gen``
        (``vals`` (C,) or (C, K)); True when there is no cache.
    """
    single = problem.n_lanes is None
    one = (lambda t: t[None]) if single else (lambda t: t)
    L = 1 if single else problem.n_lanes
    flat = lambda t: one(t).reshape(L, -1)      # noqa: E731
    t = problem.genes
    finite = (torch.isfinite(flat(state.obj)).all(1) & torch.isfinite(flat(state.viol)).all(1)
              & (flat(state.viol) >= 0.0).all(1))
    pop = one(state.pop)
    in_bounds = ((pop >= one(t.low)[:, None]) & (pop < one(t.high)[:, None])).reshape(
        L, -1).all(1)
    n = one(problem.n_valid_samples).reshape(L, 1)
    counts = flat(state.counts)
    counts_ok = ((counts >= 0) & (counts <= n)).all(1)
    if state.cache is None:
        cache_ok = torch.ones(L, dtype=torch.bool, device=pop.device)
    else:
        stamp = flat(state.cache.stamp)                          # (L, C)
        live = stamp >= 0
        vals = one(state.cache.vals).reshape(*stamp.shape, -1)   # (L, C, K or 1)
        vals_ok = (~live[..., None] | ((vals >= 0) & (vals <= n[..., None]))).reshape(
            L, -1).all(1)
        stamp_ok = (~live | (stamp <= one(state.gen).reshape(L, 1))).all(1)
        cache_ok = vals_ok & stamp_ok
    out = torch.stack([finite, in_bounds, counts_ok, cache_ok], dim=-1)
    return out[0] if single else out


def validate_ok(problem: Problem, state: GAState) -> torch.Tensor:
    """() bool (or (L,) on a batched problem): all
    :data:`VALIDATION_CHECKS` hold."""
    return validate_state(problem, state).all(-1)


# -- host-side output -------------------------------------------------------

def front_of(state: GAState):
    """Feasible estimated Pareto front (paper Fig. 2 output)."""
    obj = state.obj.cpu().numpy()
    pops = state.pop.cpu().numpy()
    feas = state.viol.cpu().numpy() <= 0
    if not feas.any():
        feas = np.ones_like(feas)
    return pareto_front(obj[feas], extras={"genomes": pops[feas]})
