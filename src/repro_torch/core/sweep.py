"""Config-axis and dataset-axis GA sweeps as one batched run, PyTorch port
of ``repro.core.sweep``.

:func:`run_grid` runs every (seed, crossover_rate, mutation_rate_gene,
max_acc_loss, baseline_acc) cell of a cartesian grid as the lanes of one
batched problem; :func:`run_suite` adds the dataset axis, embedding each
dataset's problem into one shared max-shape layout (``engine.pad_problem``)
so lanes of different topologies and sample counts stack. Each generation
launches every kernel of its path once for all lanes, and each lane's
kernel blocks read its own sample count, so a lane costs its own samples.

Every cell is bit-identical to the sequential ``GATrainer.run`` with its
seed and hyperparameters, on its unpadded dataset, ``unique_evals`` and
``cache_hits`` included: the lanes share one dedup evaluation bound per
generation and gather only their own rows.

``mesh=`` takes a :class:`~repro_torch.launch.mesh.DeviceMesh`. The
reference's ``shard_map`` pads the cells to a multiple of the mesh's
entries along ``axis_names`` and gives each entry a slice; a DeviceMesh's
entries all live on one device, so every cell runs in the one batched run
of lanes, bit-identical to the run without ``mesh`` (as the reference's
sharded runs are to its unsharded ones). Any other mesh spans devices and
raises (ROADMAP A13b). The reference's ``jit`` argument steers XLA only and
is not taken.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import engine, prng
from . import genome as genome_mod
from .engine import GAState, Problem, pad_problem, batch_problem, stack_problems
from ..launch import mesh as mesh_mod

__all__ = ["grid_cells", "run_grid", "SweepResult", "suite_spec", "pad_lane",
           "stack_problems", "doped_lane_rows", "run_suite", "SuiteResult"]


def grid_cells(seeds, crossover_rates=None, mutation_rates=None,
               max_acc_losses=None, baseline_accs=None, cfg=None,
               problem=None):
    """Cartesian (seed × config) grid as flat per-cell arrays.

    ``None`` axes collapse to one default: the ``problem``'s hyperparameter
    leaves when given, else the ``cfg`` statics (``baseline_acc`` has no
    cfg static; its default there is 1.0, ``GATrainer``'s chance level).
    Returns int32 ``seed`` and float32 ``crossover_rate``/
    ``mutation_rate_gene``/``max_acc_loss``/``baseline_acc`` arrays of shape
    (n_cells,) and the grid ``shape`` (n_seeds, n_crossover, n_mutation,
    n_max_loss, n_baseline); cells are C-ordered over it."""
    if problem is not None:
        pc0, pm0, mal0, ba0 = (float(problem.crossover_rate),
                               float(problem.mutation_rate_gene),
                               float(problem.max_acc_loss),
                               float(problem.baseline_acc))
    else:
        cfg = cfg if cfg is not None else engine.GAConfig()
        pc0, pm0, mal0, ba0 = (cfg.crossover_rate, cfg.mutation_rate_gene,
                               cfg.max_acc_loss, 1.0)
    axes = [np.asarray(list(seeds), np.int32)] + [
        np.asarray([v0] if vals is None else list(vals), np.float32)
        for v0, vals in ((pc0, crossover_rates), (pm0, mutation_rates),
                         (mal0, max_acc_losses), (ba0, baseline_accs))]
    shape = tuple(len(a) for a in axes)
    grids = np.meshgrid(*axes, indexing="ij")
    return {"seed": grids[0].reshape(-1),
            "crossover_rate": grids[1].reshape(-1),
            "mutation_rate_gene": grids[2].reshape(-1),
            "max_acc_loss": grids[3].reshape(-1),
            "baseline_acc": grids[4].reshape(-1),
            "shape": shape}


def _cell_problem(p: Problem, cells: dict, k: int) -> Problem:
    return p.with_hypers(np.float32(cells["crossover_rate"][k]),
                         np.float32(cells["mutation_rate_gene"][k]),
                         np.float32(cells["max_acc_loss"][k]),
                         np.float32(cells["baseline_acc"][k]))


def _run_lanes(problems: list, seeds, doping, generations: int):
    """init → scanned run over the lanes of the stacked ``problems``."""
    stacked = stack_problems(problems)
    keys = torch.stack([prng.PRNGKey(int(s), stacked.device) for s in seeds])
    states, n0 = engine.init_state(stacked, keys, doping)
    states, aux = engine.run_scanned(stacked, states, generations)
    return states, aux, n0


def _check_mesh(mesh, device, axis_names):
    """``mesh=`` must be a DeviceMesh on the problems' device whose axes
    include ``axis_names`` (entries on distinct devices are ROADMAP A13b)."""
    if mesh is None:
        return
    mesh = mesh_mod.as_device_mesh(mesh)
    if mesh.device != device:
        raise ValueError(f"the mesh lives on {mesh.device}, the problems on {device}")
    mesh.entries(axis_names)


@dataclasses.dataclass
class SweepResult:
    """Batched result of a (seed × config) sweep: every ``states`` leaf
    has a leading (n_cells,) axis (one EvalCache per cell in the default
    dedup mode); ``aux`` is (best_err, best_area, n_eval, n_hit), each
    (n_cells, gens); ``init_evals`` the per-cell unique rows of the initial
    scoring. Cells are C-ordered over ``shape``."""
    problem: Problem
    cells: dict
    states: GAState
    aux: tuple
    init_evals: torch.Tensor

    @property
    def shape(self) -> tuple:
        return self.cells["shape"]

    @property
    def n_cells(self) -> int:
        return int(self.cells["seed"].shape[0])

    def cell(self, i: int) -> dict:
        """Hyperparameters of flat cell ``i``."""
        return {"seed": int(self.cells["seed"][i]),
                "crossover_rate": float(self.cells["crossover_rate"][i]),
                "mutation_rate_gene": float(self.cells["mutation_rate_gene"][i]),
                "max_acc_loss": float(self.cells["max_acc_loss"][i]),
                "baseline_acc": float(self.cells["baseline_acc"][i])}

    def state_at(self, i: int) -> GAState:
        return engine.state_at(self.states, i)

    def front_at(self, i: int):
        """Feasible estimated Pareto front of cell ``i``."""
        return engine.front_of(self.state_at(i))

    def fronts(self):
        return [self.front_at(i) for i in range(self.n_cells)]

    def unique_evals(self, i: int) -> int:
        """Rows cell ``i`` evaluated (init + every generation), comparable
        to ``GATrainer.unique_evals``."""
        return int(self.init_evals[i]) + int(self.aux[2][i].sum())

    def cache_hits(self, i: int) -> int:
        """Evaluations cell ``i`` reused from its cache, comparable to
        ``GATrainer.cache_hits``."""
        return int(self.aux[3][i].sum())


def run_grid(problem: Problem, seeds, *, crossover_rates=None,
             mutation_rates=None, max_acc_losses=None, baseline_accs=None,
             generations: int | None = None, doping_seeds=None,
             mesh=None, axis_names: tuple[str, ...] = ("data",)) -> SweepResult:
    """Run the full (seed × config) grid as one batched run.

    seeds: integer PRNG seeds, one independent run per cell.
    crossover_rates / mutation_rates / max_acc_losses / baseline_accs:
        swept values of those hyperparameters (``None`` keeps the
        problem's value); ``baseline_acc`` is a constraint-pressure axis.
    generations: overrides ``problem.cfg.generations``.
    doping_seeds: the same doping genomes for every cell (paper §IV-A).

    Every cell is bit-identical to a sequential ``GATrainer.run`` whose
    ``GAConfig`` carries that cell's hyperparameters and seed (and whose
    ``baseline_acc`` argument carries the cell's baseline)."""
    _check_mesh(mesh, problem.device, axis_names)
    cells = grid_cells(seeds, crossover_rates, mutation_rates, max_acc_losses,
                       baseline_accs, problem=problem)
    gens = problem.cfg.generations if generations is None else generations
    lane = batch_problem(problem)
    lanes = [_cell_problem(lane, cells, k) for k in range(cells["seed"].shape[0])]
    states, aux, n0 = _run_lanes(lanes, cells["seed"], doping_seeds, gens)
    return SweepResult(lane, cells, states, aux, n0)


# -- suite batching: (dataset × seed × config) --------------------------------

def suite_spec(problems) -> genome_mod.GenomeSpec:
    """The shared max-shape GenomeSpec every suite problem embeds into."""
    return genome_mod.GenomeSpec(genome_mod.max_topology([p.spec.topo for p in problems]))


def pad_lane(problem: Problem, spec_pad: genome_mod.GenomeSpec, n_samples: int) -> Problem:
    """``problem`` embedded into the shared ``spec_pad``/``n_samples``
    layout and tagged with the batch axis: one lane of a batched run,
    bit-identical to its unpadded sequential run."""
    return batch_problem(pad_problem(problem, spec_pad, n_samples))


def doped_lane_rows(doping_seeds, positions, n_genes: int, n_dope: int) -> np.ndarray:
    """Per-lane doping rows in the padded layout: the dataset's unpadded
    doping genomes expanded to the ``n_dope``-row block (repeating seeds as
    ``engine.initial_population`` does) and scattered into the shared gene
    axis."""
    dope = engine._doping_array(doping_seeds, "cpu").numpy()
    reps = np.resize(np.arange(dope.shape[0]), n_dope)
    return genome_mod.pad_genomes(dope[reps], positions, n_genes)


@dataclasses.dataclass
class SuiteResult:
    """Batched result of a (dataset × seed × config) suite run: ``states``'
    leaves carry a leading (n_cells,) axis; cells are C-ordered over
    ``shape`` = (n_datasets, n_seeds, n_crossover, n_mutation, n_max_loss,
    n_baseline). ``state_at`` peels a cell and by default gathers its
    population back to the dataset's unpadded gene layout."""
    problems: list              # the original (unpadded) problems
    spec: genome_mod.GenomeSpec  # the shared padded spec
    names: list                 # per-dataset labels
    positions: list             # per-dataset inner → padded gene positions
    cells: dict                 # flat per-cell arrays + the grid shape
    states: GAState
    aux: tuple                  # (best_err, best_area, n_eval, n_hit)
    init_evals: torch.Tensor    # (n_cells,) unique rows of the init scoring

    @property
    def shape(self) -> tuple:
        return self.cells["shape"]

    @property
    def n_cells(self) -> int:
        return int(self.cells["seed"].shape[0])

    def dataset_of(self, i: int) -> int:
        return int(self.cells["dataset"][i])

    def cell(self, i: int) -> dict:
        return {"dataset": self.names[self.dataset_of(i)],
                "seed": int(self.cells["seed"][i]),
                "crossover_rate": float(self.cells["crossover_rate"][i]),
                "mutation_rate_gene": float(self.cells["mutation_rate_gene"][i]),
                "max_acc_loss": float(self.cells["max_acc_loss"][i]),
                "baseline_acc": float(self.cells["baseline_acc"][i])}

    def cells_of(self, name) -> list:
        """Flat indices of every cell of dataset ``name`` (label or index)."""
        d = name if isinstance(name, int) else list(self.names).index(name)
        return [i for i in range(self.n_cells) if self.dataset_of(i) == d]

    def state_at(self, i: int, unpad: bool = True) -> GAState:
        state = engine.state_at(self.states, i)
        if unpad:
            pos = torch.as_tensor(self.positions[self.dataset_of(i)],
                                  device=state.pop.device)
            state = dataclasses.replace(state, pop=state.pop[:, pos])
        return state

    def front_at(self, i: int):
        """Feasible Pareto front of cell ``i``, genomes in the dataset's
        unpadded layout."""
        return engine.front_of(self.state_at(i))

    def unique_evals(self, i: int) -> int:
        """Rows cell ``i`` evaluated: equals the unpadded sequential
        ``GATrainer.unique_evals``."""
        return int(self.init_evals[i]) + int(self.aux[2][i].sum())

    def cache_hits(self, i: int) -> int:
        """Evaluations cell ``i`` reused from its cache: equals the
        unpadded sequential ``GATrainer.cache_hits``."""
        return int(self.aux[3][i].sum())


def _sample_buckets(sizes, factor):
    """Group dataset indices so no lane pads its sample axis by more than
    ``factor``: greedy over sizes in descending order, a dataset joins the
    current bucket while ``bucket_max <= factor * its_size``; each bucket
    sorted by original index. ``None``: one bucket."""
    if factor is None:
        return [list(range(len(sizes)))]
    order = sorted(range(len(sizes)), key=lambda d: -sizes[d])
    buckets, bound = [], None
    for d in order:
        if bound is not None and bound <= factor * sizes[d]:
            buckets[-1].append(d)
        else:
            buckets.append([d])
            bound = sizes[d]
    return [sorted(b) for b in buckets]


def run_suite(problems, seeds, *, crossover_rates=None, mutation_rates=None,
              max_acc_losses=None, baseline_accs=None,
              generations: int | None = None, doping_seeds=None, names=None,
              spec: genome_mod.GenomeSpec | None = None,
              sample_bucket_factor: float | None = None,
              mesh=None, axis_names: tuple[str, ...] = ("data",)) -> SuiteResult:
    """Run several datasets' (seed × config) grids as one batched run per
    sample-size bucket.

    problems: per-dataset Problems (topologies and sample counts may
        differ; they embed into one max-shape layout). All must share one
        ``GAConfig``.
    seeds / crossover_rates / mutation_rates / max_acc_losses /
        baseline_accs: as in :func:`run_grid`; the grid repeats per dataset
        (an unswept baseline keeps each dataset's own).
    doping_seeds: optional per-dataset doping genomes in their unpadded
        layouts, aligned with ``problems`` (:func:`doped_lane_rows`).
    names: per-dataset labels for ``SuiteResult.cell``/``cells_of``.
    sample_bucket_factor: group datasets so that no lane's sample axis
        exceeds ``factor`` times its own, one batched run per group
        (:func:`_sample_buckets`). The reference needs it because its lanes
        pay the widest lane's sample bound; here each lane's kernel blocks
        read their own bound, so the default is ``None``: one run for every
        lane. Per-cell results are the same either way.

    Every cell is bit-identical to the sequential unpadded ``GATrainer.run``
    on its dataset with the cell's seed and hyperparameters."""
    problems = list(problems)
    if not problems:
        raise ValueError("run_suite needs at least one problem")
    _check_mesh(mesh, problems[0].device, axis_names)
    cfg0 = problems[0].cfg
    for p in problems[1:]:
        if p.cfg != cfg0:
            raise ValueError("suite problems must share one GAConfig "
                             f"(got {p.cfg} vs {cfg0})")
    names = list(names) if names is not None else list(range(len(problems)))
    gens = cfg0.generations if generations is None else generations
    spec_pad = suite_spec(problems) if spec is None else spec
    positions = [genome_mod.pad_positions(p.spec, spec_pad) for p in problems]
    sizes = [int(p.x_int.shape[0]) for p in problems]
    n_dope = max(1, int(cfg0.doping_frac * cfg0.pop_size))
    if doping_seeds is not None and len(doping_seeds) != len(problems):
        raise ValueError("doping_seeds must align with problems")

    # every lane is padded to the global sample count, so all buckets share
    # one layout and their per-cell outputs gather in dataset order
    s_max = max(sizes)
    per_dataset, meta, grid_shape = {}, {}, None
    for bucket in _sample_buckets(sizes, sample_bucket_factor):
        lanes, dope, seeds_b, n_grid = [], [], [], {}
        for d in bucket:
            p = pad_lane(problems[d], spec_pad, s_max)
            cells_d = grid_cells(seeds, crossover_rates, mutation_rates,
                                 max_acc_losses, baseline_accs, problem=p)
            n_grid[d] = cells_d["seed"].shape[0]
            lanes += [_cell_problem(p, cells_d, k) for k in range(n_grid[d])]
            seeds_b += list(cells_d["seed"])
            if doping_seeds is not None:
                rows = doped_lane_rows(doping_seeds[d], positions[d], spec_pad.n_genes,
                                       n_dope)
                dope += [rows] * n_grid[d]
            meta[d] = [(d,) + tuple(cells_d[k][c] for k in
                                    ("seed", "crossover_rate", "mutation_rate_gene",
                                     "max_acc_loss", "baseline_acc"))
                       for c in range(n_grid[d])]
            grid_shape = cells_d["shape"]
        states, aux, n0 = _run_lanes(lanes, seeds_b,
                                     None if doping_seeds is None else np.stack(dope), gens)
        j = 0
        for d in bucket:
            per_dataset[d] = [(engine.state_at(states, i), tuple(a[i] for a in aux), n0[i])
                              for i in range(j, j + n_grid[d])]
            j += n_grid[d]

    flat = [m for d in range(len(problems)) for m in meta[d]]
    cells = {"dataset": np.asarray([m[0] for m in flat], np.int32),
             "seed": np.asarray([m[1] for m in flat], np.int32),
             "crossover_rate": np.asarray([m[2] for m in flat], np.float32),
             "mutation_rate_gene": np.asarray([m[3] for m in flat], np.float32),
             "max_acc_loss": np.asarray([m[4] for m in flat], np.float32),
             "baseline_acc": np.asarray([m[5] for m in flat], np.float32),
             "shape": (len(problems),) + grid_shape}
    out = [r for d in range(len(problems)) for r in per_dataset[d]]
    aux = tuple(torch.stack([r[1][k] for r in out]) for k in range(4))
    return SuiteResult(problems, spec_pad, names, positions, cells,
                       engine.stack_states([r[0] for r in out]), aux,
                       torch.stack([r[2] for r in out]))
