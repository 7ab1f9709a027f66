"""The always-on GA search server, PyTorch port of ``repro.serve.server``:
segmented runs with lanes admitted and retired between segments.

The invariants:

  * Standing lanes: one batched padded :class:`~repro_torch.core.engine.Problem`
    and :class:`~repro_torch.core.engine.GAState` of ``n_lanes`` lanes on
    one device, built once (``engine.stack_problems``/``stack_states``).
  * Lane composition at runtime: admitting a job pads its Problem into the
    shared max-shape layout (``engine.pad_problem``), runs its
    ``init_state`` alone and writes each leaf into the lane's slot of the
    standing tensors; the batch is never restacked.
  * Retired lanes cost nothing: every segment is one budget-gated
    ``engine.run_scanned`` (``cfg.generations_budget``), which hands each
    generation only the lanes with budget left, so a retired or empty lane
    is in no kernel launch and no dedup bound, and its state passes
    through bitwise. A retired slot is parked on a null problem with
    budget 0.
  * Bit-identity: each job's retired state/front/accounting equals its
    standalone ``GATrainer.run`` exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import engine, prng, sweep
from ..core import genome as genome_mod
from ..core.engine import GAConfig, GAState, Problem
from ..device import device_of, not_ported
from .jobs import JobResult, SearchJob
from .scheduler import LaneScheduler

# the tensor leaves of a Problem besides its GeneTable's
_PROBLEM_LEAVES = ("x_int", "labels", "baseline_acc", "crossover_rate",
                   "mutation_rate_gene", "max_acc_loss", "out_mask", "inv_n",
                   "n_valid_samples", "variation_scale", "generations_budget")


def _canon_cfg(cfg: GAConfig) -> GAConfig:
    """The job-facing config identity: the server owns the batch-axis tag
    and the budget gate, so submitted problems match modulo those."""
    return dataclasses.replace(cfg, batch_axis=None, generations_budget=None)


def _set_problem_lane(stacked: Problem, lane: int, single: Problem) -> Problem:
    """Write ``single``'s leaves into lane ``lane`` of ``stacked``; returns
    a new Problem over the same tensors, so nothing memoized on the old one
    (lane views' data, lane subsets) outlives the write."""
    for f in _PROBLEM_LEAVES:
        getattr(stacked, f)[lane] = getattr(single, f)
    for dst, src in zip(stacked.genes.leaves(), single.genes.leaves()):
        dst[lane] = src
    return dataclasses.replace(stacked)


def _set_state_lane(stacked: GAState, lane: int, single: GAState):
    for f in engine._STATE_TENSORS:
        getattr(stacked, f)[lane] = getattr(single, f)
    if stacked.cache is not None:
        for dst, src in zip(engine._cache_leaves(stacked.cache),
                            engine._cache_leaves(single.cache)):
            dst[lane] = src


@dataclasses.dataclass
class _JobRecord:
    """Host-side per-job bookkeeping."""
    job_id: int
    name: str | None
    generations: int
    seed: int
    job: SearchJob | None = None
    lane: int | None = None
    positions: np.ndarray | None = None   # inner → padded gene positions
    remaining: int = 0
    unique_evals: int = 0
    cache_hits: int = 0
    admitted_segment: int | None = None


class SearchServer:
    """Continuous-batching GA search service.

    ``submit()`` enqueues :class:`SearchJob`\\ s, ``step()`` advances every
    busy lane by one ``segment_len``-generation segment (admitting queued
    jobs into free lanes first) and returns the jobs retired at the
    segment boundary, ``drain()`` steps until the queue and lanes are
    empty. All jobs of a server share one ``GAConfig`` but each brings its
    own dataset, topology (≤ the server's ``spec``), PRNG seed, doping and
    generation budget. The lanes live on ``device`` (the card unless the
    CPU is asked for; a CUDA request without a card raises), and so must
    every job's problem.
    """

    def __init__(self, spec: "genome_mod.GenomeSpec", cfg: GAConfig, *,
                 max_samples: int, n_lanes: int = 4, segment_len: int = 16,
                 policy: str = "fifo", device="cuda"):
        if segment_len < 1:
            raise ValueError(f"segment_len must be >= 1, got {segment_len}")
        if cfg.backends.fitness == "jnp":
            raise ValueError("the serve path pads problems; use a "
                             "count-based fitness backend, not 'jnp'")
        self.device = device_of(device)
        self.spec = spec
        self.max_samples = int(max_samples)
        self.n_lanes = int(n_lanes)
        self.segment_len = int(segment_len)
        # the server-internal config: budget gate on (a lane with no job has
        # budget 0 and never runs), lanes tagged with the batch axis
        self._cfg = dataclasses.replace(cfg, batch_axis=engine.BATCH_AXIS,
                                        generations_budget=0)
        # admission inits run on one lane's problem, untagged
        self._cfg_init = dataclasses.replace(self._cfg, batch_axis=None)
        self._sched = LaneScheduler(self.n_lanes, policy)
        self._jobs: dict[int, _JobRecord] = {}
        self._next_id = 0
        self._segments_done = 0
        self._null = self._null_problem()
        null_state, _ = engine.init_state(
            dataclasses.replace(self._null, cfg=self._cfg_init),
            prng.PRNGKey(0, self.device))
        self._problems = engine.stack_problems([self._null] * self.n_lanes)
        self._states = engine.stack_states([null_state] * self.n_lanes)

    @classmethod
    def for_problems(cls, problems, **kw) -> "SearchServer":
        """Server sized for a known family of datasets: the shared spec is
        their max-shape embedding (``sweep.suite_spec``) and the sample
        axis fits the widest dataset. ``cfg`` and, unless given, ``device``
        are taken from the first problem (all jobs must match them)."""
        problems = list(problems)
        spec = sweep.suite_spec(problems)
        max_samples = max(int(p.x_int.shape[0]) for p in problems)
        kw.setdefault("device", problems[0].device)
        return cls(spec, problems[0].cfg, max_samples=max_samples, **kw)

    # -- lane composition ---------------------------------------------------

    def _null_problem(self) -> Problem:
        """The inert lane filler: budget 0 (never active) and a single
        valid sample."""
        S, n_in = self.max_samples, self.spec.topo.sizes[0]
        dev = self.device
        p = Problem(torch.zeros((S, n_in), dtype=torch.int32, device=dev),
                    torch.full((S,), -1, dtype=torch.int32, device=dev),  # −1: padding
                    torch.tensor(1.0, dtype=torch.float32, device=dev),
                    self.spec, self._cfg)
        return dataclasses.replace(
            p, n_valid_samples=torch.tensor(1, dtype=torch.int32, device=dev),
            generations_budget=torch.tensor(0, dtype=torch.int32, device=dev))

    def _admit(self, lane: int, job_id: int):
        rec = self._jobs[job_id]
        job = rec.job
        inner = dataclasses.replace(job.problem, cfg=self._cfg_init)
        padded = engine.pad_problem(inner, self.spec, self.max_samples)
        padded = dataclasses.replace(padded, generations_budget=torch.tensor(
            job.generations, dtype=torch.int32, device=self.device))
        rec.positions = genome_mod.pad_positions(job.problem.spec, self.spec)
        doping = None
        if job.doping_seeds is not None:
            n_dope = max(1, int(self._cfg.doping_frac * self._cfg.pop_size))
            doping = sweep.doped_lane_rows(job.doping_seeds, rec.positions,
                                           self.spec.n_genes, n_dope)
        # the exact init a standalone GATrainer would run on this job
        state, n0 = engine.init_state(padded, prng.PRNGKey(job.seed, self.device), doping)
        self._problems = _set_problem_lane(self._problems, lane, padded)
        _set_state_lane(self._states, lane, state)
        rec.lane = lane
        rec.remaining = job.generations
        rec.unique_evals = int(n0)
        rec.cache_hits = 0
        rec.admitted_segment = self._segments_done

    def _peel(self, lane: int, rec: _JobRecord) -> GAState:
        """The lane's state as the job's own copy: population gathered to
        the unpadded layout, no cache (the slot is reused by later jobs)."""
        st = engine.state_at(self._states, lane)
        pos = torch.as_tensor(rec.positions, device=self.device)
        leaves = {f: getattr(st, f).clone() for f in engine._STATE_TENSORS}
        leaves["pop"] = st.pop[:, pos]
        return GAState(**leaves, cache=None)

    def _free(self, lane: int, rec: _JobRecord):
        """Park the lane on the null problem (budget 0: it runs no more)
        and free it."""
        self._problems = _set_problem_lane(self._problems, lane, self._null)
        rec.lane = None
        self._sched.free(lane)

    def _retire(self, lane: int, job_id: int, *,
                converged: bool = False) -> JobResult:
        rec = self._jobs[job_id]
        st = self._peel(lane, rec)
        result = JobResult(
            job_id=job_id, name=rec.name, front=engine.front_of(st),
            state=st, generations=rec.generations,
            unique_evals=rec.unique_evals, cache_hits=rec.cache_hits,
            admitted_segment=rec.admitted_segment,
            retired_segment=self._segments_done,
            generations_run=rec.generations - max(rec.remaining, 0),
            converged=converged)
        self._free(lane, rec)
        return result

    # -- fault-tolerance hooks ----------------------------------------------

    def retire_lane(self, lane: int, *, converged: bool = False) -> JobResult:
        """Force-retire a busy lane mid-budget (convergence retirement).
        The result is a healthy ``JobResult`` whose ``generations_run``
        records how far the lane actually got."""
        job_id = self._sched.lane_job[lane]
        if job_id is None:
            raise ValueError(f"lane {lane} has no job to retire")
        return self._retire(lane, job_id, converged=converged)

    def quarantine_lane(self, lane: int, error: str) -> JobResult:
        """Retire a busy lane as FAILED: its state tripped validation.

        The lane's (suspect) state is still peeled into the result for
        forensics, but ``front`` is None and ``ok`` is False; the slot is
        parked on the null problem and freed. Each lane's generation reads
        only its own rows and cache, so a poisoned lane cannot have
        perturbed its siblings.
        """
        job_id = self._sched.lane_job[lane]
        if job_id is None:
            raise ValueError(f"lane {lane} has no job to quarantine")
        rec = self._jobs[job_id]
        result = JobResult(
            job_id=job_id, name=rec.name, front=None, state=self._peel(lane, rec),
            generations=rec.generations, unique_evals=rec.unique_evals,
            cache_hits=rec.cache_hits,
            admitted_segment=rec.admitted_segment,
            retired_segment=self._segments_done, ok=False, error=error,
            generations_run=rec.generations - max(rec.remaining, 0))
        self._free(lane, rec)
        return result

    def lane_state(self, lane: int) -> GAState:
        """The full padded GAState of one lane (cache included, views of the
        standing tensors): what ``engine.validate_state`` checks."""
        return engine.state_at(self._states, lane)

    def lane_problem(self, lane: int) -> Problem:
        return self._problems.lane(lane)

    # -- the service loop ---------------------------------------------------

    def submit(self, job: SearchJob | Problem, *, generations=None,
               seed: int = 0, doping_seeds=None, name=None) -> int:
        """Enqueue a job; returns its id. Accepts a :class:`SearchJob` or
        a bare Problem plus the job fields as keywords."""
        if not isinstance(job, SearchJob):
            if generations is None:
                generations = job.cfg.generations
            job = SearchJob(job, generations, seed=seed,
                            doping_seeds=doping_seeds, name=name)
        if job.generations < 1:
            raise ValueError(f"generations must be >= 1, got "
                             f"{job.generations}")
        if _canon_cfg(job.problem.cfg) != _canon_cfg(self._cfg):
            raise ValueError("job problem's GAConfig does not match the "
                             "server's (one lane batch needs one config; "
                             "seed/generations ride on the job)")
        if int(job.problem.x_int.shape[0]) > self.max_samples:
            raise ValueError(
                f"job has {job.problem.x_int.shape[0]} samples; the server "
                f"was sized for max_samples={self.max_samples}")
        if job.problem.device != self.device:
            raise ValueError(f"job problem lives on {job.problem.device}, the "
                             f"server's lanes on {self.device}")
        genome_mod.pad_positions(job.problem.spec, self.spec)  # fit check
        job_id = self._next_id
        self._next_id += 1
        self._jobs[job_id] = _JobRecord(
            job_id=job_id, name=job.name, generations=int(job.generations),
            seed=int(job.seed), job=job)
        self._sched.enqueue(job_id)
        return job_id

    def step(self) -> list[JobResult]:
        """Admit queued jobs into free lanes, run ONE segment, retire
        budget-exhausted lanes; returns their :class:`JobResult`\\ s."""
        budgets = {j: self._jobs[j].generations for j in self._sched.pending}
        for lane, job_id in self._sched.admissions(budgets):
            self._admit(lane, job_id)
        busy = self._sched.busy_lanes
        if not busy:
            return []
        self._states, aux = engine.run_scanned(self._problems, self._states,
                                               self.segment_len)
        self._segments_done += 1
        n_eval = aux[2].cpu().numpy()        # (n_lanes, segment_len)
        n_hit = aux[3].cpu().numpy()
        retired = []
        for lane in busy:
            rec = self._jobs[self._sched.lane_job[lane]]
            rec.unique_evals += int(n_eval[lane].sum())
            rec.cache_hits += int(n_hit[lane].sum())
            rec.remaining -= self.segment_len
            if rec.remaining <= 0:
                retired.append(self._retire(lane, rec.job_id))
        return retired

    def drain(self) -> list[JobResult]:
        """Step until every queued and in-flight job has retired."""
        results = []
        while self._sched.has_work:
            results.extend(self.step())
        return results

    @property
    def segments_done(self) -> int:
        return self._segments_done

    @property
    def has_work(self) -> bool:
        """True while any job is queued or in a lane."""
        return self._sched.has_work

    @property
    def pending_jobs(self) -> list[int]:
        return list(self._sched.pending)

    @property
    def active_jobs(self) -> dict[int, int]:
        """lane → job id of every busy lane."""
        return {i: j for i, j in enumerate(self._sched.lane_job)
                if j is not None}

    # -- checkpointing (ROADMAP A12b) ---------------------------------------

    def save(self, directory: str, *, keep: int = 3,
             allow_pending: bool = False) -> str:
        raise not_ported("SearchServer checkpoints", "A12b")

    @classmethod
    def restore(cls, directory: str, spec: "genome_mod.GenomeSpec",
                cfg: GAConfig, *, step: int | None = None) -> "SearchServer":
        raise not_ported("SearchServer checkpoints", "A12b")
