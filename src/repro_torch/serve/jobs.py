"""Job and result records of the GA search service, PyTorch port of
``repro.serve.jobs``."""
from __future__ import annotations

import dataclasses

from ..core.engine import GAState, Problem


@dataclasses.dataclass
class SearchJob:
    """One GA search request: a dataset/topology/config problem plus the
    run geometry a standalone ``GATrainer.run`` would get.

    ``problem`` is the *unpadded* per-dataset Problem on the server's
    device (the server embeds it into its shared max-shape layout on
    admission); its ``cfg`` must match the server's (one population size,
    backend policy, dedup mode, ...). ``generations`` is this job's own
    budget: jobs with different budgets share lanes. ``doping_seeds`` are
    genomes in the problem's unpadded layout (paper §IV-A), handled exactly
    like ``run_suite``'s.
    """
    problem: Problem
    generations: int
    seed: int = 0
    doping_seeds: object = None
    name: str | None = None


@dataclasses.dataclass
class JobResult:
    """A retired job: its Pareto front plus trainer-parity accounting.

    ``front`` / ``state`` match the standalone ``GATrainer.run`` of the
    same (problem, seed, generations, doping) bit for bit: ``state.pop`` is
    gathered back to the job's unpadded gene layout (like
    ``SuiteResult.state_at``) and ``unique_evals`` / ``cache_hits`` count
    exactly what that trainer would report. The returned state is the
    job's own copy and drops the lane's EvalCache (scratch, not a result).

    ``ok`` is False for a *quarantined* job, one whose lane tripped
    ``engine.validate_state``: ``error`` then carries the diagnostics,
    ``front`` is None and ``state`` is the suspect lane state, kept for
    forensics. ``generations_run`` counts the generations actually run:
    ``generations`` on normal retirement, fewer when the lane was retired
    early (``converged=True``) or quarantined mid-budget.
    """
    job_id: int
    name: str | None
    front: dict | None
    state: GAState
    generations: int
    unique_evals: int
    cache_hits: int
    admitted_segment: int
    retired_segment: int
    ok: bool = True
    error: str | None = None
    generations_run: int | None = None
    converged: bool = False
