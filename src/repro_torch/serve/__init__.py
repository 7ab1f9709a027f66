"""Continuous-batching GA search service, PyTorch port of ``repro.serve``
(ROADMAP A12a).

``run_suite`` batches a *homogeneous* grid as one run; a real experiment
queue is heterogeneous: jobs with different datasets, generation budgets
and constraint bounds arrive over time. A :class:`SearchServer` keeps a
fixed number of *lanes*, one standing batched padded
:class:`~repro_torch.core.engine.Problem` and
:class:`~repro_torch.core.engine.GAState` on one device, and advances them
together in fixed-size *segments* of the budget-gated
``engine.run_scanned``. Each generation of a segment hands only the lanes
with budget left to the generation step, so each kernel launch covers
exactly those lanes and a retired or empty lane costs no kernel work.
Between segments a host-side :class:`LaneScheduler` retires lanes whose
budget is spent (returning their Pareto fronts) and admits queued
:class:`SearchJob`\\ s into the freed slots, padded into the shared
max-shape layout and written into the standing tensors lane by lane.

Every job's result is bit-identical to its standalone ``GATrainer.run``
(tests/test_torch_serve.py): admission runs the same
``engine.init_state``, and an active lane runs the same generation step
under the same gene-addressed RNG.

The supervisor, chaos injection and the checkpoint store (ROADMAP A12b)
are not ported yet: ``SearchServer.save``/``restore`` raise.
"""
from .jobs import SearchJob, JobResult            # noqa: F401
from .scheduler import LaneScheduler              # noqa: F401
from .server import SearchServer                  # noqa: F401

__all__ = ["SearchJob", "JobResult", "LaneScheduler", "SearchServer"]
