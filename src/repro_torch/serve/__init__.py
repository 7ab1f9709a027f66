"""Continuous-batching GA search service, PyTorch port of ``repro.serve``
(ROADMAP A12a and A12b).

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

A :class:`Supervisor` runs the server under a :class:`FaultPolicy`:
auto-checkpoints in the reference's on-disk format
(``repro_torch.checkpoint``; ``SearchServer.save``/``restore`` resume
either package's files), crash recovery from the newest checkpoint that
verifies, one batched ``validate_state`` per segment boundary with
quarantine of a failing lane, retry of transient faults raised before the
dispatch, a watchdog and convergence retirement. :class:`ChaosPlan`
injects each fault on a deterministic schedule. Unlike the reference,
``FaultPolicy.backend_fallback`` stays False and True is refused: the
port never degrades a kernel to its plain version.
"""
from .jobs import SearchJob, JobResult            # noqa: F401
from .scheduler import LaneScheduler              # noqa: F401
from .server import SearchServer                  # noqa: F401
from .supervisor import (Supervisor, FaultPolicy,            # noqa: F401
                         SegmentTimeoutError, LaneValidationError)
from .chaos import (ChaosPlan, SegmentFault, ChaosIOError,   # noqa: F401
                    ChaosKill, corrupt_checkpoint)

__all__ = ["SearchJob", "JobResult", "LaneScheduler", "SearchServer",
           "Supervisor", "FaultPolicy", "SegmentTimeoutError",
           "LaneValidationError", "ChaosPlan", "SegmentFault",
           "ChaosIOError", "ChaosKill", "corrupt_checkpoint"]
