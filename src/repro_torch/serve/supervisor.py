"""Fault-tolerant supervision of the continuous-batching serve loop,
PyTorch port of ``repro.serve.supervisor``.

:class:`Supervisor` wraps a :class:`~repro_torch.serve.SearchServer` and
runs its segment loop under a :class:`FaultPolicy`:

  * **auto-checkpointing** — every ``checkpoint_every`` supervisor segments
    the whole server (states, problems, scheduler metadata, the queued
    jobs' records) goes through ``repro_torch.checkpoint``'s two-phase
    commit; a crash at ANY instant loses at most one checkpoint interval.
  * **crash recovery** — :meth:`Supervisor.recover` finds the newest
    checkpoint that passes full integrity verification
    (``latest_valid_step``: truncated or bit-flipped steps are skipped,
    ``.tmp`` half-writes are invisible), restores it and resumes; resumed
    jobs finish bit-identical to the uninterrupted run.
  * **lane health validation and quarantine** — at every segment boundary
    ONE batched ``engine.validate_state`` over all lanes, read to the host
    once, checks the engine invariants; a busy lane with a False flag is
    *quarantined*: retired with a failed :class:`JobResult` naming the
    tripped checks, its slot freed, its siblings untouched (each lane's
    generation reads only its own rows and cache).
  * **transient-fault retry** — faults raised at the boundary BEFORE the
    dispatch (``OSError``, injected :class:`~repro_torch.serve.chaos.
    SegmentFault`) and checkpoint-save ``OSError``\\ s retry under capped
    exponential backoff. Nothing raised inside the dispatch is retried:
    the segment writes the standing lane tensors, and a CUDA error leaves
    the context unusable, so those propagate and recovery goes through
    :meth:`Supervisor.recover`. (The reference retries an ``OSError`` from
    inside its dispatch too; its donated buffers are then invalid as well.)
  * **watchdog** — ``segment_timeout_s`` bounds one segment's wall clock;
    the segment runs on a thread under the caller's grad mode and current
    CUDA stream, and a hung segment raises :class:`SegmentTimeoutError`
    (fatal, never retried in-process).
  * **no backend fallback** — the port never degrades a kernel to its
    plain version, so ``FaultPolicy.backend_fallback`` stays False here and
    True is refused with a ``ValueError`` (the reference's default is True:
    the slice's one documented departure). The jobs keep the backends their
    config names; a caller that wants degrading resolves them itself with
    ``kernels.backend.resolve_backends(..., fallback=True)`` and builds its
    problems with the result.
  * **convergence retirement** — with ``patience=N`` a lane whose Pareto
    front fingerprint is unchanged for N consecutive segments retires early
    (``converged=True``); off by default.

Every fault path is exercised deterministically by
:mod:`repro_torch.serve.chaos` (tests/test_torch_supervisor.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint import manager as ckpt
from ..core import engine
from .chaos import ChaosPlan, SegmentFault
from .jobs import JobResult
from .server import SearchServer


class SegmentTimeoutError(RuntimeError):
    """A segment exceeded ``FaultPolicy.segment_timeout_s``. Fatal by
    design: the hung segment may still be writing the lane tensors, so the
    only sound recovery is a fresh process and :meth:`Supervisor.recover`
    from the last checkpoint."""


class LaneValidationError(RuntimeError):
    """A lane failed ``engine.validate_state`` and the policy forbids
    quarantine (``quarantine=False``): fail the whole server loudly."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """The supervisor's knobs. The defaults do no harm: validation and
    quarantine on, no checkpointing (it needs a directory), no convergence
    retirement, no watchdog, no backend fallback. A default-policy
    Supervisor over a fault-free stream equals the bare server bit for bit.

    ``checkpoint_every``: auto-checkpoint cadence in supervisor segments
    (0 = off). ``keep``: checkpoints retained (GC). ``max_retries`` /
    ``backoff_base_s`` / ``backoff_cap_s``: capped exponential backoff for
    transient faults (delay ``base * 2^attempt`` capped at ``cap``).
    ``patience``: consecutive unchanged-front segments before early
    retirement (0 = off). ``segment_timeout_s``: per-segment watchdog
    (None = off). ``backend_fallback``: kept for the reference's surface
    and must stay False (the reference's default is True): the port never
    swaps a kernel for its plain version, and True raises ``ValueError``.
    """
    checkpoint_every: int = 0
    keep: int = 3
    validate: bool = True
    quarantine: bool = True
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    patience: int = 0
    segment_timeout_s: Optional[float] = None
    backend_fallback: bool = False

    def __post_init__(self):
        if self.backend_fallback:
            raise ValueError(
                "FaultPolicy(backend_fallback=True): the port never degrades a kernel "
                "to its plain version; resolve the jobs' backends with "
                "kernels.backend.resolve_backends(..., fallback=True) and build the "
                "problems with the result")


def _front_fingerprint(state) -> str:
    """Order-stable digest of a lane's feasible Pareto front: the set of
    objective points (sorted by ``front_of``), NOT the genomes, so neutral
    drift on a stable front does not count as progress."""
    front = engine.front_of(state)
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(front["objectives"], np.float32).tobytes())
    return h.hexdigest()


class Supervisor:
    """Run a :class:`SearchServer` under a :class:`FaultPolicy`.

    The bare server's surface (:meth:`submit`, :meth:`step`, :meth:`drain`)
    with fault handling between segments. ``chaos`` (a
    :class:`~repro_torch.serve.chaos.ChaosPlan`) injects deterministic
    faults; ``sleep`` is injectable so backoff tests run instantly.
    """

    def __init__(self, server: SearchServer,
                 policy: Optional[FaultPolicy] = None, *,
                 directory: Optional[str] = None,
                 chaos: Optional[ChaosPlan] = None, sleep=time.sleep):
        policy = policy if policy is not None else FaultPolicy()
        if policy.checkpoint_every and directory is None:
            raise ValueError("checkpoint_every > 0 needs a checkpoint directory")
        self.server = server
        self.policy = policy
        self.directory = directory
        self.chaos = chaos
        self._sleep = sleep
        # the supervisor's own monotone segment index, seeded from the
        # server's counter: chaos schedules line up with segment numbers in
        # fresh runs AND stay stable across recovery (a restored server
        # resumes its counter from the checkpoint)
        self._seg_idx = server.segments_done
        self._front_sig: dict[int, tuple[str, int]] = {}  # job → (sig, stalls)
        self.recovered_step: Optional[int] = None
        self.stats = {"segments": 0, "retries": 0, "checkpoints": 0,
                      "quarantined": 0, "converged": 0}

    # -- construction --------------------------------------------------------

    @classmethod
    def for_problems(cls, problems, policy: Optional[FaultPolicy] = None,
                     *, directory: Optional[str] = None,
                     chaos: Optional[ChaosPlan] = None, sleep=time.sleep,
                     scheduler_policy: Optional[str] = None,
                     **server_kw) -> "Supervisor":
        """Build the server and its supervisor in one go
        (``SearchServer.for_problems``: the lanes live on the problems'
        device unless ``device=`` is given); the jobs keep their backends.

        ``policy`` here is the :class:`FaultPolicy`; the lane scheduler's
        admission policy (the server's ``policy`` keyword) rides as
        ``scheduler_policy``."""
        policy = policy if policy is not None else FaultPolicy()
        if scheduler_policy is not None:
            server_kw["policy"] = scheduler_policy
        server = SearchServer.for_problems(problems, **server_kw)
        return cls(server, policy, directory=directory, chaos=chaos, sleep=sleep)

    @classmethod
    def recover(cls, directory: str, spec, cfg,
                policy: Optional[FaultPolicy] = None, *,
                chaos: Optional[ChaosPlan] = None, sleep=time.sleep,
                device="cuda") -> "Supervisor":
        """Crash recovery: restore the newest checkpoint that passes FULL
        integrity verification (damaged steps are skipped back over) onto
        ``device`` and resume supervision from there.

        ``sup.recovered_step`` is the step restored; ``sup.dropped_pending``
        lists queued jobs the checkpoint could not serialize: resubmit them
        (a job's result does not depend on the segment that admits it).
        """
        step = ckpt.latest_valid_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}: "
                                    "nothing to recover from")
        server = SearchServer.restore(directory, spec, cfg, step=step, device=device)
        sup = cls(server, policy, directory=directory, chaos=chaos, sleep=sleep)
        sup.recovered_step = step
        return sup

    @property
    def dropped_pending(self) -> list[dict]:
        return self.server.dropped_pending

    # -- the supervised loop -------------------------------------------------

    def submit(self, job, **kw) -> int:
        return self.server.submit(job, **kw)

    def step(self) -> list[JobResult]:
        """One supervised segment: retry-guarded boundary, dispatch, lane
        validation and quarantine, convergence retirement, periodic
        checkpoint. Returns every job retired at this boundary (healthy,
        converged and quarantined alike: check ``JobResult.ok``)."""
        idx = self._seg_idx
        if self.chaos is not None:
            # injected faults fire BEFORE the dispatch, where a retry is sound
            self._attempt(lambda: self.chaos.on_segment(idx))
        results = self._dispatch(idx)
        self._seg_idx += 1
        self.stats["segments"] += 1
        if self.chaos is not None:
            self.chaos.poison_lane(idx, self.server)
        if self.policy.validate:
            results.extend(self._validate())
        if self.policy.patience:
            results.extend(self._retire_converged())
        self._maybe_checkpoint(idx)
        if self.chaos is not None:
            self.chaos.after_segment(idx)
        return results

    def drain(self) -> list[JobResult]:
        """Supervised :meth:`SearchServer.drain`."""
        results = []
        while self.server.has_work:
            results.extend(self.step())
        return results

    @property
    def segments_done(self) -> int:
        return self.server.segments_done

    # -- internals -----------------------------------------------------------

    def _dispatch(self, idx: int) -> list[JobResult]:
        timeout = self.policy.segment_timeout_s
        if timeout is None:
            return self.server.step()
        # grad mode and the current CUDA stream are per thread: the
        # watchdog's thread runs the segment under the caller's
        grad = torch.is_grad_enabled()
        dev = self.server.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        box: dict = {}

        def work():
            try:
                with torch.set_grad_enabled(grad), (
                        torch.cuda.stream(stream) if stream is not None
                        else contextlib.nullcontext()):
                    box["result"] = self.server.step()
            except BaseException as e:          # noqa: BLE001 — re-raised
                box["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            raise SegmentTimeoutError(
                f"segment {idx} exceeded the {timeout}s watchdog "
                "(dispatch hung; recover from the last checkpoint)")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _attempt(self, fn):
        """Run ``fn`` with capped-exponential-backoff retry on transient
        faults (IO errors, injected segment faults). Timeouts, kills and
        validation failures are fatal and propagate at once."""
        p = self.policy
        delay = p.backoff_base_s
        for attempt in range(p.max_retries + 1):
            try:
                return fn()
            except (OSError, SegmentFault):
                if attempt == p.max_retries:
                    raise
                self.stats["retries"] += 1
                self._sleep(min(delay, p.backoff_cap_s))
                delay *= 2

    def _validate(self) -> list[JobResult]:
        busy = self.server._sched.busy_lanes
        if not busy:
            return []
        # every lane in one pass, one host read
        flags = engine.validate_state(self.server._problems,
                                      self.server._states).cpu().numpy()
        out = []
        for lane in busy:
            bad = ~flags[lane]
            if not bad.any():
                continue
            failed = [n for n, b in zip(engine.VALIDATION_CHECKS, bad) if b]
            job_id = self.server._sched.lane_job[lane]
            msg = (f"lane {lane} failed validation at segment "
                   f"{self.server.segments_done}: {', '.join(failed)}")
            if not self.policy.quarantine:
                raise LaneValidationError(msg)
            out.append(self.server.quarantine_lane(lane, msg))
            self.stats["quarantined"] += 1
            self._front_sig.pop(job_id, None)
        return out

    def _retire_converged(self) -> list[JobResult]:
        out = []
        for lane in list(self.server._sched.busy_lanes):
            job_id = self.server._sched.lane_job[lane]
            sig = _front_fingerprint(self.server.lane_state(lane))
            prev = self._front_sig.get(job_id)
            stalls = prev[1] + 1 if prev is not None and prev[0] == sig else 0
            self._front_sig[job_id] = (sig, stalls)
            if stalls >= self.policy.patience:
                out.append(self.server.retire_lane(lane, converged=True))
                self.stats["converged"] += 1
                del self._front_sig[job_id]
        return out

    def _maybe_checkpoint(self, idx: int):
        p = self.policy
        if not p.checkpoint_every or (idx + 1) % p.checkpoint_every:
            return

        def save():
            if self.chaos is not None:
                self.chaos.on_save(idx)
            return self.server.save(self.directory, keep=p.keep, allow_pending=True)

        path = self._attempt(save)
        self.stats["checkpoints"] += 1
        if self.chaos is not None:
            # damage after the commit (bit rot) is NOT retried: the save
            # succeeded; recovery finds it through latest_valid_step
            self.chaos.after_save(path, self.server.segments_done)
