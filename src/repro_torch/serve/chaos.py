"""Deterministic fault injection for the supervised serve path, PyTorch
port of ``repro.serve.chaos``.

Every failure mode the :class:`~repro_torch.serve.supervisor.Supervisor`
claims to survive is injectable on a deterministic schedule, so a test
replays the exact same fault sequence every run. A :class:`ChaosPlan`
names faults by the supervisor's segment index at which they fire (NOT
``server.segments_done``: recovery restarts the server's counter from the
checkpoint, while the supervisor's own index keeps the schedule stable).
The faults:

  * ``segment_faults``     — a transient host fault raised *before* the
    segment dispatches (:class:`SegmentFault`), retried with backoff. Only
    faults before the dispatch are sound to retry: the segment writes the
    standing lane tensors, so a fault inside it leaves the carry half
    written, and the only sound recovery is a checkpoint restore.
  * ``io_errors``          — a transient :class:`ChaosIOError` from the
    auto-checkpoint save (retried with backoff).
  * ``poison``             — overwrite one leaf of one lane's state on its
    device at a segment boundary (NaN objectives, an out-of-bounds genome,
    or negative correct counts), so ``engine.validate_state`` trips and the
    lane is quarantined.
  * ``corrupt_steps``      — bit-flip or truncate a *committed* checkpoint's
    leaf file after the save returns (silent bit rot; deliberately NOT
    retried: recovery must skip back a step).
  * ``kill_after_segment`` — :class:`ChaosKill`, simulated process death
    after segment N; tests catch it, then run crash recovery.

Fire-once semantics: each scheduled fault fires exactly once, so the retry
that follows a transient fault succeeds. The schedules describe *fault
events*, not permanently broken hosts.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch


class SegmentFault(RuntimeError):
    """A transient host fault at a segment boundary (before the dispatch).
    The supervisor retries these with capped exponential backoff."""


class ChaosIOError(OSError):
    """A transient checkpoint-IO fault (a disk hiccup). Retried."""


class ChaosKill(RuntimeError):
    """Simulated process death: NOT retried; it propagates out of the
    supervisor so tests can exercise crash recovery with
    :meth:`Supervisor.recover`."""


# poison_leaf -> how a lane's state is damaged (each trips its own
# engine.VALIDATION_CHECKS flag)
POISON_LEAVES = ("obj", "pop", "counts")


def corrupt_checkpoint(directory: str, step: int, *, kind: str = "bitflip",
                       leaf: Optional[str] = None, seed: int = 0) -> str:
    """Damage one leaf file of a COMMITTED checkpoint in place.

    ``kind``: ``"bitflip"`` XORs one byte; ``"truncate"`` cuts the file to
    half its length. ``leaf``: manifest leaf name (default: the largest
    leaf). The byte is drawn from ``seed``, as the reference draws it, so
    both packages damage the same byte of the same file. Returns the
    damaged file's path.
    """
    d = os.path.join(directory, f"step_{step:08d}")
    names = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not names:
        raise FileNotFoundError(f"no leaf files under {d}")
    if leaf is not None:
        fn = os.path.join(d, leaf + ".npy")
    else:
        fn = max((os.path.join(d, n) for n in names), key=os.path.getsize)
    size = os.path.getsize(fn)
    rng = np.random.default_rng(seed)
    if kind == "bitflip":
        with open(fn, "r+b") as f:
            pos = int(rng.integers(0, size))
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
    elif kind == "truncate":
        with open(fn, "r+b") as f:
            f.truncate(max(1, size // 2))
    else:
        raise ValueError(f"unknown corruption kind {kind!r}: "
                         "want 'bitflip' or 'truncate'")
    return fn


@dataclasses.dataclass
class ChaosPlan:
    """A deterministic fault schedule, keyed by supervisor segment index.

    ``segment_faults``: segment indices at which a transient
    :class:`SegmentFault` fires before the dispatch.
    ``io_errors``: segment indices whose auto-checkpoint save raises a
    transient :class:`ChaosIOError` first.
    ``poison``: {segment index → lane}: after that segment, the lane's
    state leaf named by ``poison_leaf`` is overwritten with invalid data.
    ``poison_leaf``: ``"obj"`` (NaN objectives), ``"pop"`` (out-of-bounds
    genome) or ``"counts"`` (negative correct counts; every value of a
    (P, K) device-variation array).
    ``corrupt_steps``: checkpoint step numbers whose committed files get
    damaged (``corrupt_kind``: "bitflip"|"truncate") right after the save
    that wrote them returns.
    ``kill_after_segment``: raise :class:`ChaosKill` after this segment
    completes (after its checkpoint), simulating sudden process death.
    ``seed`` drives the corruption byte positions only; the *schedule* is
    explicit and exact.
    """
    segment_faults: tuple = ()
    io_errors: tuple = ()
    poison: dict = dataclasses.field(default_factory=dict)
    poison_leaf: str = "obj"
    corrupt_steps: tuple = ()
    corrupt_kind: str = "bitflip"
    kill_after_segment: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.poison_leaf not in POISON_LEAVES:
            raise ValueError(f"unknown poison_leaf {self.poison_leaf!r}: "
                             f"want one of {POISON_LEAVES}")
        self._fired: set = set()

    def _once(self, tag) -> bool:
        if tag in self._fired:
            return False
        self._fired.add(tag)
        return True

    # -- hooks the supervisor calls ----------------------------------------

    def on_segment(self, idx: int):
        """Before dispatching supervisor segment ``idx``."""
        if idx in self.segment_faults and self._once(("seg", idx)):
            raise SegmentFault(f"injected transient fault at segment {idx}")

    def on_save(self, idx: int):
        """Before the auto-checkpoint save at segment ``idx``."""
        if idx in self.io_errors and self._once(("io", idx)):
            raise ChaosIOError(f"injected checkpoint IO error at segment {idx}")

    def poison_lane(self, idx: int, server) -> Optional[int]:
        """After segment ``idx``: damage one lane's state in place on its
        device. Returns the poisoned lane (or None)."""
        lane = self.poison.get(idx)
        if lane is None or not self._once(("poison", idx)):
            return None
        from . import server as server_mod

        st = server.lane_state(lane)
        if self.poison_leaf == "obj":
            bad = dataclasses.replace(st, obj=torch.full_like(st.obj, float("nan")))
        elif self.poison_leaf == "pop":
            bad = dataclasses.replace(st, pop=st.pop + (1 << 20))
        else:                                        # "counts"
            bad = dataclasses.replace(st, counts=torch.full_like(st.counts, -1))
        server_mod._set_lane(server._states, lane, bad)
        return lane

    def after_save(self, path: str, step: int):
        """After a committed save: silent post-commit corruption."""
        if step in self.corrupt_steps and self._once(("corrupt", step)):
            corrupt_checkpoint(os.path.dirname(path), step, kind=self.corrupt_kind,
                               seed=self.seed + step)

    def after_segment(self, idx: int):
        """After segment ``idx`` fully completes (its checkpoint included)."""
        if (self.kill_after_segment is not None
                and idx >= self.kill_after_segment
                and self._once(("kill",))):
            raise ChaosKill(f"injected process kill after segment {idx}")
