"""Host-side lane admission/retirement bookkeeping, a copy of
``repro.serve.scheduler`` (plain Python, the same decisions and messages).

Between segments: which job occupies which lane, which jobs wait, and
which pending jobs enter freed lanes next. Free of device state:
``SearchServer`` owns the lane tensors and asks the scheduler only for
decisions, so the policies are testable alone.
"""
from __future__ import annotations


class LaneScheduler:
    """Fixed-lane admission queue.

    Policies (``admissions`` order over pending jobs):
      "fifo"     — submission order (the default).
      "longest"  — largest generation budget first (LJF): long jobs start
                   as early as possible, short jobs backfill freed lanes,
                   minimizing the makespan tail where one long job keeps
                   the whole batch alive. The right default for
                   heterogeneous budget streams.
      "shortest" — smallest budget first (latency over makespan).
    Ties (and "fifo") preserve submission order.
    """

    POLICIES = ("fifo", "longest", "shortest")

    def __init__(self, n_lanes: int, policy: str = "fifo"):
        if n_lanes < 1:
            raise ValueError(f"need at least one lane, got {n_lanes}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; want "
                             f"{self.POLICIES}")
        self.n_lanes = n_lanes
        self.policy = policy
        self.lane_job: list[int | None] = [None] * n_lanes
        self.pending: list[int] = []     # job ids in submission order

    def enqueue(self, job_id: int):
        self.pending.append(job_id)

    def occupy(self, lane: int, job_id: int):
        if self.lane_job[lane] is not None:
            raise ValueError(f"lane {lane} already runs job "
                             f"{self.lane_job[lane]}")
        self.lane_job[lane] = job_id

    def free(self, lane: int):
        self.lane_job[lane] = None

    def admissions(self, budgets: dict) -> list[tuple[int, int]]:
        """Assign pending jobs to free lanes; returns [(lane, job_id)].

        ``budgets``: job id → generation budget (consulted by the
        non-FIFO policies). Chosen jobs leave ``pending`` and occupy
        their lanes immediately.
        """
        free = [i for i, j in enumerate(self.lane_job) if j is None]
        if not free or not self.pending:
            return []
        order = list(self.pending)
        if self.policy == "longest":
            order.sort(key=lambda j: -budgets[j])    # stable: FIFO ties
        elif self.policy == "shortest":
            order.sort(key=lambda j: budgets[j])
        picked = order[: len(free)]
        out = []
        for lane, job_id in zip(free, picked):
            self.occupy(lane, job_id)
            self.pending.remove(job_id)
            out.append((lane, job_id))
        return out

    @property
    def busy_lanes(self) -> list[int]:
        return [i for i, j in enumerate(self.lane_job) if j is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.busy_lanes)
