"""Admission control for the matfn daemon: bounded queues, shed policies,
priority lanes.

The continuous-batching daemon is fast when healthy but queues without
limit when offered load exceeds capacity: ``_pending`` members accumulate
in open buckets, every deadline is eventually missed, and the first
visible symptom is timeouts everywhere at once. The paper pitches matrix
exponentiation for "highly critical flight, CAD simulations to financial,
statistical applications" — serving layers for those workloads must
degrade *predictably*: fail SOME requests fast (typed, attributable,
counted) so the rest keep their latency.

This module is the front door's policy vocabulary; the enforcement lives
in :meth:`repro_torch.serve.matfn.MatFnEngine._submit_daemon`:

  * **Lanes** are the admission-control traffic classes. Every request
    rides one of two: ``"bulk"`` (the default — throughput traffic that
    batches up to the tuned deadline) or ``"latency"``
    (``submit(..., priority="latency")`` — latency-critical traffic with
    its own, tighter SLO). Each lane has its own bounded queue, shed
    counters, and p95 in ``engine.stats()``.
  * **Capacity** bounds the number of ADMITTED-but-unflushed requests per
    lane (members of open buckets; in-flight buckets no longer count —
    they are the device's problem, not the queue's). ``None`` means
    unbounded, the pre-admission behavior.
  * **Policies** decide WHO pays on overflow:

      - :class:`RejectNewest` — shed the incoming request:
        ``submit()`` raises :class:`ShedError` immediately. Admitted
        work is never revoked; queue latency is FIFO-predictable. The
        default.
      - :class:`RejectOldest` — shed the longest-waiting admitted
        request (its future resolves with :class:`ShedError`) and admit
        the newcomer: freshest-data semantics for workloads where a
        stale answer is worthless (monitoring, pricing ticks).
      - :class:`DeadlineAware` — shed whichever pending request (the
        incoming one included) has the least SLO slack — the request
        most likely to be a dead-on-arrival answer anyway. With
        per-(op, n, dtype) tuned deadlines this differs from
        reject-oldest: a young request in a 2 ms class can be closer to
        its deadline than an old one in a 50 ms class.

  * **SLO targets** per lane (``slo_ms``) cap the lane's bucket flush
    deadline: a latency-lane bucket never waits longer than its SLO
    budget, and the cap feeds straight into
    :class:`~repro_torch.serve.scheduler.AdaptiveDeadline` (which only ever
    SHRINKS the wait below it). ``None`` defers to the tuned
    per-(op, n, dtype) ``dispatch`` deadline, like bulk traffic.
  * **Bypass** (``bypass_n``): latency-lane requests at ``n >= bypass_n``
    skip bucket assembly entirely — their bucket is marked due the moment
    they arrive (the ``"priority"`` flush trigger) and the scheduler
    executes latency-lane buckets before bulk ones. Above the threshold
    the matrix's own execution time dominates any batching win, so
    waiting for peers only adds latency.

Shed decisions are made under the engine lock in O(pending-per-lane) and
never touch the device: a shed request costs a counter bump and one
exception, which is the point — overload must not be allowed to spend
compute on work it is about to discard.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

__all__ = [
    "LANES", "DEFAULT_BYPASS_N", "DEFAULT_SLO_MS",
    "ShedError", "PendingView",
    "AdmissionPolicy", "RejectNewest", "RejectOldest", "DeadlineAware",
    "POLICIES", "AdmissionControl",
]

#: Admission-control traffic classes, in scheduling-priority order: the
#: scheduler flushes due ``latency`` buckets before due ``bulk`` ones.
LANES = ("latency", "bulk")

#: Latency-lane requests at n >= this skip bucket assembly (flush
#: immediately on the dedicated priority path).
DEFAULT_BYPASS_N = 64

#: Per-lane SLO target (ms) capping the lane's bucket flush deadline;
#: None defers to the tuned per-(op, n, dtype) ``dispatch`` deadline.
DEFAULT_SLO_MS: Mapping[str, Optional[float]] = {
    "latency": 0.5, "bulk": None,
}


class ShedError(RuntimeError):
    """A request was shed by admission control instead of queued.

    Raised from ``submit()`` (reject-newest: the INCOMING request pays)
    or resolved into an already-admitted future (reject-oldest /
    deadline-aware: a queued request pays so the newcomer fits). Carries
    everything a client needs to react — back off, reroute, or drop —
    without string-parsing:

    ``lane``         the admission class that overflowed,
    ``queue_depth``  admitted-but-unflushed requests in that lane at the
                     shed decision,
    ``capacity``     the lane's configured bound,
    ``policy``       the deciding policy's name, and
    ``key``          the shed request's (op, n, dtype, power) bucket key.
    """

    def __init__(self, lane: str, queue_depth: int, capacity: int,
                 policy: str, key: Optional[tuple] = None):
        super().__init__(
            f"request shed by admission control: lane={lane!r} at "
            f"depth {queue_depth}/{capacity} (policy={policy}"
            f"{f', key={key}' if key is not None else ''})")
        self.lane = lane
        self.queue_depth = queue_depth
        self.capacity = capacity
        self.policy = policy
        self.key = key

    def as_tags(self) -> dict:
        """Plain-dict form for telemetry shed events (tuple keys stringify
        — Chrome trace args must stay JSON-scalar)."""
        return {"lane": self.lane, "queue_depth": self.queue_depth,
                "capacity": self.capacity, "policy": self.policy,
                "key": None if self.key is None else str(self.key)}


@dataclasses.dataclass(frozen=True)
class PendingView:
    """One pending request as admission policies see it: which bucket
    class it belongs to, when it arrived, and the absolute clock time by
    which its bucket must flush (arrival + the bucket's effective
    delay)."""
    key: tuple
    lane: str
    arrival_ts: float
    deadline_ts: float


class AdmissionPolicy:
    """Who pays when a lane's queue is full?

    ``select_victim`` is called under the engine lock with the lane's
    pending requests (bucket-iteration order) and the incoming request's
    view; it returns an index into ``pending`` to shed that admitted
    request (its future resolves with :class:`ShedError`), or ``None``
    to shed the INCOMING request (``submit()`` raises). It must not
    block, sleep, or touch the engine.
    """

    name = "admission"

    def select_victim(self, pending: Sequence[PendingView],
                      incoming: PendingView,
                      now: float) -> Optional[int]:
        raise NotImplementedError


class RejectNewest(AdmissionPolicy):
    """Shed the incoming request: admitted work is never revoked, so
    queue latency stays FIFO-predictable and a client sees its rejection
    synchronously at ``submit()``. The default."""

    name = "reject-newest"

    def select_victim(self, pending, incoming, now):
        return None


class RejectOldest(AdmissionPolicy):
    """Shed the longest-waiting admitted request and take the newcomer:
    freshest-data semantics for traffic where a stale answer is worth
    less than a recent one."""

    name = "reject-oldest"

    def select_victim(self, pending, incoming, now):
        return min(range(len(pending)),
                   key=lambda i: pending[i].arrival_ts)

class DeadlineAware(AdmissionPolicy):
    """Shed whichever pending request — the incoming one included — has
    the least SLO slack (earliest absolute flush deadline): the request
    most likely to produce a dead-on-arrival answer anyway. Differs from
    reject-oldest whenever traffic classes carry different tuned
    deadlines."""

    name = "deadline-aware"

    def select_victim(self, pending, incoming, now):
        cands = list(pending) + [incoming]
        j = min(range(len(cands)), key=lambda i: cands[i].deadline_ts)
        return None if j == len(pending) else j


#: Policy registry for CLIs/config files.
POLICIES = {p.name: p for p in (RejectNewest, RejectOldest, DeadlineAware)}


@dataclasses.dataclass(frozen=True)
class AdmissionControl:
    """The matfn daemon's front-door configuration.

    ``capacity``  per-lane bound on admitted-but-unflushed requests
                  (None = unbounded; the default for both lanes, which
                  reproduces the pre-admission daemon exactly).
    ``policy``    the :class:`AdmissionPolicy` deciding who is shed on
                  overflow (default :class:`RejectNewest`).
    ``slo_ms``    per-lane SLO target capping the lane's bucket flush
                  deadline (None defers to the tuned class deadline).
    ``bypass_n``  latency-lane requests at n >= this skip bucket
                  assembly and flush immediately (``"priority"``
                  trigger).
    ``bypass_direct``  when True (default) a priority-bypass bucket is
                  handed straight to its route's execution stream at
                  submit — it never waits for a scheduler poll, and a
                  scheduler busy dispatching bulk backlog cannot delay
                  it. False takes the scheduler path (the bucket is only
                  MARKED due; the next scheduler poll dispatches it) for
                  deployments that want every dispatch decision on the
                  scheduler thread.
    """

    capacity: Mapping[str, Optional[int]] = dataclasses.field(
        default_factory=lambda: {lane: None for lane in LANES})
    policy: AdmissionPolicy = dataclasses.field(default_factory=RejectNewest)
    slo_ms: Mapping[str, Optional[float]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLO_MS))
    bypass_n: int = DEFAULT_BYPASS_N
    bypass_direct: bool = True

    def __post_init__(self):
        for mapping, what in ((self.capacity, "capacity"),
                              (self.slo_ms, "slo_ms")):
            for lane in mapping:
                if lane not in LANES:
                    raise ValueError(f"unknown {what} lane {lane!r}; "
                                     f"expected one of {LANES}")
        for lane, cap in self.capacity.items():
            if cap is not None and (not isinstance(cap, int) or cap < 1):
                raise ValueError(
                    f"capacity[{lane!r}] must be a positive int or None, "
                    f"got {cap!r}")
        for lane, slo in self.slo_ms.items():
            if slo is not None and not slo > 0:
                raise ValueError(
                    f"slo_ms[{lane!r}] must be > 0 or None, got {slo!r}")
        if not isinstance(self.bypass_n, int) or self.bypass_n < 1:
            raise ValueError(f"bypass_n must be a positive int, "
                             f"got {self.bypass_n!r}")
        if not isinstance(self.bypass_direct, bool):
            raise TypeError(f"bypass_direct must be a bool, "
                            f"got {self.bypass_direct!r}")
        if not isinstance(self.policy, AdmissionPolicy):
            raise TypeError(f"policy must be an AdmissionPolicy, "
                            f"got {type(self.policy).__name__}")

    def capacity_for(self, lane: str) -> Optional[int]:
        return self.capacity.get(lane)

    def slo_s_for(self, lane: str) -> Optional[float]:
        ms = self.slo_ms.get(lane)
        return None if ms is None else ms / 1e3
