"""Flush policies and clocks for the continuous-batching matfn daemon.

The daemon (:class:`repro_torch.serve.matfn.MatFnEngine` in started mode) holds
one open bucket per ``(op, n, dtype, power)`` traffic class and must decide
*when* each bucket stops waiting for more requests and executes. That
decision is a pluggable strategy so deployments can trade latency against
batch occupancy without touching the engine:

  * :class:`FillOrDeadline` — flush when the bucket reaches ``max_batch``
    members OR when its oldest request has waited ``max_delay_s`` (the
    classic continuous-batching rule; the per-bucket delay comes from the
    tuning cache's ``dispatch`` namespace, see
    ``autotune.bucket_deadline_ms``).
  * :class:`AdaptiveDeadline` — same fill rule, but the deadline shrinks
    with the measured arrival rate: when requests arrive fast enough to
    plausibly fill the bucket soon, waiting the full tuned delay only adds
    latency; when traffic is sparse, waiting longer than the expected fill
    time is pointless, so the delay clamps to the tuned maximum.

Both consult time through a :class:`Clock` so the engine's deadline
behavior is testable without sleeps: :class:`SystemClock` is the real
monotonic clock, :class:`ManualClock` only moves when a test calls
``advance`` (which also wakes the scheduler), making "the deadline passed"
a deterministic event instead of a race against the wall clock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

__all__ = [
    "BucketView", "FlushPolicy", "FillOrDeadline", "AdaptiveDeadline",
    "Clock", "SystemClock", "ManualClock",
]


@dataclasses.dataclass(frozen=True)
class BucketView:
    """Read-only snapshot of one open bucket, as policies see it.

    ``first_ts`` is the clock time the bucket's OLDEST pending request
    arrived (the latency-critical member); ``max_delay_s`` is the tuned
    flush-by delay for this traffic class (engine override or the
    ``dispatch`` namespace's deadline entry, capped by the lane's SLO
    target for latency-lane buckets); ``lane`` is the admission class the
    bucket serves (``"bulk"`` / ``"latency"`` — defaulted so pre-admission
    policy tests and user policies keep constructing 4-field views).
    """
    key: tuple
    size: int
    first_ts: float
    max_delay_s: float
    lane: str = "bulk"


class FlushPolicy:
    """When does a pending bucket flush?

    The engine calls ``observe`` under its lock on every submit (stateful
    policies track arrivals there), ``due`` when deciding what to flush
    now, and ``deadline`` to compute how long the scheduler may sleep
    before *some* bucket needs service. ``deadline`` must be consistent
    with ``due``: a bucket is due once ``now >= deadline(view)`` (or it
    filled), otherwise the scheduler could sleep past a flush or spin.

    ``wake_on_observe`` declares whether ``observe`` can move an EXISTING
    bucket's deadline: when False (stateless policies — a bucket's
    deadline is fixed at its first arrival), the engine skips the
    scheduler wakeup on submits that neither open nor fill a bucket,
    which is most of them under load (measured ~6x cheaper per submit —
    the difference between the front door keeping up with an open-loop
    generator and the generator convoying on the scheduler). Adaptive
    policies set it True and keep the wake-on-every-submit behavior.
    """

    wake_on_observe = False

    def observe(self, view: BucketView, now: float) -> None:
        """One request just joined ``view``'s bucket (stateless: ignore)."""

    def deadline(self, view: BucketView, max_batch: int) -> float:
        """Absolute clock time by which this bucket must flush."""
        raise NotImplementedError

    def due(self, view: BucketView, now: float, max_batch: int) -> bool:
        """Flush now? Full buckets are always due; otherwise the deadline
        decides."""
        return view.size >= max_batch or now >= self.deadline(view, max_batch)


class FillOrDeadline(FlushPolicy):
    """Flush on fill OR when the oldest request has waited its tuned delay.

    The deadline is anchored to the bucket's first arrival, so one slow
    trickle of requests cannot starve the oldest member: it waits at most
    ``max_delay_s`` regardless of how many stragglers join behind it.
    """

    def deadline(self, view: BucketView, max_batch: int) -> float:
        return view.first_ts + view.max_delay_s


class AdaptiveDeadline(FlushPolicy):
    """Fill-or-deadline with the delay adapted to the recent arrival rate.

    Tracks an EWMA of the inter-arrival gap across all submits (one stream
    per engine — serving traffic is interleaved anyway). The effective
    delay for a bucket is the expected time to FILL it from empty
    (``gap * max_batch``), clamped to ``[min_delay_s, view.max_delay_s]``:

      * hot traffic (small gap): the bucket will fill almost immediately,
        so the deadline collapses toward ``min_delay_s`` and latency stays
        near the batch-formation floor instead of the tuned maximum;
      * sparse traffic (large gap): the bucket would never fill, so there
        is no point waiting — the delay clamps at the tuned maximum and
        requests leave after ``max_delay_s`` like the static policy.

    Until two arrivals have been seen there is no gap estimate and the
    policy behaves exactly like :class:`FillOrDeadline`.
    """

    # Every arrival can shrink every deadline, so the scheduler must be
    # woken to re-evaluate its sleep (see FlushPolicy.wake_on_observe).
    wake_on_observe = True

    def __init__(self, min_delay_s: float = 1e-4, smoothing: float = 0.25):
        if not (0.0 < smoothing <= 1.0):
            raise ValueError(f"smoothing must be in (0, 1], got {smoothing}")
        if min_delay_s <= 0.0:
            raise ValueError(f"min_delay_s must be > 0, got {min_delay_s}")
        self.min_delay_s = float(min_delay_s)
        self.smoothing = float(smoothing)
        self._gap: Optional[float] = None
        self._last: Optional[float] = None

    def observe(self, view: BucketView, now: float) -> None:
        if self._last is not None:
            gap = max(now - self._last, 0.0)
            self._gap = gap if self._gap is None else \
                (1.0 - self.smoothing) * self._gap + self.smoothing * gap
        self._last = now

    def effective_delay(self, view: BucketView, max_batch: int) -> float:
        if self._gap is None:
            return view.max_delay_s
        return min(view.max_delay_s,
                   max(self.min_delay_s, self._gap * max_batch))

    def deadline(self, view: BucketView, max_batch: int) -> float:
        return view.first_ts + self.effective_delay(view, max_batch)


class Clock:
    """Time source + scheduler sleep, injectable for deterministic tests.

    ``wait`` is always called with ``cv`` held and must release it while
    blocking (condition-variable semantics); it may return spuriously —
    the scheduler recomputes due-ness on every wakeup.
    """

    def now(self) -> float:
        raise NotImplementedError

    def wait(self, cv: threading.Condition, timeout: Optional[float]) -> None:
        raise NotImplementedError

    def traced_wait(self, cv: threading.Condition, timeout: Optional[float],
                    tracer) -> None:
        """``wait`` wrapped in a ``scheduler.wait`` telemetry span.

        The span's ``kind`` tag answers the question a latency
        investigation always asks of the scheduler: did it sleep out the
        full bucket deadline (``deadline`` — the wait ended because time
        ran out) or was it woken early by a submit/kick/close
        (``wake``)? ``idle`` marks the no-open-buckets sleep (no timeout
        at all). With a disabled tracer this is exactly ``wait`` — one
        attribute check of overhead. ``tracer`` is any object with the
        :class:`repro_torch.runtime.telemetry.Tracer` recording surface.
        """
        if not tracer.enabled:
            self.wait(cv, timeout)
            return
        t0 = self.now()
        self.wait(cv, timeout)
        t1 = self.now()
        if timeout is None:
            kind = "idle"
        elif t1 - t0 >= timeout:
            kind = "deadline"
        else:
            kind = "wake"
        tracer.add_span("scheduler.wait", t0, t1, track="scheduler",
                        kind=kind, timeout_s=timeout)

    def wait_for(self, cv: threading.Condition, predicate,
                 poll: float = 0.05) -> None:
        """Block (``cv`` held) until ``predicate()`` is true.

        The stream-free wake path: execution streams notify the engine's
        condition when a worker finishes a bucket, and the scheduler's
        drain wait (``close(drain=True)`` must not report a completed
        drain while a stream still holds buckets) plus ``settle()`` sleep
        here until streams go idle. The wake SEMANTICS are
        clock-dependent, which is why this lives on the clock:
        ``SystemClock`` slices the wait by ``poll`` so a worker that dies
        without its final notify cannot hang the scheduler forever, while
        ``ManualClock`` ignores ``poll`` entirely (its ``wait`` blocks
        until a notify) — "a stream freed" is then a deterministic event
        in zero-sleep tests, exactly like "the deadline passed".
        """
        while not predicate():
            self.wait(cv, poll)

    def bind(self, cv: threading.Condition) -> None:
        """Register a scheduler's condition (manual clocks wake it on
        ``advance``); the default is a no-op."""


class SystemClock(Clock):
    """The real monotonic clock; ``wait`` is a plain timed cv wait."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cv: threading.Condition, timeout: Optional[float]) -> None:
        cv.wait(timeout)


class ManualClock(Clock):
    """Deterministic test clock: time moves ONLY via ``advance``.

    ``wait`` ignores the requested timeout entirely and blocks until
    something notifies the scheduler (a submit, a close, or ``advance``) —
    so a deadline can never expire behind a test's back, and "not flushed
    before the deadline" is an exact assertion rather than a race.
    ``advance`` moves time and then wakes every bound scheduler so it
    re-evaluates its buckets against the new now.
    """

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._now = float(start)
        self._cvs: List[threading.Condition] = []

    def now(self) -> float:
        with self._lock:
            return self._now

    def wait(self, cv: threading.Condition, timeout: Optional[float]) -> None:
        del timeout  # deadlines fire on advance(), never on wall time
        cv.wait()

    def bind(self, cv: threading.Condition) -> None:
        with self._lock:
            if cv not in self._cvs:
                self._cvs.append(cv)

    def advance(self, dt: float) -> float:
        """Move time forward and wake every bound scheduler; returns now."""
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        with self._lock:
            self._now += float(dt)
            now, cvs = self._now, list(self._cvs)
        for cv in cvs:
            with cv:
                cv.notify_all()
        return now
