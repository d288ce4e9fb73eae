"""Fault-tolerance runtime: step watchdog, retry, elastic re-mesh planning.

On a real pod, failures surface as (a) a hung step (network partition,
straggling host), (b) a raised exception (device loss), or (c) a dead
process (handled by checkpoint/restart). This module provides the
single-process-testable pieces of that story:

  * ``Watchdog``      — wall-clock timer around a step; trips a
                        ``StragglerEvent`` when a step exceeds
                        ``timeout_factor`` x the rolling median (classic
                        straggler detection).
  * ``retry_step``    — bounded-retry wrapper with backoff for transient
                        failures; re-raises on exhaustion so the launcher
                        falls back to checkpoint/restart.
  * ``plan_elastic_mesh`` — given surviving chip count and a TP
                        requirement, the largest (data x model) mesh that
                        preserves divisibility; paired with the
                        mesh-independent checkpoint layout this is the
                        elastic-restart path. It computes a mesh shape
                        only (pure arithmetic); the port has no sharded
                        route yet.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
import time
from typing import Callable, List, Optional

__all__ = ["StragglerEvent", "Watchdog", "retry_step", "plan_elastic_mesh"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float

    def __str__(self):
        return (f"straggler at step {self.step}: {self.duration_s:.2f}s vs "
                f"median {self.median_s:.2f}s")

    def as_tags(self) -> dict:
        """Plain-dict form for telemetry spans and ``stats()`` rows."""
        return {"step": self.step,
                "duration_s": round(self.duration_s, 6),
                "median_s": round(self.median_s, 6)}


class Watchdog:
    """Rolling-median step timer. ``observe`` returns a StragglerEvent when
    a step exceeds timeout_factor x median over the last ``window`` steps.

    Thread-safe: the matfn daemon's per-route execution streams observe
    CONCURRENTLY into one shared watchdog (one rolling median over all
    routes — a straggler is a straggler whichever stream ran it), so the
    window mutation and the median read run under a lock. Without it the
    append/pop(0) pair races against the ``statistics.median`` scan —
    interleaved observers can read a mid-mutation window (wrong median)
    or overshoot the window bound. The lock covers one median over <=
    ``window`` floats; retry BACKOFF, by contrast, sleeps on the failing
    stream's own worker thread (see :func:`retry_step`), so a retrying
    chain bucket never head-of-line stalls the torch stream's observations.
    """

    def __init__(self, *, timeout_factor: float = 3.0, window: int = 32,
                 min_samples: int = 5, max_events: int = 1024):
        self.timeout_factor = timeout_factor
        self.window = window
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._durations: List[float] = []
        # Ring buffer, not a list: a long-lived observer (the matfn daemon
        # watches every bucket flush) must not grow event history without
        # bound if a deployment straggles chronically.
        self.events: collections.deque = collections.deque(maxlen=max_events)

    def observe(self, step: int, duration_s: float) -> Optional[StragglerEvent]:
        ev = None
        with self._lock:
            if len(self._durations) >= self.min_samples:
                med = statistics.median(self._durations)
                if duration_s > self.timeout_factor * med:
                    ev = StragglerEvent(step, duration_s, med)
                    self.events.append(ev)
            self._durations.append(duration_s)
            if len(self._durations) > self.window:
                self._durations.pop(0)
        return ev

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """The collected straggler events as plain dicts (newest last),
        optionally capped to the most recent ``limit``.

        This is the exposure path for ``events``: the matfn engine embeds
        it in ``stats()`` and the ``matserve --daemon`` report prints it,
        so chronic stragglers are visible without reaching into the
        watchdog object. Taken under the lock for a consistent copy.
        """
        with self._lock:
            events = list(self.events)
        if limit is not None:
            events = events[-limit:]
        return [ev.as_tags() for ev in events]


def retry_step(fn: Callable, *args, retries: int = 2, backoff_s: float = 1.0,
               on_retry: Optional[Callable] = None, **kwargs):
    """Run ``fn``; on exception retry up to ``retries`` times with linear
    backoff. Transient accelerator faults (preempted collectives, link
    flaps) recover here; persistent ones re-raise to trigger restart."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:   # noqa: BLE001 — the policy IS catch-all
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * attempt)


def plan_elastic_mesh(n_healthy: int, *, tp: int = 16,
                      multi_pod_threshold: int = 512) -> tuple:
    """Largest (data, model) mesh using <= n_healthy chips with model == tp.

    Keeps TP intact (weights reshard over fewer data shards — cheap) and
    drops whole data rows, matching the checkpointer's mesh-independent
    layout. Returns (shape, axis_names).
    """
    if n_healthy < tp:
        # degrade TP by halving until it fits (weights reshard on restore)
        while tp > 1 and n_healthy < tp:
            tp //= 2
    data = max(1, n_healthy // tp)
    return (data, tp), ("data", "model")
