"""Telemetry for the matfn serving stack: request-lifecycle tracing and
histogram metrics.

The paper's 1000x claim is a *measurement* story — knowing exactly where
time goes (host staging vs kernel vs transfer) is what
justified the heterogeneous split in the first place. The serving stack
has five dispatch route names, two admission lanes, per-route
execution streams, retries, and shedding, but until this module the only
window into it was aggregate counters: a slow p95 could not be attributed
to queueing vs assembly vs compile vs device time. This module is the
instrument; the serving layer threads it through every stage.

Two independent pieces, composable and individually cheap:

  * :class:`Tracer` — a span-based per-request/per-bucket trace recorder.
    Spans land in a bounded ring buffer (a long-lived daemon must never
    grow trace history without bound; overflow drops the OLDEST spans and
    counts the drops) and are exportable two ways: ``to_chrome()`` emits
    Chrome trace-event JSON (load it in Perfetto or ``chrome://tracing``
    — each execution stream renders as its own track), ``spans()`` returns
    plain dicts for tests and ad-hoc analysis. Timestamps come from an
    injectable ``clock`` callable, so a :class:`~repro_torch.serve.scheduler.
    ManualClock` daemon produces a fully deterministic timeline. A
    DISABLED tracer (the default, and :data:`NULL_TRACER`) short-circuits
    every record call on a single attribute check — tracing costs nothing
    until it is switched on.
  * :class:`Histogram` — fixed log-spaced buckets with exact counts:
    recording is O(1) (one ``log2`` + one index bump, no sample storage),
    merging is element-wise addition, and ``quantile(q)`` answers from the
    bucket boundaries with bounded relative error (``2**(1/8)`` growth ->
    every quantile is within ~9% of the exact order statistic; the
    telemetry suite holds this bound against a sorted-list reference).
    This replaces the engine's ad-hoc per-lane latency deques: a deque of
    raw samples forgets everything past its window, while a histogram is
    exact over the full run and mergeable across lanes/routes/tenants.
  * :class:`MetricsRegistry` — a labeled histogram store
    (``registry.histogram("latency", lane="bulk")``): get-or-create per
    (name, labels) key, thread-safe, snapshot-able. The serving engine
    keeps per-lane, per-route, per-stage, and (when callers name them)
    per-tenant views in one registry.

Span taxonomy, overhead notes, and the Perfetto how-to live in
the reference package's ``docs/observability.md``.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "Histogram", "MetricsRegistry", "Tracer", "NULL_TRACER",
    "DEFAULT_TRACE_CAPACITY", "SNAPSHOT_CHUNK", "SPAN_KINDS",
    "REQUEST_OUTCOMES",
]

#: Default ring-buffer bound for a Tracer (spans, not bytes). At ~7 spans
#: per bucket plus 1 per request, 65536 covers several thousand buckets —
#: hours of steady-state serving between exports.
DEFAULT_TRACE_CAPACITY = 65536

#: Spans copied per lock acquisition when exporting. A full-capacity ring
#: snapshotted in one pass holds the lock for ~65536 dict copies, stalling
#: every recording thread for the duration; chunking bounds each hold to
#: one slice and lets recorders interleave between chunks.
SNAPSHOT_CHUNK = 2048

#: The span/instant names the serving stack emits (the taxonomy tests and
#: docs/observability.md enumerate; user code may add its own).
SPAN_KINDS = (
    "request",           # complete per-request lifecycle: submit -> terminal
    "bucket.batch",      # bucket open (first member) -> scheduler dispatch
    "stream.queue",      # stream dispatch -> execution start (the gap)
    "bucket.assemble",   # operand stack + batch pad
    "bucket.execute",    # executable call (dispatch, or device-complete
                         # under profile=True)
    "bucket.resolve",    # row split + future resolution
    "scheduler.wait",    # scheduler sleep: deadline expiry vs wake
    "shed",              # instant: admission dropped a request
    "retry",             # instant: executor attempt failed, retrying
    "straggler",         # instant: watchdog tripped on a flush
    "compile",           # instant: executable-cache miss (jit build)
    "retune",            # instant: autotune cache generation bump
)

#: Terminal outcomes a ``request`` span can carry — every admitted request
#: ends in exactly one (the completeness invariant the suite asserts).
REQUEST_OUTCOMES = ("resolved", "shed", "error", "cancelled")


class Histogram:
    """Log-spaced-bucket histogram: exact counts, bounded-error quantiles.

    Buckets span ``[lo, hi)`` with ``2**(1/bits_per_octave)`` growth;
    values below ``lo`` land in a dedicated underflow bucket (reported as
    ``lo``), values at or above ``hi`` in an overflow bucket (reported as
    ``hi``). ``sum``/``min``/``max`` are tracked exactly, so means are
    exact even though quantiles are bucketed. Thread-safe: ``record`` is
    a lock-free index bump under the GIL (int ops on a list are atomic);
    ``merge``/``snapshot`` take a consistent copy.

    The defaults (1 us .. 1000 s, 8 buckets per octave) fit latency in
    SECONDS — ~240 buckets, <2 KiB per histogram, ~9% worst-case quantile
    error (``2**(1/8) - 1``).
    """

    __slots__ = ("lo", "hi", "_scale", "_nbuckets", "_counts",
                 "count", "sum", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 bits_per_octave: int = 8):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
        if bits_per_octave < 1:
            raise ValueError(
                f"bits_per_octave must be >= 1, got {bits_per_octave}")
        self.lo = float(lo)
        self.hi = float(hi)
        self._scale = float(bits_per_octave)          # buckets per doubling
        self._nbuckets = int(math.ceil(
            math.log2(hi / lo) * bits_per_octave)) + 2  # + under/overflow
        self._counts = [0] * self._nbuckets
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        if value >= self.hi:
            return self._nbuckets - 1
        return 1 + int(math.log2(value / self.lo) * self._scale)

    def _upper_bound(self, index: int) -> float:
        """Upper edge of bucket ``index`` (the quantile representative —
        a conservative bound: the true order statistic is <= it)."""
        if index <= 0:
            return self.lo
        if index >= self._nbuckets - 1:
            return self.hi
        return self.lo * 2.0 ** (index / self._scale)

    def record(self, value: float) -> None:
        """Count one observation (negatives clamp into the underflow
        bucket — a clock skew must not throw)."""
        v = float(value)
        self._counts[self._index(v) if v > 0 else 0] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """The smallest bucket bound covering fraction ``q`` of the
        observations (None when empty). Exact endpoints: ``q=0`` returns
        the tracked min, ``q=1`` the tracked max."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        if q == 0.0:
            return self.min
        if q == 1.0:
            return self.max
        # rank of the order statistic the reference implementation
        # (sorted[ceil(q*n) - 1]) would return
        rank = max(1, int(math.ceil(q * self.count)))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                # clamp into the exact envelope: bucket bounds can't beat
                # the tracked extremes
                return min(max(self._upper_bound(i), self.min), self.max)
        return self.max  # unreachable: counts sum to self.count

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def merge(self, other: "Histogram") -> "Histogram":
        """Element-wise accumulate ``other`` into self (same geometry
        required); returns self."""
        if (other.lo, other.hi, other._nbuckets) != (self.lo, self.hi,
                                                     self._nbuckets):
            raise ValueError("cannot merge histograms with different "
                             "bucket geometry")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for ext, pick in (("min", min), ("max", max)):
            theirs = getattr(other, ext)
            if theirs is not None:
                ours = getattr(self, ext)
                setattr(self, ext,
                        theirs if ours is None else pick(ours, theirs))
        return self

    def snapshot(self) -> dict:
        """Plain-dict summary (what ``stats()`` rows embed)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def __repr__(self):
        return (f"<Histogram n={self.count} mean={self.mean} "
                f"p95={self.quantile(0.95) if self.count else None}>")


class MetricsRegistry:
    """Labeled histogram store: ``histogram(name, **labels)`` get-or-creates
    one histogram per (name, sorted-labels) key.

    The serving engine keeps every latency/stage distribution here —
    per-lane (``latency, lane=bulk``), per-route (``execute, route=chain``),
    per-stage (``stage, stage=assemble``), and per-tenant when submits name
    one. Thread-safe; ``snapshot()`` returns plain dicts keyed by a stable
    ``name{label=value,...}`` string.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 bits_per_octave: int = 8):
        self._geometry = (lo, hi, bits_per_octave)
        self._lock = threading.Lock()
        self._hists: Dict[Tuple, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> Tuple:
        return (name,) + tuple(sorted(labels.items()))

    def histogram(self, name: str, **labels) -> Histogram:
        key = self._key(name, labels)
        hist = self._hists.get(key)
        if hist is None:
            with self._lock:
                hist = self._hists.get(key)
                if hist is None:
                    hist = Histogram(*self._geometry)
                    self._hists[key] = hist
        return hist

    def record(self, name: str, value: float, **labels) -> None:
        self.histogram(name, **labels).record(value)

    def get(self, name: str, **labels) -> Optional[Histogram]:
        """The histogram at (name, labels), or None if never recorded."""
        return self._hists.get(self._key(name, labels))

    def view(self, name: str) -> Dict[Tuple, Histogram]:
        """Every (labels-tuple -> histogram) recorded under ``name``."""
        with self._lock:
            return {k[1:]: h for k, h in self._hists.items()
                    if k[0] == name}

    def merged(self, name: str, **labels) -> Histogram:
        """One histogram accumulating the labeled views of ``name`` whose
        labels are a superset of ``labels`` (no filter merges ALL views —
        e.g. all-lane latency from the per-lane views; ``stage="execute"``
        merges that stage across every route/stream)."""
        want = set(labels.items())
        total = Histogram(*self._geometry)
        for lbls, hist in self.view(name).items():
            if want.issubset(set(lbls)):
                total.merge(hist)
        return total

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._hists.items())
        out = {}
        for key, hist in items:
            name, labels = key[0], key[1:]
            label_s = ",".join(f"{k}={v}" for k, v in labels)
            out[f"{name}{{{label_s}}}" if label_s else name] = \
                hist.snapshot()
        return out


class _NullSpan:
    """The disabled tracer's context manager: does nothing, costs one
    attribute load."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder with a bounded ring buffer and Chrome-trace export.

    ``enabled=False`` (the default construction path is
    :data:`NULL_TRACER`) makes every record call a single attribute check
    — instrumentation points in the serving stack guard on
    ``tracer.enabled`` before computing tags, so a disabled tracer is
    near-zero cost (the overhead smoke in tests/test_telemetry.py holds
    stats-equivalence with tracing off).

    ``clock`` is any zero-arg callable returning seconds; the engine binds
    its injectable scheduler clock so ManualClock daemon tests record
    deterministic timelines. All span times are in the clock's epoch.

    Thread-safety: spans append to a ``deque(maxlen=...)`` under a lock —
    overflow drops the oldest span while ``dropped`` counts the loss (a
    trace must say when it is partial). Export snapshots the ring in
    :data:`SNAPSHOT_CHUNK`-span slices, releasing the lock between chunks,
    so a full 65536-span export never stalls recording threads for the
    whole copy; spans evicted mid-export shift the cursor by the observed
    ``dropped`` delta, so the snapshot has no duplicates and no re-reads.
    """

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY, *,
                 clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._clock = clock
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    # -- clock -------------------------------------------------------------
    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Adopt a time source (the engine binds its scheduler clock's
        ``now`` at construction, so spans and deadlines share an epoch)."""
        self._clock = clock

    def now(self) -> float:
        if self._clock is not None:
            return self._clock()
        import time
        return time.perf_counter()

    # -- recording ---------------------------------------------------------
    def _append(self, rec: dict) -> None:
        """Append one record under the lock, counting ring overflow. The
        lock (rather than relying on the deque's atomic append) keeps the
        dropped count exact AND lets the chunked exporter iterate a stable
        ring slice — a concurrent ``deque.append`` during ``islice`` raises
        'deque mutated during iteration'."""
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(rec)

    def add_span(self, name: str, start: float, end: float, *,
                 track: str = "main", **tags) -> None:
        """Record one complete span with explicit clock times (the serving
        stack measures non-lexical stages — submit -> resolve crosses
        threads — so explicit times are the primitive; ``span()`` is the
        lexical sugar on top). ``track`` groups spans into Chrome-trace
        rows (one per execution stream / scheduler / submit side)."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "X", "ts": start,
                      "dur": max(end - start, 0.0), "track": track,
                      "args": tags})

    def instant(self, name: str, *, track: str = "main", at: Optional[float]
                = None, **tags) -> None:
        """Record a point event (shed / retry / straggler / compile /
        retune)."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "i",
                      "ts": self.now() if at is None else at,
                      "track": track, "args": tags})

    def counter(self, name: str, value: float, *, track: str = "main",
                at: Optional[float] = None, **tags) -> None:
        """Record a sampled gauge (queue depth per stream) — renders as a
        counter track in Perfetto."""
        if not self.enabled:
            return
        self._append({"name": name, "ph": "C",
                      "ts": self.now() if at is None else at,
                      "track": track,
                      "args": dict(tags, value=value)})

    class _Span:
        __slots__ = ("_tracer", "_name", "_track", "_tags", "_t0")

        def __init__(self, tracer, name, track, tags):
            self._tracer, self._name = tracer, name
            self._track, self._tags = track, tags

        def __enter__(self):
            self._t0 = self._tracer.now()
            return self

        def __exit__(self, *exc):
            self._tracer.add_span(self._name, self._t0, self._tracer.now(),
                                  track=self._track, **self._tags)
            return False

    def span(self, name: str, *, track: str = "main", **tags):
        """Lexical span context manager (disabled tracers return a shared
        no-op)."""
        if not self.enabled:
            return _NULL_SPAN
        return Tracer._Span(self, name, track, tags)

    # -- export ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by ring-buffer overflow since construction."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def _snapshot_spans(self, chunk: int = SNAPSHOT_CHUNK) -> List[dict]:
        """Copy the ring in ``chunk``-span slices, releasing the lock
        between slices so recording threads interleave with a large
        export. Records appended after a slice was copied are picked up by
        later slices; records evicted after copying stay in the snapshot
        (they were live at copy time). Between slices the cursor shifts
        left by the eviction count observed via ``_dropped``, so no span
        is copied twice and none still in the ring is skipped."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        out: List[dict] = []
        pos = 0
        last_dropped: Optional[int] = None
        while True:
            with self._lock:
                if last_dropped is not None:
                    # Evictions since the previous slice shifted every
                    # surviving span left by the same amount.
                    pos = max(pos - (self._dropped - last_dropped), 0)
                last_dropped = self._dropped
                sl = list(itertools.islice(self._spans, pos, pos + chunk))
            if not sl:
                return out
            out.extend(sl)
            pos += len(sl)

    def spans(self) -> List[dict]:
        """Plain-dict copies of the recorded spans, in record order (the
        test-facing form; times in clock seconds)."""
        return [dict(s, args=dict(s["args"]))
                for s in self._snapshot_spans()]

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
        — load the written file in Perfetto (ui.perfetto.dev) or
        chrome://tracing. Tracks map to thread ids; times convert from
        clock seconds to microseconds."""
        snapshot = self._snapshot_spans()
        tracks: Dict[str, int] = {}
        events = []
        for s in snapshot:
            track = s["track"]
            tid = tracks.setdefault(track, len(tracks) + 1)
            ev = {
                "name": s["name"],
                "ph": s["ph"],
                "ts": s["ts"] * 1e6,
                "pid": 1,
                "tid": tid,
                "cat": s["name"].split(".")[0],
                "args": {k: (v if isinstance(v, (int, float, str, bool,
                                                 type(None)))
                             else repr(v))
                         for k, v in s["args"].items()},
            }
            if s["ph"] == "X":
                ev["dur"] = s["dur"] * 1e6
            elif s["ph"] == "i":
                ev["s"] = "t"          # thread-scoped instant
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                 "args": {"name": track}}
                for track, tid in tracks.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self._dropped,
                              "recorded_spans": len(snapshot)}}

    def export(self, path) -> None:
        """Write ``to_chrome()`` as JSON to ``path``."""
        from pathlib import Path
        Path(path).write_text(json.dumps(self.to_chrome()))

    def __repr__(self):
        state = "on" if self.enabled else "off"
        return (f"<Tracer {state} spans={len(self._spans)}/{self.capacity} "
                f"dropped={self._dropped}>")


#: The shared disabled tracer: every record call returns on one attribute
#: check. Engines without ``trace=`` config use this — never mutate it.
NULL_TRACER = Tracer(capacity=1, enabled=False)
