"""Per-route execution streams for the matfn daemon.

With one scheduler thread serializing every bucket through a single
dispatch queue, a big ``chain`` bucket blocks a due ``torch`` (or
priority-lane) flush at bucket granularity: latency preemption can only
reorder the queue, never overlap it. The paper's point is heterogeneous
overlap (many cheap execution contexts busy at once, not one fast queue).

This module is the execution side of that split:

  * :class:`ExecutionStreams` — the frozen config: how many executor
    workers (streams) the engine runs and which dispatch route each one
    serves. The default is one stream per route (``torch`` / ``chain`` /
    ``sharded`` / ``fastmm`` / ``evolve``); ``streams=1`` collapses every
    route onto a single worker, the serialized schedule (the
    stream-count-invariance property the test suite holds).
  * :class:`StreamPool` — the worker pool. The SCHEDULER thread keeps
    owning admission, bucketing, deadlines, and preemption; it hands each
    due bucket to its route's stream via :meth:`StreamPool.dispatch` and
    immediately returns to its poll loop. Streams execute concurrently,
    so an in-flight chain bucket no longer delays a due torch flush.

On a CUDA device each worker owns a ``torch.cuda.Stream`` and runs every
item under ``torch.cuda.stream(s)``, so the kernels of different routes
are queued on different device streams; on the CPU a worker's stream is
``None`` and items run as they are. Which tensors cross between the
caller's stream and a worker's, and how, is the engine's rule
(:mod:`repro_torch.serve.matfn`).

Scheduling properties the pool preserves:

  * **Latency priority per stream** — a dispatched latency-lane bucket is
    queued ahead of every not-yet-started bulk bucket on its stream: a
    latency flush waits for at most ONE in-progress execution on its own
    stream, and for nothing at all on the others.
  * **Ordering/bit-identity** — streams change the SCHEDULE, never the
    math: buckets execute the same ``_run_chunk`` core whatever stream
    runs them, results resolve per-future, and the engine's tests keep
    asserting bit-identical survivors for every stream count.
  * **Crash poisoning per stream** — a worker that dies on a
    non-``Exception`` escape (``Exception``\\ s are already routed into
    futures by the engine's bucket executor) marks ITS stream crashed,
    hands its queued-but-unstarted buckets back through ``on_crash`` for
    poisoning, and stops; the other streams keep serving. Dispatching to
    a crashed stream raises :class:`StreamCrashed` so the engine can fail
    just that bucket's futures.
  * **Free-stream wakes** — every bucket completion invokes ``on_free``
    OUTSIDE the pool lock; the engine uses it to notify its condition
    variable so ``settle()`` / ``close()`` drain-waits (see
    ``Clock.wait_for`` in :mod:`repro_torch.serve.scheduler`) observe "a
    stream just freed" as an event instead of polling.

The pool also runs plain callables (:meth:`StreamPool.call`) so
``MatFnEngine.warm`` can prepare each route's callables and build the
kernels ON its stream's thread and device stream.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

__all__ = ["DEFAULT_ROUTES", "ExecutionStreams", "StreamPool",
           "StreamCrashed"]

#: Dispatch routes the default stream layout covers, in stream order
#: (mirrors ``repro_torch.serve.matfn.ROUTES``; duplicated here because matfn
#: imports this module). ``evolve`` is the markov distribution-evolution
#: route — (B, n) vector-matrix chains, a different kernel shape from the
#: dense-square routes, so it gets its own stream by default too.
DEFAULT_ROUTES = ("torch", "chain", "sharded", "fastmm", "evolve")


class StreamCrashed(RuntimeError):
    """Raised by :meth:`StreamPool.dispatch` targeting a crashed stream.

    Carries the stream id and chains the worker's original failure as
    ``__cause__`` so the engine can fail the bucket's futures with an
    attributable error instead of silently re-routing.
    """

    def __init__(self, stream: int, cause: BaseException):
        super().__init__(f"execution stream {stream} crashed: "
                         f"{type(cause).__name__}: {cause}")
        self.stream = stream
        self.__cause__ = cause


@dataclasses.dataclass(frozen=True)
class ExecutionStreams:
    """How the engine's executor workers map onto dispatch routes.

    ``streams``  number of executor worker threads (>= 1). The default is
                 one per route; ``streams=1`` serializes every route
                 through a single worker (the serialized schedule), and counts
                 above ``len(routes)`` leave the extra workers idle.
    ``routes``   the route names, in stream-assignment order: route ``i``
                 runs on stream ``i % streams``. With the default five
                 and ``streams=2``, ``torch``, ``sharded``, and the cheap
                 markov ``evolve`` route share stream 0 while the two
                 heavy chain routes (``chain`` and ``fastmm``) share
                 stream 1.
    """

    streams: int = len(DEFAULT_ROUTES)
    routes: Tuple[str, ...] = DEFAULT_ROUTES

    def __post_init__(self):
        if not isinstance(self.streams, int) or isinstance(self.streams,
                                                           bool) \
                or self.streams < 1:
            raise ValueError(f"streams must be a positive int, "
                             f"got {self.streams!r}")
        routes = tuple(self.routes)
        if not routes or len(set(routes)) != len(routes):
            raise ValueError(f"routes must be a non-empty sequence of "
                             f"unique names, got {self.routes!r}")
        object.__setattr__(self, "routes", routes)

    def stream_for(self, route: str) -> int:
        """The stream id serving ``route``."""
        try:
            return self.routes.index(route) % self.streams
        except ValueError:
            raise ValueError(f"unknown route {route!r}; expected one of "
                             f"{self.routes}") from None

    def routes_for(self, stream: int) -> Tuple[str, ...]:
        """The routes stream ``stream`` serves (may be empty: extra
        streams beyond ``len(routes)`` idle)."""
        return tuple(r for i, r in enumerate(self.routes)
                     if i % self.streams == stream)

    def label(self, stream: int) -> str:
        served = ",".join(self.routes_for(stream)) or "idle"
        return f"stream-{stream}[{served}]"


@dataclasses.dataclass
class _Work:
    """One dispatched bucket awaiting (or under) execution.

    ``enqueued_at`` is stamped (pool clock) at dispatch so the worker can
    report the dispatch-to-start gap — the time a bucket sat queued
    behind earlier work on its stream, the queueing component of tail
    latency that stream counts exist to shrink.
    """
    bucket: object
    trigger: str
    priority: bool
    enqueued_at: float = 0.0


class _Job:
    """A plain callable dispatched to a stream (``StreamPool.call``):
    captures the return value or exception for the caller to collect."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._done = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._value = self._fn()
        except BaseException as exc:  # delivered to the caller, not the pool
            self._exc = exc
        finally:
            self._done.set()

    def fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"stream job not done after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value


class StreamPool:
    """Route-keyed executor workers behind the matfn scheduler.

    ``execute(bucket, trigger, stream_id)`` is the engine's bucket
    executor (it resolves futures itself and routes ``Exception``\\ s into
    them; anything that still escapes is a stream crash). ``on_free`` /
    ``on_crash`` are invoked OUTSIDE the pool lock — they may take the
    engine lock without deadlock (the lock order is always engine ->
    pool, never the reverse).
    """

    def __init__(self, config: ExecutionStreams,
                 execute: Callable, *,
                 on_free: Optional[Callable] = None,
                 on_crash: Optional[Callable] = None,
                 name: str = "matfn",
                 tracer=None, metrics=None,
                 now: Optional[Callable] = None,
                 device=None):
        self.config = config
        # The engine's device: on CUDA every worker makes its own
        # torch.cuda.Stream there (in the worker thread, at start).
        self.device = device
        self._execute = execute
        self._on_free = on_free
        self._on_crash = on_crash
        self._name = name
        # Telemetry (all optional; the engine passes its tracer/registry
        # and clock so stream timestamps share the request timeline).
        # ``stream.queue`` spans + queue-depth counters per worker, and
        # the dispatch-to-start gap feeds the "queue" stage histogram.
        if tracer is None:
            from repro_torch.runtime.telemetry import NULL_TRACER
            tracer = NULL_TRACER
        self._tracer = tracer
        self._metrics = metrics
        self._now = now if now is not None else time.monotonic
        self._cv = threading.Condition()
        n = config.streams
        self._queues: List[collections.deque] = [collections.deque()
                                                 for _ in range(n)]
        self._busy: List[Optional[_Work]] = [None] * n
        self._crashed: List[Optional[BaseException]] = [None] * n
        self._executed = [0] * n
        self._threads: List[threading.Thread] = []
        self._closing = False
        # Concurrency high-water mark: how many streams were EXECUTING at
        # once (the overlap the whole refactor exists to buy; the bench
        # records it and CI gates >= 2 on the multi-tenant trace).
        self._concurrent = 0
        self.peak_concurrent = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StreamPool":
        with self._cv:
            if self._threads:
                return self
            if self._closing:
                raise RuntimeError("stream pool is closed")
            for i in range(self.config.streams):
                t = threading.Thread(target=self._worker, args=(i,),
                                     name=f"{self._name}-{self.config.label(i)}",
                                     daemon=True)
                self._threads.append(t)
                t.start()
        return self

    def shutdown(self) -> None:
        """Stop intake and let every worker exit once its queue drains
        (dispatching after shutdown raises)."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join every worker; True when all exited within ``timeout``
        (the budget is shared across workers, not per worker)."""
        t_end = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            t.join(None if t_end is None
                   else max(t_end - time.monotonic(), 0.0))
        return not self.alive()

    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, route: str, bucket, trigger: str, *,
                 priority: bool = False) -> int:
        """Queue one bucket on ``route``'s stream; returns the stream id.

        ``priority=True`` (latency-lane buckets) inserts ahead of every
        queued non-priority bucket but behind earlier priority ones —
        FIFO within each class, preemption between them.
        """
        i = self.config.stream_for(route)
        work = _Work(bucket, trigger, priority, enqueued_at=self._now())
        with self._cv:
            if self._closing:
                raise RuntimeError("stream pool is closed")
            if self._crashed[i] is not None:
                raise StreamCrashed(i, self._crashed[i])
            q = self._queues[i]
            if priority:
                pos = 0
                for item in q:
                    if not (isinstance(item, _Work) and item.priority):
                        break
                    pos += 1
                q.insert(pos, work)
            else:
                q.append(work)
            self._cv.notify_all()
        return i

    def call(self, stream: int, fn: Callable) -> _Job:
        """Run a plain callable on one stream's thread (FIFO with the
        bucket queue); returns a handle whose ``result()`` blocks until
        the stream executed it. Used by ``warm()`` so each route's
        executables compile on (and for) their own stream."""
        if not 0 <= stream < self.config.streams:
            raise ValueError(f"no stream {stream}; pool has "
                             f"{self.config.streams}")
        job = _Job(fn)
        with self._cv:
            if self._closing:
                raise RuntimeError("stream pool is closed")
            if self._crashed[stream] is not None:
                raise StreamCrashed(stream, self._crashed[stream])
            self._queues[stream].append(job)
            self._cv.notify_all()
        return job

    def cancel_queued(self) -> List[tuple]:
        """Remove every queued-but-unstarted bucket from every stream;
        returns the removed ``(bucket, trigger)`` pairs so the caller can
        poison their futures (``close(drain=False)`` and the scheduler
        crash sweep). Queued plain jobs fail with ``RuntimeError``. Does
        not touch buckets already executing."""
        dropped, jobs = [], []
        with self._cv:
            for q in self._queues:
                for item in q:
                    if isinstance(item, _Work):
                        dropped.append((item.bucket, item.trigger))
                    else:
                        jobs.append(item)
                q.clear()
        for job in jobs:
            job.fail(RuntimeError("stream pool cancelled queued jobs"))
        return dropped

    # -- introspection -----------------------------------------------------
    def idle(self) -> bool:
        """True when no stream is executing and every queue is empty
        (crashed streams count as idle — their queues were drained into
        ``on_crash`` and nothing new can land on them)."""
        with self._cv:
            return all(b is None for b in self._busy) \
                and all(not q for q in self._queues)

    def snapshot(self) -> List[dict]:
        """Per-stream stats rows (one consistent point in time)."""
        rows = []
        with self._cv:
            for i in range(self.config.streams):
                crash = self._crashed[i]
                rows.append({
                    "stream": i,
                    "label": self.config.label(i),
                    "routes": list(self.config.routes_for(i)),
                    "executed": self._executed[i],
                    "queued": len(self._queues[i]),
                    "busy": self._busy[i] is not None,
                    "crashed": None if crash is None
                    else f"{type(crash).__name__}: {crash}",
                })
        return rows

    # -- worker ------------------------------------------------------------
    def _device_stream(self):
        """This worker's device stream: a new ``torch.cuda.Stream`` on a
        CUDA engine device, else None."""
        if self.device is None or torch.device(self.device).type != "cuda":
            return None
        return torch.cuda.Stream(device=self.device)

    def _worker(self, i: int) -> None:
        stream = self._device_stream()
        if stream is None:
            return self._serve(i)
        with torch.cuda.stream(stream):
            return self._serve(i)

    def _serve(self, i: int) -> None:
        while True:
            with self._cv:
                while not self._queues[i] and not self._closing:
                    self._cv.wait()
                if not self._queues[i]:
                    return                    # closing and drained
                item = self._queues[i].popleft()
                self._busy[i] = item if isinstance(item, _Work) else None
                qlen = len(self._queues[i])
                if isinstance(item, _Work):
                    self._concurrent += 1
                    self.peak_concurrent = max(self.peak_concurrent,
                                               self._concurrent)
            if isinstance(item, _Job):
                item.run()                    # captures its own exceptions
                if self._on_free is not None:
                    self._on_free(i)
                continue
            if self._metrics is not None or self._tracer.enabled:
                started = self._now()
                gap = max(started - item.enqueued_at, 0.0)
                if self._metrics is not None:
                    self._metrics.record("stage", gap, stage="queue",
                                         stream=str(i))
                if self._tracer.enabled:
                    track = f"stream-{i}"
                    bucket = item.bucket
                    self._tracer.add_span(
                        "stream.queue", item.enqueued_at, started,
                        track=track, trigger=item.trigger,
                        priority=item.priority,
                        key=str(getattr(bucket, "key", None)),
                        lane=getattr(bucket, "lane", None))
                    self._tracer.counter("stream.queue_depth", qlen,
                                         at=started, track=track)
            try:
                self._execute(item.bucket, item.trigger, i)
            except BaseException as exc:
                # Crash poisoning is PER STREAM: this stream stops, its
                # queued buckets are handed back for poisoning, and the
                # other streams keep serving. The engine's executor
                # already routes Exceptions into futures, so only
                # should-never-happen escapes land here.
                with self._cv:
                    self._busy[i] = None
                    self._concurrent -= 1
                    self._crashed[i] = exc
                    failed = [(item.bucket, item.trigger)]
                    jobs = []
                    for q_item in self._queues[i]:
                        if isinstance(q_item, _Work):
                            failed.append((q_item.bucket, q_item.trigger))
                        else:
                            jobs.append(q_item)
                    self._queues[i].clear()
                    self._cv.notify_all()
                for job in jobs:
                    job.fail(StreamCrashed(i, exc))
                if self._on_crash is not None:
                    self._on_crash(i, failed, exc)
                if self._on_free is not None:
                    self._on_free(i)
                return
            with self._cv:
                self._busy[i] = None
                self._concurrent -= 1
                self._executed[i] += 1
                self._cv.notify_all()
            if self._on_free is not None:
                self._on_free(i)
