"""Matrix-function serving engine: request bucketing, batched squaring
chains, heterogeneous dispatch, and a continuous-batching daemon.

The port of the reference's ``repro/serve/matfn.py``. The paper's headline
pipeline keeps the accelerator saturated across matrices "of different
sizes and with different powers". This module is that pipeline as a
service layer over the port's chain executors:

  * **Requests** (:class:`MatFnRequest`) name an op (``matpow`` / ``expm``;
    ``markov`` is named and refused, see below), an (n, n) operand, and —
    for matpow — a static power.
  * **Bucketing**: pending requests group by ``(op, n, dtype, power)``; each
    group is stacked into a (B, n, n) operand whose batch dim is padded up
    to the next power of two (zero matrices in the filler slots), so a
    handful of prepared callables serves every batch size.
  * **Callable cache**: each bucket answers from a prepared callable keyed
    on ``(op, route, padded_batch, n, dtype, power)`` — where the reference
    caches one jitted program per bucket shape, the port caches the bound
    entry point (``batched_matpow`` / a per-member ``expm`` loop) with its
    route, and the ``compiles`` / ``cache_hits`` counters keep their
    meaning (one build per key, counted exactly under concurrent streams).
  * **Heterogeneous dispatch**: the route per bucket follows the tuning
    cache's ``dispatch`` namespace (:func:`repro_torch.kernels.autotune.
    dispatch_thresholds`): tiny n takes the ``"torch"`` route
    (``torch.matmul``, cuBLAS on the card: launch overhead dominates), the
    rest the ``"chain"`` route, the stacked chain of the hand-written
    kernels (:class:`repro_torch.core.batched.BatchedMatmulChain`: K1–K3,
    the stack on the grid's z axis). On a CPU engine both routes run the
    plain PyTorch versions.
  * **Continuous batching** (:meth:`MatFnEngine.start`): in daemon mode
    ``submit`` returns a :class:`MatFnFuture` immediately and a scheduler
    thread flushes each bucket when it FILLS to ``max_batch`` or when its
    oldest request crosses a per-traffic-class deadline
    (:func:`repro_torch.kernels.autotune.bucket_deadline_ms`). Executor
    failures are routed into the affected bucket's futures as
    :class:`BucketExecutionError` (never lost on a daemon thread), and
    :meth:`MatFnEngine.close` drains every pending bucket before the
    thread exits.
  * **Execution streams** (:mod:`repro_torch.serve.streams`): the
    scheduler hands each due bucket to its route's worker; on a CUDA
    engine each worker owns a ``torch.cuda.Stream``. Streams change the
    SCHEDULE, never the math (``streams=1`` collapses back to one
    serialized queue).
  * **Admission control** (:mod:`repro_torch.serve.admission`), **fault
    wiring** (:mod:`repro_torch.runtime.fault`: a straggler watchdog and
    bounded retries that evict the class's cached callables per attempt)
    and **observability** (:mod:`repro_torch.runtime.telemetry`:
    ``engine.stats()``, ``engine.metrics`` and ``trace=True`` with a
    Chrome-trace export) are the reference's, unchanged.

Routes not ported yet. ``ROUTES`` keeps the reference's five names, with
``"torch"`` for its ``"xla"``. ``fastmm`` (the Strassen route, for n above
``autotune.DEFAULT_FASTMM_CROSSOVER``), the ``markov`` op with its
``evolve`` route, and ``sharded`` (which needs a mesh; the engine takes
none) are refused at :meth:`MatFnEngine.submit` with ``ValueError("unknown
matmul backend ...")`` naming the ROADMAP item that brings them. The
route of a request depends only on (op, n, dtype), so the refusal is exact:
no future is made and nothing is admitted.

Device and streams — the rule. The engine computes on ONE device
(``device=``, resolved by :func:`repro_torch.default_device`: ``cuda``
unless the caller names the CPU, raising when there is no GPU). A tensor
operand must already lie there (``ValueError`` otherwise: nothing is moved
quietly); a numpy operand is copied there.

  1. ``submit`` takes the engine's own copy of the operand, on the caller's
     current stream, and on CUDA records an event after it. A caller that
     writes into its tensor after ``submit`` does not change the answer.
  2. Before a bucket is stacked, the executing stream waits on every
     member's event and the copy is marked used there
     (``Tensor.record_stream``), so the caching allocator does not hand
     its memory to the caller's stream while the worker still reads it.
  3. A daemon worker synchronizes its stream before it resolves any future
     of the bucket: a resolved value is complete on the device and can be
     read from any stream, and a device fault raised by the bucket's
     kernels reaches its futures as :class:`BucketExecutionError` (a
     sticky CUDA error fails its retry too). ``MatFnFuture.result`` marks a
     CUDA result used on the reader's current stream.
  4. The synchronous ``flush`` runs on the caller's thread and current
     stream and synchronizes once, at its end.

Bit-identity. The reference's ``xla`` / ``chain`` bucket answers are
bit-identical to per-matrix calls. On the card the squaring kernels pick
their tile, grid and K slices per operand and stack size, and K slices add
partial sums in their own order, so a bucket padded to B = 16 may differ
in the last place from the same matrix alone: bucket answers are held to
per-matrix calls under ``error_budget``. What stays bit-identical by
construction is the same bucket under any stream count, the synchronous
``flush`` against the daemon, and the survivors of shedding (same callable,
same inputs). For the ``"torch"`` route across streams that holds only
with ``CUBLAS_WORKSPACE_CONFIG`` set (``:4096:8`` or ``:16:8``).

Driver: ``python -m repro_torch.launch.matserve``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
import time
from concurrent.futures import CancelledError, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import List, Optional

import numpy as np
import torch

from repro_torch import DTYPES, default_device, dtype_name
from repro_torch.core.batched import batched_matpow
from repro_torch.core.expm import expm as _expm
from repro_torch.kernels import _build, autotune
from repro_torch.runtime.fault import Watchdog, retry_step
from repro_torch.runtime.telemetry import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.serve.admission import (LANES, AdmissionControl, PendingView,
                                         ShedError)
from repro_torch.serve.scheduler import (BucketView, FillOrDeadline,
                                         FlushPolicy, SystemClock)
from repro_torch.serve.streams import (ExecutionStreams, StreamCrashed,
                                       StreamPool)

__all__ = ["MatFnRequest", "MatFnEngine", "MatFnFuture",
           "BucketExecutionError", "ShedError", "bucket_batch",
           "ExecutionStreams", "OPS", "ROUTES", "TRIGGERS", "NOT_PORTED"]

#: Ops the engine names (``markov`` is refused until its slice lands).
OPS = ("matpow", "expm", "markov")

#: Dispatch routes a bucket can take (see :meth:`MatFnEngine.route_for`):
#: the reference's five, ``"torch"`` standing for its ``"xla"``.
ROUTES = ("torch", "chain", "sharded", "fastmm", "evolve")

#: Routes and ops the port does not serve yet, with the ROADMAP queue 1
#: item that brings each; ``submit`` refuses them.
NOT_PORTED = {
    "fastmm": "ROADMAP queue 1 item 4 (Strassen)",
    "markov": "ROADMAP queue 1 item 5 (Markov)",
    "evolve": "ROADMAP queue 1 item 5 (Markov)",
    "sharded": "ROADMAP queue 1 item 7 (the sharded chain)",
}

#: The concrete backend of each served route (``core.matpow`` names).
_BACKENDS = {"torch": "torch", "chain": "cuda_chain"}


def _not_ported(what: str) -> ValueError:
    return ValueError(f"unknown matmul backend for {what!r}: not ported to "
                      f"repro_torch yet ({NOT_PORTED[what]})")


#: Flush triggers the daemon distinguishes in ``stats["flush_triggers"]``
#: (``priority`` = a latency-lane request at n >= bypass_n forced its
#: bucket due on arrival).
TRIGGERS = ("fill", "deadline", "kick", "drain", "priority")

#: Bound on ``stats["last_flush"]`` in daemon mode (a long-lived daemon
#: must not grow an unbounded report list; sync ``flush`` resets it).
_LAST_FLUSH_ROWS = 256

#: Straggler-event strings retained in the ``stats()`` snapshot.
_STRAGGLER_EVENTS = 32

_UNSET = object()


class BucketExecutionError(RuntimeError):
    """An executor failed while answering a bucket.

    Raised INTO every affected future (never swallowed on the scheduler
    thread): the message carries the bucket key so a consumer holding one
    future of a 64-request bucket can tell which traffic class — not just
    which request — is poisoned, and ``__cause__`` chains the original
    executor exception.
    """

    def __init__(self, key: tuple, cause: BaseException):
        op, n, dtype, power = key
        super().__init__(
            f"bucket (op={op}, n={n}, dtype={dtype}, power={power}) failed "
            f"to execute: {type(cause).__name__}: {cause}")
        self.key = key
        self.__cause__ = cause


class MatFnFuture:
    """One daemon request's pending answer.

    Thread-safe, single-assignment: exactly one of ``set_result`` /
    ``set_exception`` may ever fire — a second resolution attempt raises
    ``concurrent.futures.InvalidStateError``. A resolved tensor is complete
    on the device (the worker synchronized its stream first);
    ``result()`` marks a CUDA result used on the reader's current stream
    (``Tensor.record_stream``), so dropping it there cannot free memory a
    queued read still needs. ``resolved_at`` shares ``submitted_at``'s
    epoch: the ENGINE pre-stamps its own clock's now into
    ``_resolve_at_hint`` before resolving (a bare ``set_result`` without a
    hint falls back to ``time.perf_counter()``). ``tenant`` carries the
    optional caller-supplied tenant tag and ``rid`` the engine's
    per-request id (both observability-only).
    """

    __slots__ = ("bucket_key", "lane", "tenant", "rid",
                 "submitted_at", "resolved_at", "_resolve_at_hint",
                 "_event", "_lock", "_result", "_exception")

    def __init__(self, bucket_key: Optional[tuple] = None,
                 lane: str = "bulk"):
        self.bucket_key = bucket_key
        self.lane = lane
        self.tenant: Optional[str] = None
        self.rid: Optional[int] = None
        self.submitted_at: Optional[float] = None   # engine-clock admit time
        self.resolved_at: Optional[float] = None
        self._resolve_at_hint: Optional[float] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = _UNSET
        self._exception: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _stamp(self) -> float:
        # Engine-clock hint when the engine resolved us, else wall time.
        return time.perf_counter() if self._resolve_at_hint is None \
            else self._resolve_at_hint

    def set_result(self, value) -> None:
        with self._lock:
            if self._event.is_set():
                raise InvalidStateError(f"{self!r} already resolved")
            self._result = value
            self.resolved_at = self._stamp()
            self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                raise InvalidStateError(f"{self!r} already resolved")
            self._exception = exc
            self.resolved_at = self._stamp()
            self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise FutureTimeoutError(f"result not ready after {timeout}s")
        if self._exception is not None:
            raise self._exception
        value = self._result
        if isinstance(value, torch.Tensor) and value.is_cuda:
            value.record_stream(torch.cuda.current_stream(value.device))
        return value

    def exception(self,
                  timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise FutureTimeoutError(f"result not ready after {timeout}s")
        return self._exception

    def __repr__(self):
        state = "pending"
        if self._event.is_set():
            state = "error" if self._exception is not None else "done"
        return f"<MatFnFuture {state} key={self.bucket_key}>"


@dataclasses.dataclass(frozen=True)
class MatFnRequest:
    """One matrix-function request: ``op(operand[, power])``.

    ``operand`` must be one (n, n) square tensor with n >= 1 in one of the
    port's dtypes (``repro_torch.DTYPES``); ``power`` is a static python
    int, meaningful for ``op="matpow"`` (>= 0; ``power == 0`` answers the
    identity). ``ready`` is the CUDA event recorded after the engine's copy
    of the operand (``None`` on the CPU and for requests built by hand).
    The reference's markov ``dists`` wait for the Markov slice.
    """
    op: str
    operand: torch.Tensor
    power: int = 1
    ready: Optional[object] = dataclasses.field(default=None, compare=False,
                                                repr=False)

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; expected one of {OPS}")
        a = self.operand
        if a.ndim != 2 or a.shape[0] != a.shape[1] or a.shape[0] < 1:
            raise ValueError(f"{self.op} requests need one (n, n) matrix "
                             f"with n >= 1, got shape {tuple(a.shape)}")
        dtype_name(a.dtype)          # TypeError outside the port's dtypes
        if self.op == "matpow":
            if not isinstance(self.power, int) \
                    or isinstance(self.power, bool):
                raise TypeError(f"{self.op} requests need a static python "
                                f"int power (one callable per power)")
            if self.power < 0:
                raise ValueError("negative powers not supported")

    @property
    def n(self) -> int:
        return self.operand.shape[0]

    def bucket_key(self) -> tuple:
        """(op, n, dtype, power) — the group this request batches with.
        expm has no power, so every expm request of one (n, dtype) shares
        a bucket (power slot -1)."""
        power = self.power if self.op == "matpow" else -1
        return (self.op, self.n, dtype_name(self.operand.dtype), power)


@dataclasses.dataclass
class _Bucket:
    """One OPEN daemon bucket: futures waiting to be batched."""
    key: tuple
    lane: str                    # admission class ("bulk" / "latency")
    members: list                # [(MatFnFuture, MatFnRequest), ...]
    first_ts: float              # clock time of the oldest pending request
    max_delay_s: float           # tuned flush-by delay for this class
    # kick()/priority bypass: the trigger name that forced this bucket due
    # at the next poll, or None while it batches normally.
    forced: Optional[str] = None
    # Execution-stream id once dispatched (stats attribution), else None.
    stream: Optional[int] = None

    def view(self) -> BucketView:
        return BucketView(self.key, len(self.members), self.first_ts,
                          self.max_delay_s, self.lane)


class _Stats(dict):
    """Engine counters, indexable like a plain dict
    (``engine.stats["requests"]``) and CALLABLE for a consistent snapshot
    (``engine.stats()`` — per-lane counters, queue depths, p50/p95; see
    :meth:`MatFnEngine._stats_snapshot`)."""

    snapshot = None   # bound by the engine

    def __call__(self) -> dict:
        return self.snapshot()


def _assemble(operands, bpad: int) -> torch.Tensor:
    """Stack B (n, n) operands into a (bpad, n, n) buffer on their device:
    one ``torch.stack`` into the head, zero matrices in the filler slots."""
    first = operands[0]
    n = first.shape[-1]
    stack = torch.empty((bpad, n, n), dtype=first.dtype, device=first.device)
    b = len(operands)
    torch.stack(operands, out=stack[:b])
    if bpad > b:
        stack[b:].zero_()
    return stack


def _split_rows(out: torch.Tensor, b: int) -> tuple:
    """The B per-request answers of a bucket result (views of it); the
    filler slots are dropped."""
    return out.unbind(0)[:b]


def _expm_members(x: torch.Tensor, backend: str) -> torch.Tensor:
    """e^A for every matrix of a stack, one matrix at a time, so each keeps
    its own data-dependent squaring count (the reference's ``lax.map``)."""
    return torch.stack([_expm(m, backend=backend) for m in x.unbind(0)])


def bucket_batch(b: int, max_batch: int = 64) -> int:
    """Pad a batch of ``b`` requests up to the next power of two (capped at
    ``max_batch``): ceil-log2 bucketing bounds the callable cache at
    log2(max_batch)+1 shapes per (op, n, dtype, power) group while wasting
    at most half a bucket of filler compute."""
    if b < 1:
        raise ValueError(f"bucket_batch needs b >= 1, got {b}")
    return min(int(max_batch), 1 << (b - 1).bit_length())


class MatFnEngine:
    """Buckets pending matpow/expm requests and answers them batch-at-once.

    Synchronous (library) mode::

        eng = MatFnEngine(device="cpu")
        t0 = eng.submit("matpow", a0, power=7)    # -> int ticket
        t1 = eng.submit("expm", a1)
        r0, r1 = eng.flush()                      # results in ticket order

    Daemon (continuous-batching) mode::

        with MatFnEngine(max_batch=16) as eng:    # __enter__ -> start()
            fut = eng.submit("matpow", a0, power=7)   # -> MatFnFuture
            r0 = fut.result(timeout=5)
        # __exit__ -> close(): drains every pending bucket

    ``flush`` groups everything submitted since the last flush by
    ``(op, n, dtype, power)``, pads each group's batch dim to a bucket size,
    runs one cached callable per bucket, and returns the answers in
    submission order. The daemon runs the SAME bucket core on its stream
    workers — same callable cache, same assembly, same routes — flushing a
    bucket when it fills to ``max_batch`` or when its oldest request
    crosses the bucket's deadline (engine ``max_delay_ms`` override, else
    the tuning cache's per-(op, n, dtype) ``dispatch`` deadline, else
    ``autotune.DEFAULT_MAX_DELAY_MS``), so daemon answers are bit-identical
    to synchronous ``flush()`` answers. Padding slots hold zero matrices —
    their math runs and their answers are discarded.

    Args:
      device: where the engine computes and its operands must lie:
        ``"cuda"`` by default (raises without a GPU), ``"cpu"`` for the
        plain PyTorch versions. It stands for the reference's
        ``interpret=`` and ``mesh=`` (the sharded route is not ported).
      max_batch: bucket-size cap; bigger groups split into chunks. In daemon
        mode also the fill trigger.
      profile: when True, each bucket's execution is wall-timed to device
        completion (``stats["last_flush"]`` rows carry ``seconds``).
        Daemon futures resolve after the worker's stream synchronizes
        either way (the module's rule 3).
      thresholds: explicit (cpu_max_n, sharded_min_n) override; default is
        the tuning cache's ``dispatch`` namespace, resolved per operand
        dtype and memoized per cache GENERATION — recording new thresholds
        mid-process reroutes this engine's next bucket.
      max_delay_ms: explicit daemon flush deadline for every bucket;
        default None resolves per traffic class from the tuning cache.
      policy: a :class:`repro_torch.serve.scheduler.FlushPolicy` (default
        :class:`~repro_torch.serve.scheduler.FillOrDeadline`).
      clock: a :class:`repro_torch.serve.scheduler.Clock` (default the
        system monotonic clock); tests inject ``ManualClock``.
      admission: an :class:`~repro_torch.serve.admission.AdmissionControl`
        (bounded per-lane queues and shed policies; default unbounded).
      watchdog, retries, retry_backoff_s: the fault wiring (straggler
        watchdog; bounded retries, each evicting the class's callables).
      streams: an :class:`~repro_torch.serve.streams.ExecutionStreams`
        config mapping routes onto executor workers (daemon mode only).
        Default: one stream per route; ``ExecutionStreams(streams=1)``
        serializes every route through one worker. Must cover every route.
      trace: request-lifecycle tracing. ``None``/``False``: disabled.
        ``True``: record into a fresh
        :class:`~repro_torch.runtime.telemetry.Tracer` bound to the engine
        clock (``engine.tracer``; ``engine.tracer.export(path)``). A
        ``Tracer``: record into it. Histogram metrics
        (``engine.metrics``) are always on.
    """

    def __init__(self, *, device=None,
                 max_batch: int = 64, profile: bool = False,
                 thresholds: Optional[tuple] = None,
                 max_delay_ms: Optional[float] = None,
                 policy: Optional[FlushPolicy] = None,
                 clock=None,
                 admission: Optional[AdmissionControl] = None,
                 watchdog: Optional[Watchdog] = None,
                 retries: int = 1,
                 retry_backoff_s: float = 0.0,
                 streams: Optional[ExecutionStreams] = None,
                 trace=None):
        device = default_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_ms is not None and not max_delay_ms > 0:
            raise ValueError(f"max_delay_ms must be > 0, got {max_delay_ms}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}")
        self.max_batch = int(max_batch)
        self.profile = bool(profile)
        self._cuda = self.device.type == "cuda"
        self._thresholds_override = tuple(thresholds) \
            if thresholds is not None else None
        self._max_delay_ms = None if max_delay_ms is None \
            else float(max_delay_ms)
        self._policy = policy if policy is not None else FillOrDeadline()
        self._clock = clock if clock is not None else SystemClock()
        self._admission = admission if admission is not None \
            else AdmissionControl()
        # Default watchdog ON: straggler detection costs one median over a
        # 32-entry window per flush and buys the self-healing eviction.
        self._watchdog = watchdog if watchdog is not None else Watchdog()
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._streams = streams if streams is not None else ExecutionStreams()
        missing = [r for r in ROUTES if r not in self._streams.routes]
        if missing:
            raise ValueError(
                f"streams config must cover every engine route; "
                f"missing {missing} from {self._streams.routes}")
        # Executor worker pool (daemon mode only; created by start()).
        self._pool: Optional[StreamPool] = None
        # Streams execute buckets concurrently, so the shared counters in
        # stats (and the callable cache) need their own leaf lock — held
        # only around counter/cache updates, never across execution, and
        # never while taking _cv or the pool lock.
        self._stats_lock = threading.Lock()
        # Memoized dispatch resolutions, each stored WITH the autotune
        # generation it was resolved under and validated on read.
        self._thresholds_cache: dict = {}
        self._deadline_cache: dict = {}
        self._pending: List[MatFnRequest] = []
        self._executables: dict = {}
        # Daemon state (inert until start()).
        self._cv = threading.Condition()
        self._daemon: Optional[threading.Thread] = None
        self._open_buckets: dict = {}     # (key, lane) -> _Bucket
        # Buckets popped from _open_buckets but not yet fully resolved.
        # Kept reachable so a scheduler crash can fail their futures too.
        self._in_flight: List[_Bucket] = []
        self._closing = False
        self._closed = False
        self._waiting = False             # scheduler idle (settle handshake)
        self._scheduler_crash: Optional[BaseException] = None
        # Admission bookkeeping: admitted-but-unflushed requests per lane.
        self._lane_depth = {lane: 0 for lane in LANES}
        self._straggler_log = collections.deque(maxlen=_STRAGGLER_EVENTS)
        self.metrics = MetricsRegistry()
        if trace is None or trace is False:
            self.tracer = NULL_TRACER
        elif trace is True:
            self.tracer = Tracer(clock=self._clock.now)
        elif isinstance(trace, Tracer):
            self.tracer = trace
            if trace._clock is None:
                trace.bind_clock(self._clock.now)
        else:
            raise TypeError(f"trace must be None, a bool, or a Tracer, "
                            f"got {type(trace).__name__}")
        self._rid = itertools.count()
        # Retune visibility: autotune cache-generation bumps annotate the
        # trace. Registered only when tracing — the listener registry is
        # global, so disabled engines must not accumulate there.
        self._unsub_retune = None
        if self.tracer.enabled:
            tracer = self.tracer
            self._unsub_retune = autotune.on_generation_bump(
                lambda gen, reason: tracer.instant(
                    "retune", track="scheduler",
                    generation=gen, reason=reason))
        self.stats = _Stats({
            "requests": 0, "buckets": 0, "compiles": 0,
            "cache_hits": 0, "padded_slots": 0,
            "stragglers": 0, "retries": 0,
            "routes": {r: 0 for r in ROUTES},
            "flush_triggers": {t: 0 for t in TRIGGERS},
            "lanes": {lane: {"submitted": 0, "shed": 0, "retried": 0,
                             "flushed": 0, "peak_depth": 0}
                      for lane in LANES},
            "last_flush": []})
        self.stats.snapshot = self._stats_snapshot

    # -- request intake ----------------------------------------------------
    def _own(self, x) -> torch.Tensor:
        """The engine's copy of one operand, on its device (rule 1 of the
        module docstring): a tensor must already lie there; anything else
        goes through numpy."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(
                    f"operand lies on {x.device}; this engine computes on "
                    f"{self.device} (nothing is moved quietly)")
            if x.dtype not in DTYPES.values():
                raise TypeError(f"unsupported dtype {x.dtype}; the engine "
                                f"serves {sorted(DTYPES)}")
            return x.detach().clone(memory_format=torch.contiguous_format)
        return torch.tensor(np.asarray(x), device=self.device)

    def _ready_event(self):
        """A CUDA event on the caller's current stream, after the copies."""
        if not self._cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def submit(self, op: str, operand, *, power: int = 1,
               priority: str = "bulk",
               tenant: Optional[str] = None):
        """Queue one request.

        Synchronous mode returns the request's int index into the next
        ``flush()``; daemon mode (after :meth:`start`) returns a
        :class:`MatFnFuture` immediately — the scheduler resolves it when
        the request's bucket fills or its deadline passes.

        ``operand`` is a tensor on the engine's device or anything numpy
        accepts (copied to the device); the engine keeps its own copy, so
        writing into the caller's tensor afterwards does not change the
        answer. A request whose route is not ported (the ``markov`` op; a
        bucket whose ``route_for`` is ``fastmm``) raises
        ``ValueError("unknown matmul backend ...")`` here, before anything
        is admitted.

        ``priority`` names the admission lane: ``"bulk"`` (default) or
        ``"latency"`` — latency-lane buckets flush under the lane's SLO
        deadline cap, are scheduled before bulk buckets, and above
        ``AdmissionControl.bypass_n`` skip bucket assembly entirely. When
        the lane's bounded queue is full the admission policy decides who
        pays: ``submit`` raises :class:`~repro_torch.serve.admission.
        ShedError` (reject-newest) or an already-admitted future resolves
        with it (reject-oldest / deadline-aware). In synchronous mode the
        daemon queue does not exist, so admission does not apply.

        ``tenant`` optionally names the submitting tenant for observability
        (a per-tenant latency view and trace tags); ignored in synchronous
        mode.
        """
        if self._closed or self._closing:
            raise RuntimeError("engine is closed; no new requests")
        if priority not in LANES:
            raise ValueError(f"unknown priority lane {priority!r}; "
                             f"expected one of {LANES}")
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        if op in NOT_PORTED:
            raise _not_ported(op)
        operand = self._own(operand)
        req = MatFnRequest(op, operand, power, ready=self._ready_event())
        _, n, dtype, _ = req.bucket_key()
        route = self.route_for(n, 1, dtype)
        if route in NOT_PORTED:
            raise _not_ported(route)
        # Mode check under the lock: a concurrent start() must never see
        # _pending empty and then have a sync request appended behind its
        # back — that ticket could never resolve.
        with self._cv:
            if self._daemon is None:
                self._pending.append(req)
                self.stats["requests"] += 1
                self.stats["lanes"][priority]["submitted"] += 1
                return len(self._pending) - 1
        return self._submit_daemon(req, priority, tenant)

    def _pending_lane(self, lane: str):
        """(views, refs) over one lane's admitted-but-unflushed requests,
        in bucket-iteration order: ``views`` is what policies see,
        ``refs[i] = (bucket, member_index)`` locates the same request for
        eviction. Called under the lock."""
        views, refs = [], []
        for bucket in self._open_buckets.values():
            if bucket.lane != lane:
                continue
            deadline = bucket.first_ts + bucket.max_delay_s
            for i, (fut, _req) in enumerate(bucket.members):
                views.append(PendingView(bucket.key, lane,
                                         fut.submitted_at, deadline))
                refs.append((bucket, i))
        return views, refs

    def _shed_admitted(self, bucket: _Bucket, index: int) -> MatFnFuture:
        """Evict one admitted member (under the lock): remove it from its
        bucket, advance the bucket's deadline anchor past it, drop the
        bucket if it emptied. Returns the victim future (resolved by the
        caller OUTSIDE the lock)."""
        fut, _req = bucket.members.pop(index)
        self._lane_depth[bucket.lane] -= 1
        if not bucket.members:
            del self._open_buckets[(bucket.key, bucket.lane)]
        else:
            bucket.first_ts = min(m[0].submitted_at for m in bucket.members)
        return fut

    def _submit_daemon(self, req: MatFnRequest, lane: str = "bulk",
                       tenant: Optional[str] = None) -> MatFnFuture:
        key = req.bucket_key()
        fut = MatFnFuture(key, lane)
        fut.tenant = tenant
        fut.rid = next(self._rid)
        # Resolved OUTSIDE the lock: a generation bump makes this read the
        # cache file, and one slow disk read must not stall every producer
        # and the scheduler behind the condition lock.
        delay_s = self._lane_delay_s(key, lane)
        victim: Optional[MatFnFuture] = None
        direct: Optional[_Bucket] = None
        shed_depth = 0
        with self._cv:
            if self._closing or self._closed:
                raise RuntimeError("engine is closed; no new requests")
            if self._scheduler_crash is not None:
                raise RuntimeError("scheduler thread crashed") \
                    from self._scheduler_crash
            now = self._clock.now()
            fut.submitted_at = now
            cap = self._admission.capacity_for(lane)
            if cap is not None and self._lane_depth[lane] >= cap:
                # Overflow: the admission policy picks who pays. Shed
                # decisions never touch the device.
                views, refs = self._pending_lane(lane)
                incoming = PendingView(key, lane, now, now + delay_s)
                idx = self._admission.policy.select_victim(
                    views, incoming, now)
                lane_stats = self.stats["lanes"][lane]
                lane_stats["shed"] += 1
                shed_depth = self._lane_depth[lane]
                if idx is None:
                    err = ShedError(lane, shed_depth, cap,
                                    self._admission.policy.name, key)
                    if self.tracer.enabled:
                        # Reject-newest never reaches _resolve (submit
                        # raises), so its terminal request span and shed
                        # instant are emitted here.
                        self.tracer.instant("shed", at=now,
                                            track="requests",
                                            **err.as_tags())
                        self._record_request(fut, now, err)
                    raise err
                victim = self._shed_admitted(*refs[idx])
            bucket = self._open_buckets.get((key, lane))
            opened = bucket is None
            if opened:
                bucket = _Bucket(key, lane, [], now, delay_s)
                self._open_buckets[(key, lane)] = bucket
            bucket.members.append((fut, req))
            self._lane_depth[lane] += 1
            lane_stats = self.stats["lanes"][lane]
            lane_stats["submitted"] += 1
            lane_stats["peak_depth"] = max(lane_stats["peak_depth"],
                                           self._lane_depth[lane])
            self.stats["requests"] += 1
            # Priority bypass: above the size threshold a latency request's
            # own execution dominates any batching win. With
            # ``bypass_direct`` (the default) the bucket goes straight to
            # its route's stream below; otherwise it is only MARKED due.
            if (lane == "latency" and bucket.forced is None
                    and req.n >= self._admission.bypass_n):
                if self._admission.bypass_direct and self._pool is not None:
                    del self._open_buckets[(key, lane)]
                    self._lane_depth[lane] -= len(bucket.members)
                    self._in_flight.append(bucket)
                    direct = bucket
                else:
                    bucket.forced = "priority"
            self._policy.observe(bucket.view(), now)
            # Wake the scheduler only when this submit can change what it
            # should do: a NEW bucket moves its sleep deadline, a filled
            # or forced bucket is due now, and an adaptive policy may have
            # just moved every deadline earlier.
            if direct is None and (opened or bucket.forced is not None
                                   or len(bucket.members) >= self.max_batch
                                   or self._policy.wake_on_observe):
                self._cv.notify_all()
        if direct is not None:
            # Outside the lock: dispatch takes the pool lock.
            self._dispatch_bucket(direct, "priority")
        if victim is not None:
            # Outside the lock: set_exception wakes the victim's waiters.
            err = ShedError(victim.lane, shed_depth, cap,
                            self._admission.policy.name, victim.bucket_key)
            self.tracer.instant("shed", track="requests", **err.as_tags())
            self._resolve(victim, exc=err)
        return fut

    # -- dispatch policy ---------------------------------------------------
    @staticmethod
    def _memoized(memo: dict, key, resolve):
        """Generation-checked memo read: entries are stored as
        ``(generation, value)`` and only trusted while the autotune cache
        is still at that generation. The generation is captured BEFORE
        resolving, so a retune that lands mid-resolution leaves a stale
        generation behind and the next read re-resolves."""
        gen = autotune.cache_generation()
        hit = memo.get(key)
        if hit is not None and hit[0] == gen:
            return hit[1]
        value = resolve()
        memo[key] = (gen, value)
        return value

    def thresholds_for(self, dtype=None) -> tuple:
        """(cpu_max_n, sharded_min_n) for an operand dtype (a name or a
        ``torch.dtype``): the constructor override, else the tuning cache's
        ``dispatch`` namespace per dtype, memoized per cache generation."""
        if self._thresholds_override is not None:
            return self._thresholds_override
        key = "any" if dtype is None else (
            dtype_name(dtype) if isinstance(dtype, torch.dtype) else dtype)
        return self._memoized(
            self._thresholds_cache, key,
            lambda: autotune.dispatch_thresholds(
                dtype=None if key == "any" else key,
                backend=self.device.type))

    @property
    def thresholds(self) -> tuple:
        """The dtype-agnostic thresholds (override or ``any`` cache entry)."""
        return self.thresholds_for(None)

    def _bucket_delay_s(self, key: tuple) -> float:
        """Flush deadline (seconds) for one traffic class: the engine
        override, else the tuned per-(op, n, dtype) ``dispatch`` deadline
        entry, memoized per cache generation like the thresholds."""
        if self._max_delay_ms is not None:
            return self._max_delay_ms / 1e3
        op, n, dtype, _power = key
        return self._memoized(
            self._deadline_cache, (op, n, dtype),
            lambda: autotune.bucket_deadline_ms(
                op, n, dtype=dtype, backend=self.device.type) / 1e3)

    def _lane_delay_s(self, key: tuple, lane: str) -> float:
        """Effective flush deadline for one (traffic class, lane): the
        class deadline capped by the lane's SLO target."""
        delay_s = self._bucket_delay_s(key)
        slo_s = self._admission.slo_s_for(lane)
        return delay_s if slo_s is None else min(delay_s, slo_s)

    def fastmm_crossover_for(self, dtype=None) -> int:
        """The Strassen crossover n: buckets with n STRICTLY above it take
        the ``fastmm`` route, which ``submit`` refuses until the Strassen
        slice lands (``autotune.DEFAULT_FASTMM_CROSSOVER`` for every
        dtype until then)."""
        del dtype
        return autotune.DEFAULT_FASTMM_CROSSOVER

    def route_for(self, n: int, batch: int, dtype=None) -> str:
        """Heterogeneous dispatch: which executor serves an (n, batch)
        bucket. n <= ``cpu_max_n`` takes ``"torch"``; n above the Strassen
        crossover ``"fastmm"`` (refused); everything else the kernel
        ``"chain"``. The engine owns no mesh, so ``"sharded"`` never arises
        and the route does not depend on ``batch``."""
        del batch
        cpu_max_n, _sharded_min_n = self.thresholds_for(dtype)
        if n <= cpu_max_n:
            return "torch"
        if n > self.fastmm_crossover_for(dtype):
            return "fastmm"
        return "chain"

    # -- callable cache ----------------------------------------------------
    def _executable(self, op: str, route: str, padded_batch: int, n: int,
                    dtype: str, power: int):
        # The whole lookup-or-build runs under the stats lock: concurrent
        # streams sharing one cache must count exactly one build per key.
        with self._stats_lock:
            key = (op, route, padded_batch, n, dtype, power)
            exe = self._executables.get(key)
            if exe is not None:
                self.stats["cache_hits"] += 1
                return key, exe, False
            if op in NOT_PORTED:
                raise _not_ported(op)
            if route not in _BACKENDS:
                raise _not_ported(route)
            backend = _BACKENDS[route]
            if op == "matpow":
                exe = functools.partial(batched_matpow, p=power,
                                        backend=backend)
            else:
                exe = functools.partial(_expm_members, backend=backend)
            self._executables[key] = exe
            self.stats["compiles"] += 1
            return key, exe, True

    def warm(self, op: str, n: int, dtype=torch.float32, power: int = 1,
             batches=None) -> int:
        """Prepare everything one traffic class will need.

        Runs the REAL bucket path (assembly, callable, split) on zero
        stacks for every batch size in ``batches`` — default
        1..``max_batch`` — so a partial bucket of a size never seen before
        pays no first-call cost on the latency path. On CUDA it first
        builds the kernels (``kernels._build.load()``). In daemon mode each
        warm chunk runs ON its route's execution stream; synchronous
        engines warm on the calling thread. Returns the number of chunks
        warmed (they count into the engine stats like any bucket).
        """
        if isinstance(dtype, str):
            dtype = DTYPES[dtype]
        name = dtype_name(dtype)
        if batches is None:
            batches = range(1, self.max_batch + 1)
        power = power if op == "matpow" else -1
        if op in NOT_PORTED:
            raise _not_ported(op)
        route = self.route_for(n, 1, name)
        if route in NOT_PORTED:
            raise _not_ported(route)
        if self._cuda and route == "chain":
            _build.load()
        with self._cv:
            pool = self._pool

        def chunk(b):
            operands = [torch.zeros((n, n), dtype=dtype, device=self.device)
                        for _ in range(b)]
            rows = self._run_chunk(op, n, name, power, operands)
            self._sync()
            return rows

        count, jobs = 0, []
        for b in batches:
            if pool is not None:
                stream = self._streams.stream_for(route)
                jobs.append(pool.call(stream, functools.partial(chunk, b)))
            else:
                chunk(b)
            count += 1
        for job in jobs:       # propagate build errors to the caller
            job.result()
        return count

    # -- bucket execution core (shared by flush() and the daemon) ----------
    def _sync(self) -> None:
        """Wait for the current stream's work on a CUDA engine (a device
        fault raises here)."""
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def _stage(self, reqs) -> list:
        """The payloads of ``reqs``, made safe to read on the current
        stream (rule 2): wait for each copy's event, and mark the copy used
        on this stream."""
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            for req in reqs:
                if req.ready is not None:
                    stream.wait_event(req.ready)
                req.operand.record_stream(stream)
        return [req.operand for req in reqs]

    def _run_chunk(self, op: str, n: int, dtype: str, power: int,
                   operands) -> tuple:
        """Assemble, execute, and split ONE bucket chunk (<= max_batch).

        Returns the B per-request result rows. This is the single execution
        core both the synchronous ``flush`` and the daemon run, which is
        what keeps daemon answers bit-identical to synchronous ones: same
        assembly, same callable cache, same routes.

        Stage timing: assemble (operand stack + pad + callable lookup),
        execute (the call; device-complete only under ``profile=True``),
        resolve (row split) feed the ``stage`` histograms behind
        ``stats()["stages"]`` and, when tracing, per-stage spans on the
        executing thread's track.
        """
        b = len(operands)
        route = self.route_for(n, b, dtype)
        bpad = bucket_batch(b, self.max_batch)
        clk = self._clock.now
        t0 = clk()
        stack = _assemble(list(operands), bpad)
        key, exe, fresh = self._executable(op, route, bpad, n, dtype, power)
        # expm answers each member alone (``_expm_members``), so the filler
        # slots, whose answers are dropped, are not computed.
        operand = stack if op == "matpow" else stack[:b]
        t1 = clk()
        if self.profile:
            # perf_counter, not the engine clock: this dt is honest device
            # wall time even under a ManualClock test.
            tp = time.perf_counter()
            out = exe(operand)
            self._sync()
            dt = time.perf_counter() - tp
        else:
            out = exe(operand)
            dt = None
        t2 = clk()
        rows = _split_rows(out, b)   # drops the filler slots too
        t3 = clk()
        self.metrics.record("stage", t1 - t0, stage="assemble", route=route)
        self.metrics.record("stage", t2 - t1, stage="execute", route=route)
        self.metrics.record("stage", t3 - t2, stage="resolve", route=route)
        if self.tracer.enabled:
            track = threading.current_thread().name
            common = dict(op=op, n=n, dtype=dtype, route=route,
                          batch=b, padded=bpad)
            self.tracer.add_span("bucket.assemble", t0, t1, track=track,
                                 cold=fresh, **common)
            if fresh:
                self.tracer.instant("compile", at=t1, track=track, **common)
            self.tracer.add_span("bucket.execute", t1, t2, track=track,
                                 profiled=self.profile, **common)
            self.tracer.add_span("bucket.resolve", t2, t3, track=track,
                                 **common)
        with self._stats_lock:
            self.stats["padded_slots"] += bpad - b
            self.stats["buckets"] += 1
            self.stats["routes"][route] += 1
            self.stats["last_flush"].append(
                {"key": key, "requests": b, "padded_batch": bpad,
                 "route": route, "seconds": dt})
        return rows

    # -- synchronous batch execution ---------------------------------------
    def flush(self) -> List[torch.Tensor]:
        """Answer every pending request; results in submission order.

        Synchronous mode only — the daemon owns its queue and resolves
        futures instead (``close()`` drains it). Runs on the caller's
        thread and current stream, and on CUDA synchronizes once at the end.
        """
        if self._daemon is not None:
            raise RuntimeError(
                "flush() is the synchronous API; in daemon mode the "
                "scheduler resolves futures — use submit().result() "
                "(close() drains pending work)")
        pending, self._pending = self._pending, []
        results: List[Optional[torch.Tensor]] = [None] * len(pending)
        groups: dict = {}
        for idx, req in enumerate(pending):
            groups.setdefault(req.bucket_key(), []).append((idx, req))

        self.stats["last_flush"] = []
        for (op, n, dtype, power), members in groups.items():
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                rows = self._run_chunk(op, n, dtype, power,
                                       self._stage([r for _, r in chunk]))
                for (idx, _), row in zip(chunk, rows):
                    results[idx] = row
        self._sync()
        return results  # type: ignore[return-value]

    # -- continuous-batching daemon ----------------------------------------
    @property
    def running(self) -> bool:
        """True while the scheduler thread is serving submits."""
        return (self._daemon is not None and self._daemon.is_alive()
                and not self._closed)

    def start(self) -> "MatFnEngine":
        """Promote the engine to a continuous-batching daemon.

        Spawns the scheduler thread and the stream workers; from here
        ``submit`` returns futures and buckets flush on fill-or-deadline.
        Idempotent while running; a closed engine cannot restart.
        """
        with self._cv:
            if self._closed:
                raise RuntimeError("engine is closed and cannot restart")
            if self._daemon is not None:
                return self
            if self._pending:
                raise RuntimeError(
                    f"{len(self._pending)} synchronous request(s) pending; "
                    f"flush() before start() — tickets would never resolve")
            self._clock.bind(self._cv)
            # Executor streams first: the scheduler dispatches into the
            # pool from its very first poll. Lock order is engine -> pool.
            self._pool = StreamPool(self._streams, self._stream_execute,
                                    on_free=self._on_stream_free,
                                    on_crash=self._on_stream_crash,
                                    tracer=self.tracer,
                                    metrics=self.metrics,
                                    now=self._clock.now,
                                    device=self.device).start()
            # Assigned AND started under the lock: from here every submit
            # routes to the daemon, and a concurrent close() can never
            # join a not-yet-started thread.
            self._daemon = threading.Thread(target=self._scheduler_main,
                                            name="matfn-scheduler",
                                            daemon=True)
            self._daemon.start()
        return self

    def __enter__(self) -> "MatFnEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def kick(self, key: Optional[tuple] = None) -> int:
        """Mark open buckets due now (flush without waiting for fill or
        deadline): the ``key``'s buckets only (both lanes), or every open
        bucket when ``key`` is None. Kicking an empty traffic class is a
        NO-OP (no trigger counted, the scheduler not woken). Returns the
        number of buckets kicked.
        """
        kicked = 0
        with self._cv:
            for bucket in self._open_buckets.values():
                if (key is None or bucket.key == key) \
                        and bucket.forced is None:
                    bucket.forced = "kick"
                    kicked += 1
            if kicked:
                self._cv.notify_all()
        return kicked

    def settle(self, timeout: float = 10.0) -> None:
        """Block until the scheduler has DISPATCHED everything currently
        due, every execution stream has finished what it was handed, and
        the daemon is idle (waiting for new work or a future deadline).

        Instrumentation/test hook: with a ``ManualClock`` this makes "the
        daemon processed that wakeup" a deterministic event. Raises
        ``TimeoutError`` if the scheduler does not settle in ``timeout``
        real seconds. No-op in synchronous mode.
        """
        if self._daemon is None:
            return
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._scheduler_crash is not None:
                    raise RuntimeError("scheduler thread crashed") \
                        from self._scheduler_crash
                streams_idle = (not self._in_flight
                                and (self._pool is None
                                     or self._pool.idle()))
                if not self._daemon.is_alive() and not self._open_buckets \
                        and streams_idle:
                    return
                if self._waiting and streams_idle \
                        and not self._any_due(self._clock.now()):
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("scheduler did not settle")
                # Sliced wait: also bounds the case where the scheduler
                # dies without a final notify.
                self._cv.wait(min(remaining, 0.05))

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the daemon. Idempotent; synchronous engines just close.

        ``drain=True`` (default): the scheduler flushes EVERY pending
        bucket before exiting, so no submitted future is ever dropped;
        errors still resolve futures (as :class:`BucketExecutionError`).
        ``drain=False`` fails every pending future with ``CancelledError``
        and exits without running them — including futures of buckets
        already popped for execution (if the executor finishes first, the
        real answer wins and the late cancel is a no-op). New submits are
        rejected as soon as close begins.

        With a ``timeout``, a scheduler that has not drained in time
        raises ``TimeoutError`` (the engine stays closed to new submits).
        """
        if self._unsub_retune is not None:
            self._unsub_retune()
            self._unsub_retune = None
        if self._daemon is None:
            self._closed = True
            return
        cancelled: List[_Bucket] = []
        cancel = False
        with self._cv:
            cancel = not drain and not self._closing
            if cancel:
                # Open buckets are dropped outright; in-flight buckets are
                # only COPIED — their stream still owns them.
                cancelled = (list(self._open_buckets.values())
                             + list(self._in_flight))
                self._open_buckets.clear()
                self._lane_depth = {lane: 0 for lane in LANES}
            self._closing = True
            self._cv.notify_all()
        if cancel and self._pool is not None:
            # Queued-but-unstarted buckets never run: pull them off their
            # streams so the drain wait doesn't execute doomed work.
            dropped = [b for b, _t in self._pool.cancel_queued()]
            with self._cv:
                for b in dropped:
                    if b in self._in_flight:
                        self._in_flight.remove(b)
                self._cv.notify_all()
        for bucket in cancelled:
            err = CancelledError(f"engine closed with drain=False; bucket "
                                 f"{bucket.key} dropped")
            for fut, _ in bucket.members:
                self._resolve(fut, exc=err)
        self._daemon.join(timeout)
        self._closed = True
        if self._daemon.is_alive():
            raise TimeoutError(
                f"scheduler still draining after {timeout}s; engine is "
                f"closed to new submits, pending futures may yet resolve")
        if self._pool is not None:
            self._pool.shutdown()
            if not self._pool.join(timeout):
                raise TimeoutError(
                    f"execution streams still busy after {timeout}s; "
                    f"engine is closed to new submits, pending futures "
                    f"may yet resolve")

    # -- scheduler internals -----------------------------------------------
    def _any_due(self, now: float) -> bool:
        return self._closing or any(
            b.forced or self._policy.due(b.view(), now, self.max_batch)
            for b in self._open_buckets.values())

    def _take_due(self, now: float,
                  lane: Optional[str] = None) -> List[tuple]:
        """Pop every bucket that must flush now; returns (bucket, trigger)
        pairs with LATENCY-lane buckets first. ``lane`` restricts the scan
        to one lane. Under ``_closing`` everything pending drains. Every
        popped bucket is registered in ``_in_flight`` BEFORE this returns,
        so the crash handler can always reach it."""
        due = []
        for dict_key in list(self._open_buckets):
            bucket = self._open_buckets[dict_key]
            if lane is not None and bucket.lane != lane:
                continue
            if self._closing:
                trigger = "drain"
            elif bucket.forced is not None:
                trigger = bucket.forced
            elif self._policy.due(bucket.view(), now, self.max_batch):
                trigger = ("fill" if len(bucket.members) >= self.max_batch
                           else "deadline")
            else:
                continue
            del self._open_buckets[dict_key]
            self._lane_depth[bucket.lane] -= len(bucket.members)
            self._in_flight.append(bucket)
            due.append((bucket, trigger))
        due.sort(key=lambda bt: 0 if bt[0].lane == "latency" else 1)
        return due

    def _next_timeout(self, now: float) -> Optional[float]:
        """Seconds until the earliest bucket deadline (None: no buckets)."""
        if not self._open_buckets:
            return None
        earliest = min(self._policy.deadline(b.view(), self.max_batch)
                       for b in self._open_buckets.values())
        return max(earliest - now, 0.0)

    def _scheduler_main(self) -> None:
        try:
            self._scheduler_loop()
        except BaseException as exc:  # never die silently: fail what's left
            # Pull queued-but-unstarted buckets off every stream first;
            # buckets already EXECUTING finish on their streams and race
            # the sweep (single-assignment settles who wins).
            if self._pool is not None:
                self._pool.cancel_queued()
            with self._cv:
                self._scheduler_crash = exc
                leftovers = (list(self._in_flight)
                             + list(self._open_buckets.values()))
                self._open_buckets.clear()
                self._in_flight.clear()
                self._lane_depth = {lane: 0 for lane in LANES}
                self._cv.notify_all()
            for bucket in leftovers:
                err = BucketExecutionError(bucket.key, exc)
                for fut, _ in bucket.members:
                    self._resolve(fut, exc=err)
        else:
            # Normal exit (close drain): joining the scheduler thread must
            # keep meaning "fully drained".
            self._drain_streams()

    def _drain_streams(self) -> None:
        if self._pool is None:
            return
        with self._cv:
            self._clock.wait_for(
                self._cv,
                lambda: not self._in_flight and self._pool.idle())

    def _scheduler_loop(self) -> None:
        """Fill-or-deadline scheduling: sleep until the earliest deadline
        (or a submit/kick/close wakeup), hand what is due to its route's
        execution stream, repeat. The scheduler never executes buckets
        itself; latency-lane buckets go first within one poll and jump
        their stream's queue."""
        while True:
            with self._cv:
                while True:
                    now = self._clock.now()
                    due = self._take_due(now)
                    if due:
                        break
                    if self._closing:      # drained: nothing left to take
                        return
                    self._waiting = True
                    self._cv.notify_all()  # settle() handshake
                    try:
                        self._clock.traced_wait(
                            self._cv, self._next_timeout(now), self.tracer)
                    finally:
                        self._waiting = False
            for bucket, trigger in due:
                self._dispatch_bucket(bucket, trigger)

    def _dispatch_bucket(self, bucket: _Bucket, trigger: str) -> None:
        """Hand one popped bucket to its route's execution stream. A
        crashed stream fails just this bucket's futures (typed,
        attributable) instead of sinking the scheduler."""
        op, n, dtype, power = bucket.key
        route = self.route_for(n, min(len(bucket.members), self.max_batch),
                               dtype)
        if self.tracer.enabled:
            self.tracer.add_span(
                "bucket.batch", bucket.first_ts, self._clock.now(),
                track="scheduler", op=op, n=n, dtype=dtype, power=power,
                lane=bucket.lane, route=route, trigger=trigger,
                batch=len(bucket.members))
        try:
            bucket.stream = self._pool.dispatch(
                route, bucket, trigger,
                priority=(bucket.lane == "latency"))
        except StreamCrashed as exc:
            with self._cv:
                if bucket in self._in_flight:
                    self._in_flight.remove(bucket)
                self._cv.notify_all()
            err = BucketExecutionError(bucket.key, exc)
            for fut, _ in bucket.members:
                self._resolve(fut, exc=err)

    def _stream_execute(self, bucket: _Bucket, trigger: str,
                        stream: int) -> None:
        """The pool's executor: runs on a stream worker. The finally block
        de-registers the bucket and wakes anyone waiting on "a stream
        freed", even when a non-Exception escape is about to crash the
        stream."""
        del stream  # identity is recorded at dispatch (bucket.stream)
        try:
            self._execute_bucket(bucket, trigger)
        finally:
            with self._cv:
                if bucket in self._in_flight:
                    self._in_flight.remove(bucket)
                self._cv.notify_all()

    def _on_stream_free(self, stream: int) -> None:
        """Pool callback (outside the pool lock): wake settle()/drain
        waiters blocked on the engine cv."""
        del stream
        with self._cv:
            self._cv.notify_all()

    def _on_stream_crash(self, stream: int, items: List[tuple],
                         exc: BaseException) -> None:
        """Pool callback (outside the pool lock): stream ``stream`` died
        executing ``items[0]``; ``items[1:]`` are its queued-but-unstarted
        buckets. Every affected future fails with a
        :class:`BucketExecutionError`; other streams keep serving."""
        buckets = [b for b, _t in items]
        with self._cv:
            for b in buckets:
                if b in self._in_flight:
                    self._in_flight.remove(b)
            self._cv.notify_all()
        for b in buckets:
            err = BucketExecutionError(b.key, exc)
            for fut, _ in b.members:
                self._resolve(fut, exc=err)

    def _resolve(self, fut: MatFnFuture, value=_UNSET,
                 exc: Optional[BaseException] = None) -> bool:
        """Resolve one future, tolerating an earlier resolution (a
        close(drain=False) cancel or crash sweep racing the executor).
        The timestamp comes from the ENGINE clock (``submitted_at``'s
        epoch); successful results feed the per-lane (and per-tenant)
        latency histograms; every winning resolution emits the request's
        terminal lifecycle span."""
        at = self._clock.now()
        fut._resolve_at_hint = at
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            return False
        if exc is None and fut.submitted_at is not None:
            dt = at - fut.submitted_at
            if fut.tenant is not None:
                self.metrics.record("latency", dt, lane=fut.lane,
                                    tenant=fut.tenant)
            else:
                self.metrics.record("latency", dt, lane=fut.lane)
        self._record_request(fut, at, exc)
        return True

    def _record_request(self, fut: MatFnFuture, end: float,
                        exc: Optional[BaseException]) -> None:
        """Emit one request's terminal lifecycle span (submit -> terminal,
        on the ``requests`` track), exactly once per request."""
        if not self.tracer.enabled or fut.submitted_at is None:
            return
        if exc is None:
            outcome = "resolved"
        elif isinstance(exc, ShedError):
            outcome = "shed"
        elif isinstance(exc, CancelledError):
            outcome = "cancelled"
        else:
            outcome = "error"
        op, n, dtype, power = fut.bucket_key
        tags = dict(op=op, n=n, dtype=dtype, power=power, lane=fut.lane,
                    rid=fut.rid, outcome=outcome)
        if fut.tenant is not None:
            tags["tenant"] = fut.tenant
        self.tracer.add_span("request", fut.submitted_at, end,
                             track="requests", **tags)

    def _evict_class_executables(self, key: tuple) -> int:
        """Drop every cached callable serving one (op, n, dtype, power)
        traffic class — all routes and padded batch sizes (the self-heal
        path of a retry)."""
        op, n, dtype, power = key
        with self._stats_lock:
            stale = [k for k in self._executables
                     if (k[0], k[3], k[4], k[5]) == (op, n, dtype, power)]
            for k in stale:
                del self._executables[k]
        return len(stale)

    def _execute_bucket(self, bucket: _Bucket, trigger: str) -> None:
        """Run one popped bucket on the current stream worker and resolve
        its futures.

        Each chunk runs under the fault runtime: the flush is wall-timed
        into the :class:`~repro_torch.runtime.fault.Watchdog` (a straggling
        flush records a ``StragglerEvent``), and an executor exception —
        a device fault included, since the stream is synchronized inside
        the attempt — retries through
        :func:`~repro_torch.runtime.fault.retry_step`, each retry evicting
        the class's cached callables first. Only after ``self.retries``
        bounded retries does the FAILING CHUNK resolve with a
        :class:`BucketExecutionError` naming the bucket key.
        """
        op, n, dtype, power = bucket.key
        lane_stats = self.stats["lanes"][bucket.lane]
        with self._stats_lock:
            self.stats["flush_triggers"][trigger] += 1
        members = bucket.members
        for lo in range(0, len(members), self.max_batch):
            chunk = members[lo:lo + self.max_batch]

            def run_chunk():
                # self._run_chunk looked up per attempt (tests monkeypatch
                # the bound attribute); the stream is synchronized before
                # any future of the chunk resolves (rule 3).
                rows = self._run_chunk(op, n, dtype, power,
                                       self._stage([r for _, r in chunk]))
                self._sync()
                return rows

            def on_retry(attempt, exc):
                self._evict_class_executables(bucket.key)
                with self._stats_lock:
                    self.stats["retries"] += 1
                    lane_stats["retried"] += len(chunk)
                self.tracer.instant(
                    "retry", track=threading.current_thread().name,
                    op=op, n=n, dtype=dtype, power=power, lane=bucket.lane,
                    attempt=attempt, error=type(exc).__name__)

            t0 = time.perf_counter()
            try:
                rows = retry_step(run_chunk, retries=self.retries,
                                  backoff_s=self.retry_backoff_s,
                                  on_retry=on_retry)
            except Exception as exc:
                err = BucketExecutionError(bucket.key, exc)
                for fut, _ in chunk:
                    self._resolve(fut, exc=err)
                continue
            finally:
                event = self._watchdog.observe(self.stats["buckets"],
                                               time.perf_counter() - t0)
                if event is not None:
                    with self._stats_lock:
                        self.stats["stragglers"] += 1
                    self._straggler_log.append(
                        f"{event} (bucket {bucket.key}, lane {bucket.lane})")
                    self.tracer.instant(
                        "straggler",
                        track=threading.current_thread().name,
                        key=str(bucket.key), lane=bucket.lane,
                        **event.as_tags())
            for (fut, _), row in zip(chunk, rows):
                self._resolve(fut, value=row)
            with self._stats_lock:
                lane_stats["flushed"] += len(chunk)
        with self._stats_lock:
            rows_log = self.stats["last_flush"]
            if len(rows_log) > _LAST_FLUSH_ROWS:
                del rows_log[:len(rows_log) - _LAST_FLUSH_ROWS]

    # -- observability -----------------------------------------------------
    def _stats_snapshot(self) -> dict:
        """One consistent point-in-time report (what ``engine.stats()``
        returns): the cumulative counters plus, per lane, the LIVE queue
        depth, peak depth, and histogram-backed p50/p95 latency over ALL
        resolutions (engine-clock submit -> resolution); ``stages`` breaks
        the pipeline down per stage (queue / assemble / execute / resolve);
        ``watchdog_events`` surfaces the straggler watchdog's event log;
        ``telemetry`` reports the tracer's state."""
        with self._cv:
            lanes = {}
            for lane in LANES:
                row = dict(self.stats["lanes"][lane])
                row["queue_depth"] = self._lane_depth[lane]
                hist = self.metrics.merged("latency", lane=lane)
                row["p50_ms"] = None if hist.count == 0 \
                    else hist.quantile(0.50) * 1e3
                row["p95_ms"] = None if hist.count == 0 \
                    else hist.quantile(0.95) * 1e3
                lanes[lane] = row
            stages = {}
            for stage in ("queue", "assemble", "execute", "resolve"):
                hist = self.metrics.merged("stage", stage=stage)
                if hist.count:
                    stages[stage] = hist.snapshot()
            streams = []
            peak = 0
            if self._pool is not None:
                per_stream: dict = {}
                for b in self._in_flight:
                    if b.stream is not None:
                        per_stream[b.stream] = per_stream.get(b.stream,
                                                              0) + 1
                streams = self._pool.snapshot()
                for row in streams:
                    row["in_flight"] = per_stream.get(row["stream"], 0)
                peak = self._pool.peak_concurrent
            with self._stats_lock:
                return {
                    "requests": self.stats["requests"],
                    "buckets": self.stats["buckets"],
                    "compiles": self.stats["compiles"],
                    "cache_hits": self.stats["cache_hits"],
                    "padded_slots": self.stats["padded_slots"],
                    "stragglers": self.stats["stragglers"],
                    "retries": self.stats["retries"],
                    "routes": dict(self.stats["routes"]),
                    "flush_triggers": dict(self.stats["flush_triggers"]),
                    "lanes": lanes,
                    "open_buckets": len(self._open_buckets),
                    "in_flight": len(self._in_flight),
                    "streams": streams,
                    "peak_concurrent_streams": peak,
                    "straggler_events": list(self._straggler_log),
                    "admission_policy": self._admission.policy.name,
                    "stages": stages,
                    "watchdog_events": snap(limit=_STRAGGLER_EVENTS)
                    if (snap := getattr(self._watchdog, "snapshot",
                                        None)) is not None else [],
                    "telemetry": {"tracing": self.tracer.enabled,
                                  "spans": len(self.tracer),
                                  "dropped": self.tracer.dropped},
                }

    # -- convenience single-request API ------------------------------------
    def _one(self, op: str, a, **kw):
        ticket = self.submit(op, a, **kw)
        if isinstance(ticket, MatFnFuture):
            self.kick(ticket.bucket_key)
            return ticket.result()
        return self.flush()[ticket]

    def matpow(self, a, power: int) -> torch.Tensor:
        """Synchronous A^power through the engine (flushes the queue; in
        daemon mode kicks the scheduler and waits on the future)."""
        return self._one("matpow", a, power=power)

    def expm(self, a) -> torch.Tensor:
        """Synchronous e^A through the engine (flushes the queue; in daemon
        mode kicks the scheduler and waits on the future)."""
        return self._one("expm", a)
