"""repro_torch.serve — serving layer.

``matfn``     — the matrix-function serving engine: request bucketing,
                batched squaring chains, heterogeneous dispatch, and the
                continuous-batching daemon (``MatFnEngine.start()``).
``scheduler`` — the daemon's pluggable flush policies (fill-or-deadline,
                arrival-rate-adaptive) and injectable clocks.
``admission`` — the daemon's front door: bounded per-lane queues, shed
                policies (reject-newest / reject-oldest / deadline-aware),
                priority-lane SLO targets, and the typed ``ShedError``.
``streams``   — the daemon's per-route execution streams (one
                ``torch.cuda.Stream`` per worker on a CUDA engine).

The reference's ``engine`` (batched LM prefill/decode) comes with the LM
substrate. Telemetry lives in :mod:`repro_torch.runtime.telemetry`.
"""

from repro_torch.serve.admission import (LANES, POLICIES, AdmissionControl,
                                         AdmissionPolicy, DeadlineAware,
                                         RejectNewest, RejectOldest,
                                         ShedError)
from repro_torch.serve.matfn import (BucketExecutionError, MatFnEngine,
                                     MatFnFuture, MatFnRequest, bucket_batch)
from repro_torch.serve.scheduler import (AdaptiveDeadline, FillOrDeadline,
                                         FlushPolicy, ManualClock,
                                         SystemClock)
from repro_torch.serve.streams import (ExecutionStreams, StreamCrashed,
                                       StreamPool)

__all__ = [
    "MatFnEngine", "MatFnRequest", "MatFnFuture", "BucketExecutionError",
    "bucket_batch",
    "FlushPolicy", "FillOrDeadline", "AdaptiveDeadline",
    "SystemClock", "ManualClock",
    "LANES", "POLICIES", "AdmissionControl", "AdmissionPolicy",
    "RejectNewest", "RejectOldest", "DeadlineAware", "ShedError",
    "ExecutionStreams", "StreamPool", "StreamCrashed",
]
