"""repro_torch.runtime — runtime services shared across the stack.

``fault``     — fault tolerance: bounded retry, straggler watchdog,
                elastic re-mesh planning.
``telemetry`` — observability: span-based request-lifecycle tracing
                (Chrome trace-event export, Perfetto-loadable) and
                log-spaced histogram metrics with a labeled registry.

Both are pure Python (no ``torch``), copied from the reference's
``repro.runtime``, whose names they keep.
"""

from repro_torch.runtime.fault import (StragglerEvent, Watchdog,
                                       plan_elastic_mesh, retry_step)
from repro_torch.runtime.telemetry import (NULL_TRACER, Histogram,
                                           MetricsRegistry, Tracer)

__all__ = [
    "StragglerEvent", "Watchdog", "retry_step", "plan_elastic_mesh",
    "Histogram", "MetricsRegistry", "Tracer", "NULL_TRACER",
]
