"""The profiler window of a ``--trace 1`` run, reduced to numbers.

``torch.profiler`` traces the card's activity and the CUDA runtime calls
of every thread (CUPTI), and the host's operations of the thread that
opens and closes the window, over the measured window; the window itself
is the span of a ``perfbench.window`` annotation on that thread.
Nothing is written to disk: the events are read from memory.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Summary", "Window", "reduce_events", "summarize"]

WINDOW = "perfbench.window"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
TOP = 10


@dataclasses.dataclass
class Summary:
    busy_s: float             # union of the card's activity in the window
    window_s: float           # the window's length
    syncs: int                # host waits on the card (CUDA runtime calls)
    nccl_s: float             # NCCL kernels' time in the window
    device_ops: list          # [[name, seconds], ...] most time first
    idle_gaps: list           # [[what the host did, seconds], ...]


class Window:
    """Profile from construction to :meth:`close` when ``enabled``; after
    it, ``prof`` is the finished profiler (None when disabled)."""

    def __init__(self, enabled: bool):
        self.prof = None
        self._prof = self._mark = None
        if not enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # The host's operations are recorded on this thread only (the
        # window's span; the whole run on a mesh). The engine's scheduler
        # and stream workers issue thousands of operations a request,
        # and recording them on every thread slows the host enough to
        # idle the card; their CUDA runtime calls (launches, waits) come
        # from CUPTI, which sees every thread.
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def close(self) -> None:
        if self._prof is None or self.prof is not None:
            return
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.prof = self._prof


def _events(prof):
    """(name, kind, device_index, start_ns, end_ns) of every event, kind
    "device" for the card's activity, "host" for the host's and "other"
    for the host's annotations mirrored onto the card's timeline (such as
    c10d's ``nccl:*`` ranges), which are no activity of the card. A mirror
    carries the name of its host annotation, which no kernel or copy has
    (older torch has no ``activity_type`` to tell them apart)."""
    raw = [(e.name(), str(e.device_type()).endswith("CUDA"),
            e.device_index(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    host_names = {name for name, dev, *_ in raw if not dev}
    return [(name, ("other" if name in host_names else "device") if dev
             else "host", idx, start, start + dur)
            for name, dev, idx, start, dur in raw]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, device_index=None) -> Summary:
    """Reduce (name, kind, device_index, start_ns, end_ns) events to a
    :class:`Summary` of the ``perfbench.window`` span: only events inside
    it count, clipped to it."""
    spans = [(s, e) for name, kind, _i, s, e in events
             if name == WINDOW and kind == "host"]
    if not spans:
        raise RuntimeError("the profiled window has no perfbench.window span")
    w0, w1 = spans[0]
    dev, host, syncs = [], [], 0
    for name, kind, idx, s, e in events:
        if e <= w0 or s >= w1 or name.startswith("perfbench.") \
                or kind == "other":
            continue
        s, e = max(s, w0), min(e, w1)
        if kind == "device":
            if device_index is None or idx == device_index:
                dev.append((name, s, e))
        else:
            host.append((name, s, e))
            syncs += name in SYNCS
    busy = _union([(s, e) for _n, s, e in dev])
    by_name: dict = {}
    nccl = 0
    for name, s, e in dev:
        key = name[:120]
        by_name[key] = by_name.get(key, 0) + (e - s)
        if "nccl" in name.lower():
            nccl += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = []
    for g0, g1 in gaps:
        idle.append([_host_at(host, (g0 + g1) / 2), (g1 - g0) / 1e9])
    return Summary(
        busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(w1 - w0) / 1e9,
        syncs=syncs, nccl_s=nccl / 1e9,
        device_ops=[[n, t / 1e9] for n, t in ops], idle_gaps=idle)


def _host_at(host, t) -> str:
    """What the host was doing at ``t``: the innermost recorded operation
    or runtime call around it, else the last one that ended before it
    (the worker threads' Python between runtime calls is not recorded)."""
    inner = [(s, n) for n, s, e in host if s <= t <= e]
    if inner:
        return f"host in {max(inner)[1][:100]}"
    before = [(e, n) for n, s, e in host if e <= t]
    if before:
        return f"host after {max(before)[1][:100]}"
    return "no host op"


def summarize(prof, device_index=None) -> Summary:
    return reduce_events(_events(prof), device_index)
