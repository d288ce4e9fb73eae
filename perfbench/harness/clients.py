"""The closed-loop clients that drive the engine through the window.

Latency runs from the client's ``submit`` to the moment the client holds
the resolved answer. A request counts for the window when it resolves
inside it; clients stop submitting when the window closes and then wait
for what they have in flight, so counters read from the window's opening
to the last client's return cover exactly the requests submitted in it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from perfbench.harness.traffic import client_requests

__all__ = ["Done", "ClientLog", "daemon_window", "mesh_window",
           "RESULT_TIMEOUT_S"]

#: How long a client waits for one answer past anything the window asks.
RESULT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Done:
    req: object
    t_submit: float
    t_done: float
    submit_s: float       # time inside ``submit``
    token: object         # what the work count needs of the answer


@dataclasses.dataclass
class ClientLog:
    done: list = dataclasses.field(default_factory=list)   # every answer
    attempted: int = 0            # submitted in the window
    failed: int = 0               # raised, or never came
    errors: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)
    longest: Optional[tuple] = None   # (weight, req, kept)

    def finish(self, op, req, value, t0, t_sub, t1, w1, cap) -> None:
        """Log one answer; only answers inside the window are checked."""
        self.done.append(Done(req, t0, t1, t_sub - t0, op.token(value)))
        if t1 > w1:
            return
        if req.sampled and len(self.samples) < cap:
            self.samples.append((req, op.keep(value)))
        weight = op.weight(req)
        if self.longest is None or weight > self.longest[0]:
            self.longest = (weight, req, op.keep(value))


def _client(engine, op, mix, seed, client, start, clock, log) -> None:
    """One closed-loop client on its own thread, blocked on its future
    while a request is in flight."""
    start.wait()
    w1 = clock["w1"]
    cap = mix["sample_cap"]
    for req in client_requests(mix, seed, client):
        t0 = time.monotonic()
        if t0 >= w1:
            return
        fut = op.submit(engine, req)
        t_sub = time.monotonic()
        log.attempted += 1
        try:
            value = fut.result(timeout=RESULT_TIMEOUT_S)
        except Exception as exc:      # counted, reported, never raised here
            log.failed += 1
            log.errors.append(f"{type(exc).__name__}: {exc}")
            continue
        log.finish(op, req, value, t0, t_sub, time.monotonic(), w1, cap)


def daemon_window(engine, op, mix: dict, seed: int, seconds: float,
                  on_close=None) -> tuple:
    """Run ``mix["clients"]`` client threads against a started engine for
    ``seconds``. ``on_close()`` runs on this thread when the window closes,
    before the clients' last answers come in. Returns (logs, w0, w1)."""
    logs = [ClientLog() for _ in range(mix["clients"])]
    start = threading.Event()
    clock = {}
    threads = [threading.Thread(target=_client, name=f"client-{c}",
                                args=(engine, op, mix, seed, c, start, clock,
                                      logs[c]), daemon=True)
               for c in range(mix["clients"])]
    for t in threads:
        t.start()
    w0 = time.monotonic()
    clock["w1"] = w1 = w0 + seconds
    start.set()
    time.sleep(max(0.0, w1 - time.monotonic()))
    if on_close is not None:
        on_close()
    for t in threads:
        t.join(RESULT_TIMEOUT_S + seconds)
        if t.is_alive():
            raise RuntimeError(f"{t.name} still waiting {RESULT_TIMEOUT_S} s "
                               f"after the window closed")
    return logs, w0, w1


def mesh_window(engine, op, mix: dict, seed: int, seconds: float,
                device, on_close=None) -> tuple:
    """One client on this rank: each request a synchronous ``submit`` and
    ``flush`` (every rank the same requests in the same order; the caller
    has brought the ranks to a barrier just before). After each
    answer the ranks agree by an all-reduce whether the window has closed
    on any of them, so every rank stops after the same request;
    ``on_close()`` runs after that last request."""
    import torch.distributed as dist
    log = ClientLog()
    cap = mix["sample_cap"]
    stop = torch.zeros(1, dtype=torch.int32, device=device)
    w0 = time.monotonic()
    w1 = w0 + seconds
    for req in client_requests(mix, seed, 0):
        t0 = time.monotonic()
        op.submit(engine, req)
        t_sub = time.monotonic()
        log.attempted += 1
        value = engine.flush()[0]
        t1 = time.monotonic()
        log.finish(op, req, value, t0, t_sub, t1, w1, cap)
        stop.fill_(int(time.monotonic() >= w1))
        dist.all_reduce(stop, op=dist.ReduceOp.MAX)
        if stop.item():
            break
    if on_close is not None:
        on_close()
    return [log], w0, w1
