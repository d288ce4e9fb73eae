"""The one traffic generator: every mix is a data file it reads.

A mix (``traffic/<name>.json``) gives:

``clients``
    closed-loop clients; each sends its next request when its last one
    resolves.
``mode``
    ``"daemon"``: the clients submit to one started engine and wait on
    their futures; ``"mesh"``: one client on every rank of the mesh,
    each request a synchronous ``submit`` + ``flush``, the same requests
    in the same order on every rank.
``sizes``
    the matrix sizes, taken in equal shares.
``powers``
    the matpow powers, taken in equal shares (absent for an op that takes
    none).
``pool``
    operands made per size, taken in equal shares.
``sample``, ``sample_cap``
    the share of requests whose answers are checked against the
    reference, and the most a client keeps.
``assumed``
    where each number above comes from, and what it costs the cell; not
    read here.

Each client draws from its own stream of the seed. Sizes, powers and
operands are taken in cycles, each cycle a fresh permutation of the whole
set, so every seed asks for the same work in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["Request", "client_requests", "seed_words"]


@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int
    n: int
    power: Optional[int]
    operand: int          # index into the pool of operands of size n
    sampled: bool


def seed_words(seed: int) -> list:
    """A seed of any size as 32-bit words for numpy's ``SeedSequence``."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def _cycles(rng, values) -> Iterator:
    values = list(values)
    while True:
        for i in rng.permutation(len(values)):
            yield values[i]


def client_requests(mix: dict, seed: int, client: int) -> Iterator[Request]:
    """The endless request stream of one client under one seed."""
    rng = np.random.default_rng(seed_words(seed) + [client])
    sizes = _cycles(rng, mix["sizes"])
    powers = _cycles(rng, mix["powers"]) if "powers" in mix else None
    pool = _cycles(rng, range(mix["pool"]))
    index = 0
    while True:
        yield Request(client, index, int(next(sizes)),
                      None if powers is None else int(next(powers)),
                      int(next(pool)), bool(rng.random() < mix["sample"]))
        index += 1
