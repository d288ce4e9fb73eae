"""Deterministic synthetic token pipeline — shard-disjoint, resumable.

The port of the reference's ``data/synthetic.py``. The generator is
counter-based: each batch is drawn from a ``torch.Generator`` seeded from
(seed, step, host) alone, so

  * any host can compute its shard for any step without coordination;
  * restoring ``step`` resumes the exact stream;
  * elastic restarts with a different host count re-partition cleanly.

The stream is a Zipf-ish unigram mix (``u**4``) with short-range repetition
structure (each token copies the one ``lag`` back with p = 0.5), so
cross-entropy actually falls; tokens lie in [3, V), targets are the tokens
shifted by one. The draws are PyTorch's, so the tokens are not the
reference's (as ``init_params``'s weights are not); the properties are.
Batches are made on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import default_device

__all__ = ["SyntheticStream", "make_batch"]


def _seed(seed: int, step: int, host: int) -> int:
    """A 63-bit generator seed from (seed, step, host): numpy's
    ``SeedSequence`` hash of the three counters."""
    state = np.random.SeedSequence([seed, step, host]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_batch(cfg, *, step: int, seed: int = 0, host: int = 0,
               n_hosts: int = 1, batch: int = 8, seq: int = 128,
               device=None):
    """One (tokens, targets) host-shard batch for ``step``. Pure function:
    int32 tensors of shape (batch // n_hosts, seq) on ``device``."""
    dev = default_device(device)
    gen = torch.Generator(dev).manual_seed(_seed(seed, step, host))
    b = batch // n_hosts
    v = cfg.vocab_size
    # Zipf-ish marginals via a uniform to the fourth power
    u = torch.rand((b, seq + 1), generator=gen, device=dev)
    base = (u ** 4 * (v - 3)).to(torch.int32) + 3
    # repetition structure: with p=0.5 copy the token from `lag` back
    lag = torch.randint(1, 64, (b, 1), generator=gen, device=dev)
    idx = torch.arange(seq + 1, device=dev)[None, :]
    src = torch.clamp(idx - lag, 0, seq)
    copy = torch.gather(base, 1, src)
    mask = torch.rand((b, seq + 1), generator=gen, device=dev) < 0.5
    toks = torch.where(mask & (idx >= lag), copy, base)
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


class SyntheticStream:
    """Stateful iterator wrapper with checkpointable position."""

    def __init__(self, cfg, *, seed: int = 0, host: int = 0,
                 n_hosts: int = 1, batch: int = 8, seq: int = 128,
                 start_step: int = 0, device=None):
        self.cfg = cfg
        self.seed, self.host, self.n_hosts = seed, host, n_hosts
        self.batch, self.seq = batch, seq
        self.step = start_step
        self.device = default_device(device)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        out = make_batch(self.cfg, step=self.step, seed=self.seed,
                         host=self.host, n_hosts=self.n_hosts,
                         batch=self.batch, seq=self.seq, device=self.device)
        self.step += 1
        return out

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: dict):
        self.step = int(st["step"])
        self.seed = int(st["seed"])
