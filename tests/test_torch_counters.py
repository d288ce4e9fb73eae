"""The launch counters under threads.

The serving engine's stream workers launch kernels from several threads at
once, so ``LAUNCHES`` and ``last_launch`` of ``kernels/matmul.py`` and
``kernels/attention.py`` are updated under a lock: no count is lost,
``launch_counts()`` is a consistent snapshot, and ``last_launch_snapshot()``
is one whole launch, never empty between two. Every wait is bounded.
"""

import sys
import threading

import pytest
import torch

from repro_torch.kernels import attention_kernels as A
from repro_torch.kernels import matmul_kernels as K

THREADS = 8
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _switch_often():
    """Switch threads every microsecond, so an unlocked read-modify-write
    of a counter would lose updates within a few thousand calls."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(before)


def _hammer(work, per_thread):
    """Run ``work(t, i)`` ``per_thread`` times on each of THREADS threads,
    all released together."""
    barrier = threading.Barrier(THREADS)
    errors = []

    def body(t):
        try:
            barrier.wait(TIMEOUT)
            for i in range(per_thread):
                work(t, i)
        except BaseException as exc:          # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT)
        assert not th.is_alive()
    assert not errors, errors


class TestMatmulCounters:
    def test_exact_total_from_eight_threads(self):
        K.reset_launches()
        per_thread = 5000
        _hammer(lambda t, i: K._record("matmul", 32, 1), per_thread)
        assert K.launch_counts()["matmul"] == THREADS * per_thread

    def test_plain_launches_counted_exactly(self):
        """The wrappers themselves, on CPU tensors, from 8 threads."""
        K.reset_launches()
        a = torch.randn(64, 64)
        per_thread = 40

        def work(t, i):
            if t % 2:
                K.matmul_plain(a, a, block_m=32, block_n=32, block_k=32)
            else:
                K.square_plain(a, block_m=32, block_n=32, block_k=32)

        _hammer(work, per_thread)
        counts = K.launch_counts()
        half = THREADS // 2 * per_thread
        assert counts["plain_matmul"] == half
        assert sum(v for k, v in counts.items()
                   if k.startswith("plain_square")) == half

    def test_last_launch_never_read_empty(self):
        """Writers alternate records with different keys while a reader
        takes snapshots: each one holds ``kernel`` and is one launch."""
        K.reset_launches()
        K._record("matmul", 32, 1)
        stop = threading.Event()
        seen, torn = [], []

        def reader():
            while not stop.is_set():
                snap = K.last_launch_snapshot()
                seen.append("kernel" in snap)
                if seen[-1] and ("groups" in snap) != (snap["kernel"] ==
                                                       "square_whole"):
                    torn.append(snap)

        r = threading.Thread(target=reader)
        r.start()
        try:
            def work(t, i):
                if (t + i) % 2:
                    K._record("square_whole", 16, 4, groups=4)
                else:
                    K._record("matmul", 32, 1)

            _hammer(work, 2000)
        finally:
            stop.set()
            r.join(TIMEOUT)
        assert not r.is_alive()
        assert seen and all(seen)
        assert not torn, torn[:3]
        assert K.launch_counts()["matmul"] + \
            K.launch_counts()["square_whole"] == THREADS * 2000 + 1

    def test_reset_is_consistent(self):
        K._record("matmul", 32, 1)
        K.reset_launches()
        assert set(K.launch_counts().values()) == {0}


class TestAttentionCounters:
    def test_exact_total_from_eight_threads(self):
        A.reset_launches()
        q = torch.randn(2, 32, 16)
        per_thread = 25

        def work(t, i):
            A.flash_attention_plain(q, q, q, causal=True)
            A._count("flash_attention", block_q=32, block_k=32, tile=(32, 32),
                     splits=1, sq=32, skv=32, d=16, batch=2)

        _hammer(work, per_thread)
        counts = A.launch_counts()
        assert counts["plain_flash_attention"] == THREADS * per_thread
        assert counts["flash_attention"] == THREADS * per_thread
        assert A.last_launch_snapshot()["kernel"] == "flash_attention"

    @pytest.mark.parametrize("module", [K, A], ids=["matmul", "attention"])
    def test_snapshot_is_a_copy(self, module):
        snap = module.launch_counts()
        snap[next(iter(snap))] += 1000
        assert module.launch_counts() != snap
