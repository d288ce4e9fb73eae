"""A run of each one-chip cell, cut to a CPU size, through
``MatFnEngine(device="cpu")``: sound, it comes out correct with every
metric named; with the timed path broken underneath, not correct. The
command itself, without a card, prints no result and fails."""

import json
import subprocess
import sys

import pytest
import torch

from _small import ONE_CHIP, run_small, tune_for_cpu
from perfbench.harness import spec

BENCH = spec.load_bench()


@pytest.fixture
def cpu_tuning(monkeypatch, tmp_path):
    tune_for_cpu(monkeypatch, tmp_path)


def _names(cell, kind):
    c = spec.load_cell(cell, BENCH)
    return {m["name"] for m in (c.end_to_end if kind == "e2e"
                                else c.per_layer)}


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_rehearsal_is_correct(cell, traced, cpu_tuning):
    res = run_small(cell, traced)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    got = set(res["metrics"])
    if not traced:
        assert got == _names(cell, "e2e")
    else:
        # No card: the device's shares have nothing to read.
        assert got <= _names(cell, "layer")
        assert "launches_per_request" in got
        assert ("squarings_per_request" in got) == (cell == "markov-f64.ncd")
        assert "matmul_roofline" not in got
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]


def _unchanged_state(monkeypatch):
    from repro_torch.core.distributed import ShardedMatmulChain
    from repro_torch.kernels.ops import MatmulChain
    monkeypatch.setattr(MatmulChain, "square", lambda self, x: x)
    monkeypatch.setattr(ShardedMatmulChain, "square", lambda self, x: x)


def _half_batch(monkeypatch):
    from repro_torch.serve import matfn
    real_pow, real_steady = matfn.batched_matpow, matfn._steady_members

    # The first b // 2 members are served; the others get the operand
    # back (matpow) or the last served member's answer (markov; with none
    # served, the chain's own row mean).
    def half_pow(a, p, **kw):
        h = a.shape[0] // 2
        return torch.cat([real_pow(a[:h], p, **kw), a[h:]]) if h else a

    def half_steady(x, backend):
        h = x.shape[0] // 2
        got = real_steady(x[:h], backend) if h else []
        rest = got[-1:] or real_steady(x[:1], backend)
        if not got:
            rest = [rest[0]._replace(pi=x[0].mean(dim=0))]
        return got + rest * (x.shape[0] - h)

    monkeypatch.setattr(matfn, "batched_matpow", half_pow)
    monkeypatch.setattr(matfn, "_steady_members", half_steady)


def _altered_answer(monkeypatch):
    from repro_torch.serve import matfn
    real_pow, real_steady = matfn.batched_matpow, matfn._steady_members

    def bent_pow(a, p, **kw):
        out = real_pow(a, p, **kw)
        out[:, 0, 0] += 0.25 * out.abs().amax()
        return out

    def bent_steady(x, backend):
        out = real_steady(x, backend)
        return [r._replace(pi=r.pi + 0.25 * r.pi.max() * (
            torch.arange(r.pi.numel()) == 0).to(r.pi.dtype)) for r in out]

    monkeypatch.setattr(matfn, "batched_matpow", bent_pow)
    monkeypatch.setattr(matfn, "_steady_members", bent_steady)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_a_broken_timed_path_is_not_correct(cell, fault, cpu_tuning,
                                            monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_small(cell)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if not c.get("at_least"))


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "matpow-f32.large", "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_the_result_line_is_one_json_object(cpu_tuning):
    res = run_small("matpow-f32.large")
    line = json.dumps(res)
    assert "\n" not in line
    back = json.loads(line)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(back)
    assert set(back["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
