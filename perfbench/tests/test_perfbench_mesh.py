"""The four-chip cell rehearsed on four ``gloo`` ranks of the CPU, at n =
64 on a 2 x 2 mesh (the sharded route, Cannon's schedule): sound, it is
correct; with the exchange between ranks left out, or a squaring that
returns its state unchanged, it is not; with a module of JAX loaded on a
rank other than 0 only, rank 0 prints no result."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec

CHILD = r"""
import json, os, sys, time, types
t0 = time.perf_counter()
sys.path[:0] = [{root!r}, {root!r} + "/src", {tests!r}]
rank, rdzv, fault = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = f"{{sys.argv[4]}}/tune{{rank}}.json"
from repro_torch.kernels import autotune
autotune.record_dispatch_thresholds(16, 32, backend="cpu")
if fault == "exchange":
    from repro_torch.core import distributed
    distributed._exchange = lambda pairs: [blk for blk, _to, _frm in pairs]
elif fault == "unchanged_state":
    from repro_torch.core.distributed import ShardedMatmulChain
    ShardedMatmulChain.square = lambda self, x: x
elif fault == "jax_on_rank1" and rank == 1:
    sys.modules["jax"] = types.ModuleType("jax")
from _small import small_cell
from perfbench.harness import cell as cell_run, mesh
from perfbench.run import report
cell = small_cell("matpow-f32-2x2.solo")
res = mesh.session(rank, 4, rdzv, cell.config["mesh"],
                   lambda m, dev: cell_run.run(cell, 9_876_543_210_123, 1.0,
                                               False, dev, t0, mesh=m,
                                               rank=rank, world=4),
                   device_type="cpu")
if rank == 0:
    sys.exit(report(res))
"""


def _ranks(fault: str, tmp_path) -> list:
    """(returncode, stdout, stderr) of each of the four ranks."""
    code = CHILD.format(root=str(spec.ROOT), tests=str(spec.HERE / "tests"))
    rdzv = f"file://{tmp_path}/rdzv"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), rdzv,
                               fault, str(tmp_path)], cwd=spec.ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("fault", ["none", "exchange", "unchanged_state"])
def test_mesh_rehearsal(fault, tmp_path):
    ranks = _ranks(fault, tmp_path)
    for rc, _o, err in ranks:
        assert rc == 0, err[-3000:]
    res = json.loads(ranks[0][1].strip().splitlines()[-1])
    assert res["device"]["count"] == 4
    assert "forbidden_elsewhere" not in res
    if fault == "none":
        assert res["correct"] is True, res["checks"]
        assert res["metrics"]["requests_per_s"]["value"] > 0
    else:
        assert res["correct"] is False


def test_a_forbidden_module_on_another_rank_stops_the_result(tmp_path):
    ranks = _ranks("jax_on_rank1", tmp_path)
    for rc, _o, err in ranks[1:]:
        assert rc == 0, err[-3000:]
    rc, out, err = ranks[0]
    assert rc != 0
    assert out.strip() == ""
    assert "rank 1: ['jax']" in err, err[-3000:]
