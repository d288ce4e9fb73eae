"""The dry run (``repro_torch.analysis`` and ``launch/dryrun.py``) against
the reference's ``analysis/roofline.py``, ``summarize.py`` and
``launch/dryrun.py``, on the CPU.

* ``model_flops``, ``RooflineReport``, ``parse_collectives`` and the three
  ``summarize`` tables give what the reference's give, exactly.
* The op counter (``analysis.op_cost``): a ``dense_matmul`` and its
  backward are 3 x 2mnk, with ``FlopCounterMode`` too (the formula
  ``kernels/ops.py`` registers for ``repro_torch::dense_mm``); a product's
  bytes are its inputs and output; a Shard -> Replicate redistribute on a
  fake mesh is one all-gather at result (g-1)/g, over the network when its
  ranks span nodes; the fused-attention model charges the attention core
  its inputs and output only.
* A Qwen3 smoke train step counted on meta DTensors on a fake one-rank
  group has the FLOPs ``FlopCounterMode`` counts over the same step on
  real CPU tensors; counts extrapolated from depths 4 and 6 equal a direct
  count at depth 8 (peak live bytes within 5 %).
* Every (smoke arch x shape) cell ends OK on a fake 2x2 mesh, or SKIP
  exactly where the reference's ``shape_applicable`` says so, with its
  reason. The cells run in child processes (``_torch_dryrun_children.py``)
  started together when this module starts.

``repro.launch.dryrun`` is never imported here: its first lines set
``XLA_FLAGS`` to 512 host devices for every later JAX test of the process.
Its ``choose_accum`` is asked in a subprocess. Each fake process group is
made and destroyed inside one test.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as jroofline
from repro.analysis import summarize as jsummarize
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import shape_applicable as jshape_applicable

from repro_torch.analysis import op_cost, roofline, summarize
from repro_torch.configs import ARCH_NAMES, SHAPES, ShapeSpec, get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import init_params, layers
from repro_torch.train.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent
CHILDREN = Path(__file__).resolve().parent / "_torch_dryrun_children.py"
N_CHILDREN = 4
CHILD_TIMEOUT = 300      # backstop; the children take about a minute
CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]
#: A train and a decode step small enough to count several times here.
TINY_TRAIN = ShapeSpec("tiny_train", 64, 4, "train")
TINY_DECODE = ShapeSpec("tiny_decode", 64, 4, "decode")


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model")[-len(shape):] if len(shape) < 3 else \
        ("pod", "data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=names)


def reference_reason(arch, shape, smoke=False) -> tuple:
    """The reference's ``shape_applicable``; its reason without the
    pointer to a design document this repository does not have (the
    port's reason leaves it out)."""
    ok, why = jshape_applicable(jget(arch, smoke=smoke), JSHAPES[shape])
    return ok, why.replace(" (DESIGN.md §7)", "")


# ---------------------------------------------------------------------------
# The smoke cells' children, started when the module starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def cell_children(tmp_path_factory):
    """The children running every (smoke arch x shape) cell, the long
    prefill cells spread over them first; killed if a test leaves them
    running."""
    out = tmp_path_factory.mktemp("dryrun_cells")
    order = sorted(CELLS, key=lambda c: (SHAPES[c[1]].kind != "prefill",
                                         SHAPES[c[1]].kind != "train"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(CHILDREN), str(out)]
        + [f"{a}:{s}" for a, s in order[i::N_CHILDREN]], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N_CHILDREN)]
    try:
        yield out, procs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# ---------------------------------------------------------------------------
# roofline and summarize against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_the_reference(arch, shape):
    assert roofline.model_flops(get_config(arch), SHAPES[shape]) == \
        jroofline.model_flops(jget(arch), JSHAPES[shape])


def test_roofline_report_has_the_reference_fields():
    names = [f.name for f in dataclasses.fields(roofline.RooflineReport)]
    assert names == [f.name
                     for f in dataclasses.fields(jroofline.RooflineReport)]


def test_hardware_constants_are_the_h100s():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "nvlink_bw": 450e9, "network_bw": 50e9,
                           "gpus_per_node": 8}


#: Every collective kind, tuple results, both replica_groups forms, and a
#: group of one (no traffic).
HLO = """\
ENTRY %main {
  %ag = f32[8,128]{1,0} all-gather(f32[2,128]{1,0} %p0), replica_groups=[2,4]<=[8], dimensions={0}
  %ags = (f32[2,128]{1,0}, f32[8,128]{1,0}) all-gather-start(f32[2,128]{1,0} %p0), replica_groups=[2,4]<=[8], dimensions={0}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %p1), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %ars = (f32[64]{0}, f32[64]{0}) all-reduce-start(f32[64]{0} %p5), replica_groups={{0,1}}, to_apply=%add
  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %p2), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %a2a = f32[64,32]{1,0} all-to-all(f32[64,32]{1,0} %p3), replica_groups=[1,8]<=[8], dimensions={0}
  %cp = f32[16]{0} collective-permute(f32[16]{0} %p4), source_target_pairs={{0,1},{1,0}}
  %one = f32[4]{0} all-reduce(f32[4]{0} %p6), replica_groups={{0}}, to_apply=%add
}
"""


def test_parse_collectives_matches_the_reference():
    got = roofline.parse_collectives(HLO, 8)
    assert got == jroofline.parse_collectives(HLO, 8)
    assert set(got) == {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all", "collective-permute"}


def _record(arch, shape, mesh, status="OK", scale=1.0, port=False):
    if status == "SKIP":
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "SKIP", "reason": "too long; no"}
    if status == "FAIL":
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "FAIL", "error": "ValueError: x"}
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "OK",
           "compute_s": 0.0123 * scale, "memory_s": 0.0456 * scale,
           "collective_s": 0.0078 * scale, "dominant": "memory",
           "useful_ratio": 0.61, "collective_bytes": 3.0e9 * scale}
    if port:
        rec.update(live_bytes_per_device=int(70e9 * scale),
                   fits_80gb=scale < 1.2)
    else:
        rec.update(live_bytes_tpu=int(12e9 * scale),
                   live_bytes_per_device=int(13e9 * scale),
                   fits_16gb=scale < 1.2)
    return rec


@pytest.fixture
def records(tmp_path):
    """Hand-made records: OK, SKIP and FAIL; single and multi; a cell
    with two variants."""
    cells = {
        "qwen3-1.7b__train_4k__single": _record("qwen3-1.7b", "train_4k",
                                                "single"),
        "qwen3-1.7b__train_4k__multi": _record("qwen3-1.7b", "train_4k",
                                               "multi", scale=1.5),
        "qwen3-1.7b__train_4k__single__dots": _record(
            "qwen3-1.7b", "train_4k", "single", scale=0.7),
        "qwen3-1.7b__long_500k__single": _record("qwen3-1.7b", "long_500k",
                                                 "single", "SKIP"),
        "grok-1-314b__prefill_32k__single": _record(
            "grok-1-314b", "prefill_32k", "single", "FAIL"),
        "grok-1-314b__prefill_32k__multi": _record(
            "grok-1-314b", "prefill_32k", "multi", scale=2.0),
    }
    for name, rec in cells.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    return tmp_path


def test_summarize_tables_match_the_reference(records):
    mine, ref = summarize.load(records), jsummarize.load(records)
    assert mine == ref
    for mesh in ("single", "multi"):
        assert summarize.roofline_table(mine, mesh) == \
            jsummarize.roofline_table(ref, mesh)
    assert summarize.roofline_table(mine, "single", "dots") == \
        jsummarize.roofline_table(ref, "single", "dots")
    assert summarize.multi_pod_table(mine) == jsummarize.multi_pod_table(ref)
    assert summarize.variants_table(mine, "qwen3-1.7b", "train_4k") == \
        jsummarize.variants_table(ref, "qwen3-1.7b", "train_4k")
    assert "| dots |" in summarize.variants_table(mine, "qwen3-1.7b",
                                                  "train_4k")


def test_summarize_renders_a_port_record(tmp_path):
    for scale, name in ((1.0, "a"), (1.5, "b")):
        (tmp_path / f"{name}__train_4k__single.json").write_text(json.dumps(
            _record(name, "train_4k", "single", scale=scale, port=True)))
    table = summarize.roofline_table(summarize.load(tmp_path))
    assert "| a | train_4k | memo | 12.3 | 45.6 | 7.8 | 0.27 | 0.61 | " \
           "65.2 | Y |" in table
    assert table.endswith("| 97.8 | N |")


def test_choose_accum_matches_the_reference():
    grid = [(b, dp, want) for b in (1, 32, 128, 256) for dp in (1, 16, 32)
            for want in (1, 4, 8, 16)]
    code = ("import json, sys\nfrom repro.launch.dryrun import choose_accum"
            "\ngrid = json.loads(sys.argv[1])\n"
            "print(json.dumps([choose_accum(*g) for g in grid]))\n")
    done = subprocess.run(
        [sys.executable, "-c", code, json.dumps(grid)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    want = json.loads(done.stdout.strip().splitlines()[-1])
    assert [dryrun.choose_accum(*g) for g in grid] == want


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------

M, K, N = 64, 128, 256


def test_a_dense_matmul_and_its_backward_count_three_products():
    x = torch.randn(M, K, requires_grad=True)
    w = torch.randn(K, N, requires_grad=True)
    with op_cost.OpCounter() as c:
        ops.dense_matmul(x, w).sum().backward()
    with FlopCounterMode(display=False) as fc:
        ops.dense_matmul(x, w).sum().backward()
    assert c.flops == fc.get_total_flops() == 3 * 2 * M * N * K
    assert c.dense_mm_calls == 3


def test_a_loop_of_products_counts_each():
    x = torch.empty(M, K, device="meta")
    w = torch.empty(K, N, device="meta")
    with op_cost.OpCounter() as c:
        for _ in range(8):
            ops.DENSE_MM_OP(x, w, "")
    assert c.flops == 8 * 2 * M * N * K and c.dense_mm_calls == 8
    assert c.bytes == 8 * 4 * (M * K + K * N + M * N)


def test_a_products_bytes_are_its_inputs_and_output():
    x = torch.empty(M, K, device="meta", dtype=torch.bfloat16)
    w = torch.empty(K, N, device="meta", dtype=torch.bfloat16)
    cost = op_cost.count(lambda a, b: torch.mm(a, b), x, w)
    assert cost.bytes == 2 * (M * K + K * N + M * N)
    assert cost.flops == 2 * M * N * K
    assert cost.peak_bytes == 2 * (M * K + K * N + M * N)


@pytest.mark.parametrize("ranks,spans", [(4, False), (16, True)])
def test_a_redistribute_is_one_all_gather(ranks, spans):
    """Shard(0) -> Replicate over ``ranks`` fake ranks: one all-gather of
    (g-1)/g of its result, over the network when the group spans more
    than one 8-GPU node."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_group(ranks):
        mesh = _mesh((ranks,))
        a = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        cost = op_cost.count(
            lambda t: t.redistribute(mesh, [Replicate()]), a)
    result = 4 * ranks * 8 * 4
    wire = result * (ranks - 1) / ranks
    assert cost.collectives == {"all-gather": {
        "count": 1, "bytes": wire,
        "network_bytes": wire if spans else 0.0}}
    assert cost.collective_bytes == wire


def test_the_fused_attention_model_charges_the_core_its_operands():
    """With the marker the attention core costs its inputs and output;
    without it every op of its chunk scan is charged; the FLOPs are the
    same. The scope hook is cleared when the counter exits."""
    q = torch.empty(2, 256, 2, 2, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 256, 2, 64, device="meta", dtype=torch.bfloat16)

    def core(q, k, v):
        return layers._online_chunk_attention(
            q, k, v, causal=True, q_offset=0, q_chunk=64, kv_chunk=128)
    plain = op_cost.count(core, q, k, k)
    fused = op_cost.count(core, q, k, k,
                          fused_markers=op_cost.FUSED_ATTENTION_MARKERS)
    assert layers._SCOPE_HOOK is None
    assert fused.flops == plain.flops > 0
    assert fused.bytes == 2 * (2 * q.numel() + 2 * k.numel())
    assert plain.bytes > 10 * fused.bytes


def test_roofline_terms_from_a_cost():
    cost = op_cost.OpCost(
        flops=989 * 10**9, bytes=335 * 10**7, peak_bytes=1, dense_mm_calls=2,
        collectives={"all-reduce": {"count": 1, "bytes": 9.5e8,
                                    "network_bytes": 5e8}},
        depth=4, depths=(1, 2))
    cfg, shape = get_config("qwen3-1.7b"), SHAPES["train_4k"]
    rep = roofline.analyze(arch="qwen3-1.7b", shape_name="train_4k",
                           mesh_name="single", n_devices=256, cost=cost,
                           cfg=cfg, shape=shape)
    assert rep.compute_s == pytest.approx(1e-3)
    assert rep.memory_s == pytest.approx(1e-3)
    assert rep.collective_s == pytest.approx(4.5e8 / 450e9 + 5e8 / 50e9)
    assert rep.dominant == "collective"
    assert rep.useful_ratio == pytest.approx(
        roofline.model_flops(cfg, shape) / (989e9 * 256))
    assert rep.memory_stats["traced_depths"] == [1, 2]


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke_configs(monkeypatch):
    """The dry run builds each arch's smoke config."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda name: get_config(name, smoke=True))


def test_a_meta_step_counts_the_flops_of_a_real_one(smoke_configs):
    """Qwen3 smoke: the dry run's train cell on meta DTensors on a fake
    one-rank group, against ``FlopCounterMode`` over ``make_train_step``
    on real CPU tensors: the same products, the same FLOPs."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    with dryrun.fake_group(1):
        cost, _, _ = dryrun.count_cell("qwen3-1.7b", TINY_TRAIN,
                                       _mesh((1, 1)))
    state = init_train_state(cfg, init_params(cfg, torch.Generator("cpu")
                                              .manual_seed(0)))
    batch = make_batch(cfg, step=0, seed=1, batch=TINY_TRAIN.global_batch,
                       seq=TINY_TRAIN.seq_len, device="cpu")
    step = make_train_step(cfg, accum=1)
    with op_cost.OpCounter() as c, FlopCounterMode(display=False) as fc:
        c.track((state, batch))
        step(state, batch)
    assert cost.flops == fc.get_total_flops() == c.flops > 0
    assert cost.dense_mm_calls == c.dense_mm_calls > 0


@pytest.mark.parametrize("arch,shape,overrides", [
    ("qwen3-1.7b", TINY_TRAIN, {"n_layers": 8}),
    ("qwen3-1.7b", TINY_DECODE, {"n_layers": 8}),
    ("zamba2-1.2b", TINY_TRAIN, {"n_pattern_repeats": 8, "n_layers": 26}),
], ids=["qwen3-train", "qwen3-decode", "zamba2-train"])
def test_extrapolation_equals_a_direct_count(arch, shape, overrides,
                                             smoke_configs):
    """Depth 8 (zamba2: eight repeats of its pattern) on a fake 2x2 mesh:
    counted at the depths ``TRACED`` and extrapolated, and counted
    whole."""
    with dryrun.fake_group(4):
        mesh = _mesh((2, 2))
        got, _, _ = dryrun.count_cell(arch, shape, mesh,
                                      overrides=overrides)
        fn, args, _, _ = dryrun.build_cell(arch, shape, mesh,
                                           overrides=overrides)
        want = op_cost.count(fn, *args)
    assert got.depths == dryrun.TRACED and got.depth == 8
    assert (got.flops, got.bytes, got.dense_mm_calls) == \
        (want.flops, want.bytes, want.dense_mm_calls)
    assert got.collectives == want.collectives and want.collectives
    assert abs(got.peak_bytes - want.peak_bytes) <= 0.05 * want.peak_bytes


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_the_cli_records_ok_skip_and_fail(tmp_path, capsys):
    """``main``: OK and SKIP cells exit 0 and write their records (the
    port's ``fits_80gb``); ``--skip-existing`` leaves them; a cell that
    raises is recorded as FAIL with its traceback and the run exits 1."""
    out = str(tmp_path)
    rc = dryrun.main(["--arch", "mamba2-130m,qwen3-1.7b", "--shape",
                      "long_500k", "--mesh", "single", "--out", out])
    assert rc == 0
    ok = json.loads((tmp_path / "mamba2-130m__long_500k__single.json")
                    .read_text())
    assert ok["status"] == "OK" and ok["fits_80gb"] and ok["n_devices"] == 256
    assert ok["depths"] == list(dryrun.TRACED)
    skip = json.loads((tmp_path / "qwen3-1.7b__long_500k__single.json")
                      .read_text())
    assert skip["status"] == "SKIP"
    assert skip["reason"] == reference_reason("qwen3-1.7b", "long_500k")[1]
    mtime = (tmp_path / "mamba2-130m__long_500k__single.json").stat().st_mtime
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                        "--mesh", "single", "--out", out,
                        "--skip-existing"]) == 0
    assert (tmp_path / "mamba2-130m__long_500k__single.json").stat() \
        .st_mtime == mtime
    rc = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", out, "--override",
                      "n_kv_heads=3", "--variant", "bad"])
    assert rc == 1
    bad = json.loads((tmp_path / "qwen3-1.7b__decode_32k__single__bad.json")
                     .read_text())
    assert bad["status"] == "FAIL" and "n_kv_heads" in bad["traceback"]
    assert "1 FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The smoke cells (last: the children run while the tests above do)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cell_records(cell_children):
    out, procs = cell_children
    for proc in procs:
        log = proc.communicate(timeout=CHILD_TIMEOUT)[0]
        assert proc.returncode == 0, log
    return {(a, s): json.loads((out / f"{a}__{s}__2x2.json").read_text())
            for a, s in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_smoke_cell_runs_on_a_2x2_mesh(cell_records, arch, shape):
    rec = cell_records[(arch, shape)]
    ok, why = reference_reason(arch, shape)
    if not ok:
        assert rec["status"] == "SKIP" and rec["reason"] == why
        return
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["n_devices"] == 4
    for k in ("compute_s", "memory_s", "collective_s", "useful_ratio"):
        assert np.isfinite(rec[k]) and rec[k] >= 0, k
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["live_bytes_per_device"] > 0 and rec["fits_80gb"]
    assert rec["memory_stats"]["dense_mm_calls"] > 0
