"""``python -m repro_torch.launch.matserve``, the port's serving driver, on
the CPU (``--device cpu``): batch and daemon mode with ``--verify`` (every
answer held to a float64 per-matrix call under ``error_budget``), the
reference's flags, and the deliberate differences (the GPU by default,
markov and evolve traffic refused, ``--evolve-frac`` 0)."""

import json

import pytest
import torch

from repro_torch.launch import matserve
from repro_torch.serve.admission import ShedError

TIMEOUT = 60.0


def _run(capsys, *argv):
    rc = matserve.main(list(argv))
    return rc, capsys.readouterr().out


class TestBatchMode:
    def test_verify_passes_on_mixed_traffic(self, capsys):
        rc, out = _run(capsys, "--device", "cpu", "--requests", "24",
                       "--sizes", "16,96", "--powers", "7,12",
                       "--dtypes", "float32,bfloat16,float64", "--verify")
        assert rc == 0
        assert "0 outside error_budget" in out
        assert "'torch'" in out and "'chain'" in out

    def test_interpret_flag_means_the_cpu(self, capsys):
        rc, out = _run(capsys, "--interpret", "--requests", "4",
                       "--sizes", "8", "--powers", "3")
        assert rc == 0 and "device=cpu" in out

    def test_trace_export_is_json(self, capsys, tmp_path):
        path = tmp_path / "trace.json"
        rc, _ = _run(capsys, "--device", "cpu", "--requests", "6",
                     "--sizes", "8", "--powers", "3", "--trace", str(path))
        assert rc == 0
        events = json.loads(path.read_text())["traceEvents"]
        assert any(e.get("name") == "bucket.execute" for e in events)


class TestDaemonMode:
    def test_open_loop_with_lanes_and_verify(self, capsys):
        rc, out = _run(capsys, "--device", "cpu", "--daemon", "--rate",
                       "2000", "--requests", "32", "--sizes", "16,96",
                       "--powers", "7", "--priority-frac", "0.25",
                       "--verify")
        assert rc == 0
        assert "shed=0" in out and "0 outside error_budget" in out
        assert "lane latency" in out and "lane bulk" in out

    def test_shedding_is_reported_not_raised(self, capsys):
        rc, out = _run(capsys, "--device", "cpu", "--daemon", "--rate",
                       "100000", "--requests", "24", "--sizes", "8",
                       "--powers", "3", "--capacity", "bulk=2",
                       "--max-delay-ms", "50", "--verify")
        assert rc == 0
        shed = int(out.split("shed=")[1].split()[0])
        assert 0 < shed < 24

    def test_run_open_loop_needs_a_started_engine(self):
        from repro_torch.serve.matfn import MatFnEngine
        with pytest.raises(RuntimeError, match="started"):
            matserve.run_open_loop(MatFnEngine(device="cpu"), [], 1.0)


class TestVerify:
    def test_a_wrong_answer_is_a_miss(self):
        work = matserve.make_workload(3, [16], [7], 0.0, seed=1)
        good = [torch.linalg.matrix_power(a, 7) for _, a, _ in work]
        assert matserve.verify(work, good)[1] == 0
        bad = list(good)
        bad[1] = torch.linalg.matrix_power(work[1][1], 6)
        assert matserve.verify(work, bad)[1] == 1

    def test_shed_requests_are_skipped(self):
        work = matserve.make_workload(2, [8], [3], 0.0, seed=2)
        shed = ShedError("bulk", 1, 1, "reject-newest", ("matpow", 8,
                                                         "float32", 3))
        results = [torch.linalg.matrix_power(work[0][1], 3), shed]
        assert matserve.verify(work, results) == (
            matserve.verify(work[:1], results[:1])[0], 0)


class TestDifferencesFromTheReference:
    def test_the_gpu_is_the_default(self, capsys):
        if torch.cuda.device_count():
            pytest.skip("this machine has a GPU")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            matserve.main(["--requests", "2", "--sizes", "8"])

    def test_markov_traffic_is_refused(self, capsys):
        with pytest.raises(SystemExit) as ei:
            matserve.main(["--device", "cpu", "--markov-frac", "0.5"])
        assert ei.value.code == 2
        assert "item 5" in capsys.readouterr().err

    @pytest.mark.parametrize("flag", [["--evolve-frac", "0.5"],
                                      ["--evolve-batch", "4"]],
                             ids=["evolve-frac", "evolve-batch"])
    def test_evolve_settings_are_refused(self, capsys, flag):
        """Evolve traffic is markov traffic: its settings are refused too."""
        with pytest.raises(SystemExit) as ei:
            matserve.main(["--device", "cpu", *flag])
        assert ei.value.code == 2
        assert "item 5" in capsys.readouterr().err

    def test_defaults(self):
        args = matserve.parser().parse_args([])
        assert args.device == "cuda"
        assert args.evolve_frac == 0.0 and args.markov_frac == 0.0
        assert (args.requests, args.sizes, args.powers, args.expm_frac) == \
            (64, "8,16,32", "2,7,12", 0.25)

    def test_unknown_dtype_is_an_error(self, capsys):
        with pytest.raises(SystemExit):
            matserve.main(["--device", "cpu", "--dtypes", "int8"])
