"""``python -m repro_torch.launch.matserve``, the port's serving driver, on
the CPU (``--device cpu``): batch and daemon mode with ``--verify`` (every
answer held to a float64 per-matrix call under ``error_budget``), markov
steady-state and evolve traffic, the reference's flags and defaults, and the
deliberate differences (the GPU by default, ``--verify`` exits 1 on a
miss)."""

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
        work = matserve.make_workload(3, [16], [7], 0.0, seed=1,
                                      device="cpu")
        good = [torch.linalg.matrix_power(a, 7) for _, a, _ in work]
        assert matserve.verify(work, good)[1] == 0
        bad = list(good)
        bad[1] = torch.linalg.matrix_power(work[1][1], 6)
        assert matserve.verify(work, bad)[1] == 1

    def test_shed_requests_are_skipped(self):
        work = matserve.make_workload(2, [8], [3], 0.0, seed=2,
                                      device="cpu")
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

    def test_make_workload_defaults_to_the_gpu(self):
        """Like every entry point, the workload's operands go to the card
        unless the caller names a device, and there is no quiet CPU
        default when there is no card."""
        if torch.cuda.device_count():
            work = matserve.make_workload(2, [8], [3], 0.0, seed=4)
            assert all(a.device.type == "cuda" for _, a, _ in work)
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                matserve.make_workload(2, [8], [3], 0.0, seed=4)

    @pytest.mark.parametrize("daemon", [[], ["--daemon", "--rate", "2000"]],
                             ids=["batch", "daemon"])
    def test_markov_traffic_is_served(self, capsys, daemon):
        """Markov traffic, steady state and evolve, through the engine's
        torch / chain / evolve routes, every answer verified."""
        rc, out = _run(capsys, "--device", "cpu", *daemon, "--requests",
                       "24", "--sizes", "16,96", "--powers", "7,12",
                       "--dtypes", "float32,float64", "--markov-frac", "0.5",
                       "--verify")
        assert rc == 0 and "0 outside error_budget" in out
        routes = out.split("routes=")[1].split("}")[0]
        assert "'evolve': 0" not in routes and "'evolve'" in routes

    @pytest.mark.parametrize("flag", [["--evolve-frac", "1.0"],
                                      ["--evolve-batch", "3"]],
                             ids=["evolve-frac", "evolve-batch"])
    def test_evolve_settings_shape_the_traffic(self, capsys, flag):
        """``--evolve-frac`` is the evolve share of the markov requests,
        ``--evolve-batch`` the distributions of each; served and verified."""
        args = matserve.parser().parse_args(["--markov-frac", "1.0", *flag])
        work = matserve.make_workload(12, [8, 16], [3, 5], 0.0, seed=3,
                                      device="cpu",
                                      markov_frac=1.0,
                                      evolve_frac=args.evolve_frac,
                                      evolve_batch=args.evolve_batch)
        evolve = [rest[0] for op, a, p, *rest in work if rest]
        assert all(op == "markov" for op, *_ in work)
        if flag[0] == "--evolve-frac":
            assert len(evolve) == len(work)
        assert evolve and all(d.shape == (args.evolve_batch, d.shape[1])
                              for d in evolve)
        rc, out = _run(capsys, "--device", "cpu", "--requests", "12",
                       "--sizes", "8,16", "--powers", "3,5",
                       "--markov-frac", "1.0", *flag, "--verify")
        assert rc == 0 and "0 outside error_budget" in out

    def test_defaults(self):
        """The reference's defaults, the device aside."""
        args = matserve.parser().parse_args([])
        assert args.device == "cuda"
        assert args.markov_frac == 0.0
        assert (args.evolve_frac, args.evolve_batch) == (0.5, 4)
        assert (args.requests, args.sizes, args.powers, args.expm_frac) == \
            (64, "8,16,32", "2,7,12", 0.25)

    def test_unknown_dtype_is_an_error(self, capsys):
        with pytest.raises(SystemExit):
            matserve.main(["--device", "cpu", "--dtypes", "int8"])
