"""The first slice of the port as a whole, and its hygiene.

End to end: a numpy operand -> ``convert.from_reference`` -> the fused chain
(``matpow_binary(..., backend="cuda_chain")`` on the CPU) ->
``convert.to_numpy``, against the reference's chain in interpret mode.
Hygiene: the port imports neither ``jax`` nor the reference package, imports
without CUDA / nvcc / triton, raises instead of falling back to the CPU, and
ships its kernel sources and a git-ignored build directory.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro_torch
from repro.core import matpow as jmatpow
from repro_torch import convert
from repro_torch.core import matpow_binary
from repro_torch.kernels import _build, error_budget
from repro_torch.kernels import matmul_kernels as K

from _torch_parity import assert_close, matpow_mults, stochastic

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


class TestSliceEndToEnd:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,p", [(96, 96), (200, 7)])
    def test_numpy_in_numpy_out_vs_reference_chain(self, n, p, dtype):
        jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
        operand = np.asarray(jnp.asarray(stochastic(n, n + p), jdtype))
        want = jmatpow.matpow_binary(jnp.asarray(operand), p,
                                     backend="pallas_chain_interpret")

        K.reset_launches()
        a = convert.from_reference(operand, device="cpu")
        got = convert.to_numpy(matpow_binary(a, p, backend="cuda_chain"))

        assert got.shape == (n, n)
        assert_close(got, want, dtype, n=n, mults=matpow_mults(p))
        counts = K.launch_counts()
        squarings = sum(v for k, v in counts.items() if "square" in k)
        assert squarings == p.bit_length() - 1
        assert counts["plain_matmul"] == bin(p).count("1") - 1


class TestConvert:
    def test_bfloat16_crosses_exactly(self):
        src = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                          jnp.bfloat16)
        t = convert.from_reference(np.asarray(src), device="cpu")
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
        back = convert.to_numpy(t)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, np.asarray(src, np.float32))

    @pytest.mark.parametrize("npdtype,tdtype", [
        (np.float32, torch.float32), (np.float64, torch.float64),
        (np.float16, torch.float16), (np.int32, torch.int32)])
    def test_numpy_dtypes_round_trip(self, npdtype, tdtype):
        src = (np.arange(12).reshape(3, 4) / 4).astype(npdtype)
        t = convert.from_reference(src, device="cpu")
        assert t.dtype == tdtype
        np.testing.assert_array_equal(convert.to_numpy(t), src)

    def test_copies_and_makes_contiguous(self):
        src = np.arange(12, dtype=np.float32).reshape(3, 4).T
        t = convert.from_reference(src, device="cpu")
        assert t.is_contiguous() and t.shape == (4, 3)
        t[0, 0] = 99.0
        assert src[0, 0] == 0.0

    def test_dtype_argument_converts(self):
        t = convert.from_reference(np.ones((2, 2)), device="cpu",
                                   dtype=torch.bfloat16)
        assert t.dtype == torch.bfloat16

    def test_default_device_is_the_gpu_or_an_error(self):
        if torch.cuda.is_available():
            assert convert.from_reference(np.ones(2)).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                convert.from_reference(np.ones(2))


class TestDeviceRule:
    def test_cpu_only_when_asked_for(self):
        assert repro_torch.default_device("cpu") == torch.device("cpu")
        if torch.cuda.is_available():
            assert repro_torch.default_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                repro_torch.default_device()
            with pytest.raises(RuntimeError):
                repro_torch.default_device("cuda")

    def test_no_availability_switch_in_the_package(self):
        """The only use of torch.cuda.is_available() is the check that
        RAISES in default_device — nothing picks the CPU because the GPU is
        missing."""
        hits = [p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
                if "is_available" in p.read_text()]
        assert hits == ["__init__.py"]

    def test_kernel_route_has_no_fallback(self):
        """The wrappers choose by the tensor's device and never catch a
        failed build or launch: no ``try`` in the kernel modules."""
        for name in ("matmul.py", "attention.py"):
            tree = ast.parse((PKG / "kernels" / name).read_text())
            assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]

    def test_accum_dtype_table(self):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert repro_torch.accum_dtype(dt) == torch.float32
        assert repro_torch.accum_dtype(torch.float64) == torch.float64
        assert set(repro_torch.DTYPES) == {"float64", "float32", "float16",
                                           "bfloat16"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


class TestNoJax:
    FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

    @pytest.mark.parametrize(
        "path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
    def test_no_module_imports_jax_or_the_reference(self, path):
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path} imports {bad}"

    def test_the_port_has_the_slices_modules(self):
        names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
        assert {"__init__.py", "convert.py", "kernels/__init__.py",
                "kernels/_build.py", "kernels/matmul.py", "kernels/ops.py",
                "kernels/ref.py", "kernels/fastmm.py",
                "kernels/attention.py", "kernels/autotune.py",
                "core/__init__.py", "core/matpow.py", "core/batched.py",
                "core/expm.py", "core/markov.py", "core/distributed.py",
                "runtime/__init__.py",
                "runtime/fault.py",
                "runtime/telemetry.py", "serve/__init__.py",
                "serve/admission.py", "serve/scheduler.py",
                "serve/streams.py", "serve/matfn.py", "launch/__init__.py",
                "launch/matserve.py", "analysis/__init__.py",
                "analysis/roofline.py", "analysis/summarize.py",
                "analysis/op_cost.py", "launch/dryrun.py"} <= names

    @pytest.mark.parametrize("sub", ["serve", "runtime", "launch"])
    def test_the_guards_cover_the_serving_packages(self, sub):
        """The AST walk above and the fresh-interpreter import below reach
        the serving sub-packages: every module of them is in FILES."""
        mods = sorted((PKG / sub).rglob("*.py"))
        assert mods and set(mods) <= set(self.FILES)

    @pytest.mark.parametrize("module", [
        "repro_torch.core.markov", "repro_torch.kernels.fastmm",
        "repro_torch.kernels.ops", "repro_torch.kernels.autotune",
        "repro_torch.serve.matfn", "repro_torch.launch.matserve"])
    def test_the_guards_cover_the_strassen_and_markov_modules(self, module):
        """The modules of the Strassen and Markov slice are walked by the
        AST guard and imported by the fresh interpreter below, and pull in
        neither jax nor the reference there."""
        path = PKG.joinpath(*module.split(".")[1:]).with_suffix(".py")
        assert path in self.FILES
        code = (f"import sys, importlib\nimportlib.import_module({module!r})"
                f"\nbad = sorted(m for m in sys.modules if m.split('.')[0] "
                f"in {FORBIDDEN!r})\nassert not bad, bad\n")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr

    @pytest.mark.parametrize("module", [
        "repro_torch.configs", "repro_torch.configs.qwen3_1_7b",
        "repro_torch.core.scan", "repro_torch.models",
        "repro_torch.models.ssm", "repro_torch.serve.engine",
        "repro_torch.launch.serve"])
    def test_the_guards_cover_the_lm_modules(self, module):
        """The LM serving slice's modules are walked by the AST guard and
        imported by a fresh interpreter without jax or the reference."""
        rel = module.split(".")[1:]
        path = PKG.joinpath(*rel).with_suffix(".py")
        if not path.exists():
            path = PKG.joinpath(*rel, "__init__.py")
        assert path in self.FILES
        code = (f"import sys, importlib\nimportlib.import_module({module!r})"
                f"\nbad = sorted(m for m in sys.modules if m.split('.')[0] "
                f"in {FORBIDDEN!r})\nassert not bad, bad\n")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr

    @pytest.mark.parametrize("module", [
        "repro_torch.launch.dryrun", "repro_torch.analysis.summarize"])
    def test_the_guards_cover_the_dry_run_modules(self, module):
        """The dry run (``launch/dryrun.py`` and the ``analysis`` modules
        it imports) is walked by the AST guard, and a fresh interpreter
        imports it without jax or the reference."""
        path = PKG.joinpath(*module.split(".")[1:]).with_suffix(".py")
        assert path in self.FILES
        code = (f"import sys, importlib\nimportlib.import_module({module!r})"
                f"\nbad = sorted(m for m in sys.modules if m.split('.')[0] "
                f"in {FORBIDDEN!r})\nassert not bad, bad\n")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr

    def test_the_guards_cover_the_sharded_chain(self):
        """``core/distributed.py`` is walked by the AST guard, and a fresh
        interpreter imports it without jax or the reference — and without
        ``torch.distributed.tensor``, which it imports only where a
        function needs it (importing it takes over a second)."""
        path = PKG / "core" / "distributed.py"
        assert path in self.FILES
        code = ("import sys\nimport repro_torch.core.distributed\n"
                f"bad = sorted(m for m in sys.modules if m.split('.')[0] "
                f"in {FORBIDDEN!r})\nassert not bad, bad\n"
                "assert 'torch.distributed.tensor' not in sys.modules\n")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr

    def test_importing_everything_loads_neither(self):
        """A fresh interpreter imports the package and every sub-module —
        no CUDA, nvcc or triton needed — and ends with neither jax nor the
        reference package in sys.modules."""
        mods = sorted(
            "repro_torch" + ("." + ".".join(p.relative_to(PKG)
                                            .with_suffix("").parts)
                             ).replace(".__init__", "")
            for p in PKG.rglob("*.py"))
        code = (
            "import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n"
            "print('imported', len(sys.modules))\n")
        done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr
        assert "imported" in done.stdout


class TestBuildLayout:
    def test_sources_are_in_the_tree(self):
        names = {p.name for p in _build.sources()}
        assert "gemm.cuh" in names
        assert {"matmul_f32.cu", "matmul_f64.cu", "matmul_f16.cu",
                "matmul_bf16.cu"} <= names
        src = (PKG / "kernels" / "csrc" / "gemm.cuh").read_text()
        # K1 and K3 ask for registers that let two blocks share an SM
        for kernel, bounds in (("matmul_kernel",
                                "MatmulLayout<TILE>::L::THREADS, 2"),
                               ("matmul_wide_kernel", "kWideThreads, 2"),
                               ("square_whole_kernel",
                                "WholeFma<TILE, R, C, KS>::THREADS"),
                               ("square_panel_kernel",
                                "kThreads, 2")):
            assert f"__global__ void __launch_bounds__({bounds})\n" \
                f"{kernel}(" in src
        assert "torch/" not in src and "ATen" not in src   # plain C interface
        # the fp64 K2 / K3: four warps each, on the fp64 tensor cores
        src = (PKG / "kernels" / "csrc" / "gemm_dmma.cuh").read_text()
        for kernel in ("square_whole_dmma_kernel", "square_panel_dmma_kernel"):
            assert f"__global__ void __launch_bounds__(kSquareThreads)\n" \
                f"{kernel}(" in src
        assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
        assert "torch/" not in src and "ATen" not in src
        assert {"attention.cuh", "attention_tc.cuh", "attention_f32.cu",
                "attention_f64.cu", "attention_f16.cu",
                "attention_bf16.cu"} <= names
        src = (PKG / "kernels" / "csrc" / "attention.cuh").read_text()
        assert "__global__ void __launch_bounds__(kThreads)\n" \
            "flash_attention_kernel(" in src
        # the FMA K5: K and V through a cp.async ring, exponents in base 2
        assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in src
        assert "exp2f(" in src and "expf(" not in src
        assert "__global__ void __launch_bounds__(kCombineThreads)\n" \
            "attn_combine_kernel(" in src
        assert "torch/" not in src and "ATen" not in src
        src = (PKG / "kernels" / "csrc" / "attention_tc.cuh").read_text()
        assert "__global__ void __launch_bounds__(TQ / 64 * 128 + 32)\n" \
            "flash_attention_tc_kernel(" in src
        assert '#include "gemm_tc.cuh"' in src     # shared, not copied
        assert "torch/" not in src and "ATen" not in src

    def test_build_flags_target_hopper(self):
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert "-std=c++17" in _build.NVCC_FLAGS

    def test_every_c_function_has_argtypes(self):
        assert set(_build._SIGNATURES) == {"repro_matmul",
                                           "repro_square_whole",
                                           "repro_square_panel",
                                           "repro_flash_attention",
                                           "repro_attn_combine"}
        # q, k, v, o, the two split workspaces; 12 ints; scale; stream
        assert len(_build._SIGNATURES["repro_flash_attention"]) == 20
        assert len(_build._SIGNATURES["repro_attn_combine"]) == 7
        assert set(_build.DTYPE_SUFFIX) == set(repro_torch.DTYPES)

    def test_build_directory_is_git_ignored(self):
        ignored = (ROOT / ".gitignore").read_text().splitlines()
        rel = _build.build_root().relative_to(ROOT).as_posix() + "/"
        assert rel in ignored
        assert "__pycache__/" in ignored

    def test_launch_check_raises(self):
        _build.check(0, "x")
        with pytest.raises(RuntimeError, match="cudaError 701"):
            _build.check(701, "x")
        with pytest.raises(ValueError, match="tile"):
            _build.check(-1, "x")

    def test_source_hash_follows_the_sources(self, monkeypatch, tmp_path):
        before = _build._source_hash()
        for p in _build.sources():
            (tmp_path / p.name).write_bytes(p.read_bytes())
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        assert _build._source_hash() == before
        with open(tmp_path / "gemm.cuh", "a") as f:
            f.write("// edit\n")
        assert _build._source_hash() != before


class TestErrorBudgetCopy:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("kw", [dict(), dict(n=4096, mults=7),
                                    dict(levels=2, n=200, mults=3)])
    def test_matches_the_reference_arithmetic(self, dtype, kw):
        from repro.kernels import fastmm as jfastmm
        want = jfastmm.error_budget(getattr(jnp, dtype), **kw)
        got = error_budget(getattr(torch, dtype), **kw)
        assert got == pytest.approx(want, rel=1e-12)
        assert error_budget(dtype, **kw) == got


class TestChipSmokeContract:
    SRC = (ROOT / "chip_smoke.py").read_text()

    def test_final_line_literal(self):
        assert '"ok": True, "device": {' in self.SRC
        assert '"platform": "gpu"' in self.SRC
        assert "torch.cuda.get_device_name(0)" in self.SRC
        assert "torch.cuda.device_count()" in self.SRC

    def test_fails_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a GPU")
        done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                              capture_output=True, text=True, timeout=120)
        assert done.returncode != 0
        assert '"ok"' not in done.stdout
