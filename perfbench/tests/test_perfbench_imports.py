"""What a run loads: no module of JAX, its libraries or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port),
and the reference nothing of the port."""

import ast
import json
import subprocess
import sys

from perfbench.harness import spec
from perfbench.harness.cell import FORBIDDEN

RUN = r"""
import json, os, sys, tempfile, time
sys.path[:0] = [{root!r}, {root!r} + "/src", {tests!r}]
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = tempfile.mkdtemp() + "/a.json"
import perfbench.run  # the command's own module and what it imports
from repro_torch.kernels import autotune
autotune.record_fastmm(32, 2, backend="cpu")
from _small import run_small
res = run_small({cell!r}, traced=True, seconds=0.5)
assert res["correct"], res
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code: str) -> list:
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    mods = _loaded(RUN.format(root=str(spec.ROOT), cell="markov-f64.ncd",
                              tests=str(spec.HERE / "tests")))
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops          # the port did run
    assert not tops & set(FORBIDDEN), sorted(tops & set(FORBIDDEN))


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import json, sys; sys.path.insert(0, {str(spec.ROOT)!r}); "
            "import perfbench.reference; "
            "print(json.dumps(sorted(sys.modules)))")
    tops = {m.split(".")[0] for m in _loaded(code)}
    assert not tops & {"repro_torch", *FORBIDDEN}
    tree = ast.parse((spec.HERE / "reference" / "__init__.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert imported <= {"__future__", "contextlib", "typing", "torch"}
