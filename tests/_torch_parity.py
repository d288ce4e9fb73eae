"""Shared plumbing of the port's parity tests (``tests/test_torch_*.py``).

Every parity test feeds the SAME numpy input to a function of the JAX
reference (``repro``) and to its counterpart in the PyTorch port
(``repro_torch``) and compares the outputs. The reference runs on the CPU
with its Pallas kernels in interpret mode; the port runs on CPU tensors,
where its wrappers take the kernels' plain PyTorch versions. Tolerances
come from the port's own ``error_budget`` (the ``DENSE_BUDGET`` floors):
bit-identity across the two frameworks is not claimed — they sum in
different orders and round bf16 at different places.
"""

import contextlib
import os
import re
import tempfile

import numpy as np
import jax.numpy as jnp
import torch

from repro_torch import convert
from repro_torch.kernels import error_budget

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16, "float64": torch.float64}

# The port's tuning cache: the tests neither read a developer's tuned entries
# (tile assertions would depend on the machine) nor write ~/.cache — the
# reference's tests/conftest.py does the same for the reference's cache. No
# file is made here; tests of the cache itself point the variable at their
# own temporary file.
os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
    tempfile.gettempdir(), f"repro-torch-autotune-test-{os.getpid()}.json")


def pair(array, dtype: str):
    """(jax array, torch CPU tensor) holding identical values of ``dtype``:
    the numpy input is rounded once, by JAX, and the port receives those
    exact bits through ``convert.from_reference``."""
    ja = jnp.asarray(np.asarray(array), JNP[dtype])
    ta = convert.from_reference(np.asarray(ja), device="cpu")
    assert ta.dtype == TORCH[dtype]
    return ja, ta


def as_f64(x) -> np.ndarray:
    """A jax array, torch tensor or numpy array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).astype(np.float64)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.astype(np.float32)
    return x.astype(np.float64)


def assert_close(got, want, dtype: str, *, n: int, mults: int = 1,
                 err_msg: str = ""):
    """``got`` within ``error_budget(dtype, n, mults)`` of ``want``,
    elementwise, and — because the budget's absolute floor grows with
    ``mults`` until it exceeds every entry of a bounded result (0.875 for
    bfloat16 at 7 multiplies) — the largest error also within the dtype's
    rtol floor of ``want``'s largest entry."""
    rtol, atol = error_budget(TORCH[dtype], n=n, mults=mults)
    g, w = as_f64(got), as_f64(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=err_msg)
    peak = np.abs(w).max(initial=0.0)
    if peak > 0.0:
        floor = error_budget(TORCH[dtype])[0]
        err = np.abs(g - w).max()
        assert err <= floor * peak, (
            f"{err_msg} max error {err:.3e} is {err / peak:.3e} of the "
            f"largest entry, limit {floor:.1e}")


def per_matrix(op: str, a: torch.Tensor, power: int = 1) -> torch.Tensor:
    """The port's per-matrix answer to one serving request (``backend=
    "torch"``): what a bucket answer of the engine is held against."""
    from repro_torch.core import expm, matpow_binary
    return expm(a) if op == "expm" else matpow_binary(a, power)


def assert_bucket_answer(got: torch.Tensor, want: torch.Tensor,
                         mults: int = 8):
    """A bucket answer of the serving engine against the per-matrix call.

    The reference holds these to the bit. The port does not claim it: on
    the card the squaring kernels choose their grid and K slices per stack,
    so the summation order of a bucket may differ from one matrix alone.
    They are held under ``error_budget(dtype, n, mults)`` instead (8
    multiplies covers p <= 31 and expm's Pade-13 at the tests' scale)."""
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert_close(got, want, str(want.dtype).removeprefix("torch."),
                 n=want.shape[-1], mults=mults)


@contextlib.contextmanager
def one_rank_mesh():
    """A ``gloo`` process group of this process alone (a ``file://``
    rendezvous in a temporary directory: no port to collide on) and its 1x1
    ``("data", "model")`` CPU mesh; the group is destroyed on exit, so no
    default group leaks into the next test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                                rank=0, world_size=1)
        try:
            yield init_device_mesh("cpu", (1, 1),
                                   mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()


def randn(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def stochastic(n, seed, batch=None, eps=1.0 / 32) -> np.ndarray:
    """Row-stochastic matrices whose powers stay bounded AND distinct:
    ``(1 - eps) * P + eps * S`` with P the permutation matrix of one random
    n-cycle and S a dense random row-stochastic matrix.

    A dense random S alone has a second eigenvalue near 1/sqrt(n), so S^4
    already equals S^96 to rounding and a chain that squared too few times
    would pass. Here A^p keeps a peak of about (1 - eps)^p per row at the
    position P^p puts it, so a wrong exponent moves both the peak's place
    and its size (0.13 at p = 64 against 0.05 at p = 96) by far more than
    any tolerance, while every power is still row-stochastic: no overflow,
    no underflow.
    """
    rng = np.random.default_rng(seed)
    count = 1 if batch is None else batch
    out = np.empty((count, n, n), np.float64)
    for m in out:
        s = rng.random((n, n)) + 0.05
        m[:] = eps * s / s.sum(axis=-1, keepdims=True)
        cycle = rng.permutation(n)
        m[cycle, np.roll(cycle, -1)] += 1.0 - eps
    return (out[0] if batch is None else out).astype(np.float32)


def matpow_mults(p: int) -> int:
    """Multiplies of the binary chain for power p (at least 1)."""
    if p <= 1:
        return 1
    return (p.bit_length() - 1) + (bin(p).count("1") - 1)


# -- reading the kernels' shared-memory formulas from their CUDA source -----

def cuh_expr(expr: str, names: dict) -> int:
    """Evaluate one integer expression of a ``.cuh`` as C++ would: casts
    dropped, ``/`` on integers, ``c ? a : b``."""
    expr = re.sub(r"\((?:size_t|long long)\)", "", expr).replace("/", "//")
    ternary = re.fullmatch(r"(.*)\?(.*):(.*)", expr, flags=re.S)
    if ternary:
        cond, yes, no = ternary.groups()
        expr = f"({yes}) if ({cond}) else ({no})"
    return eval(f"({expr})", {"__builtins__": {}}, dict(names))


def cuh_constants(src: str) -> dict:
    """The namespace-level ``constexpr int k...`` constants of a source."""
    consts = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 flags=re.M):
        consts[name] = cuh_expr(expr, consts)
    return consts


def cuh_struct(src: str, name: str, **params) -> dict:
    """The members of ``struct name`` in ``src`` (a template or not) at the
    given template parameters (and ``P``), evaluated in order over the
    source's constants: each ``static constexpr int`` member, and ``bytes``
    for the value its ``bytes(P)`` returns. A member of another struct of
    the source (``Other<A, B>::MEMBER``) is evaluated the same way."""
    body = re.search(rf"^(?:template <[^>]*> )?struct {name} \{{\n(.*?)^\}};",
                     src, flags=re.M | re.S).group(1)
    names = {**cuh_constants(src), **params}

    def nested(match):
        other, args, member = match.groups()
        decl = re.search(rf"^template <([^>]*)> struct {other} \{{", src,
                         flags=re.M).group(1)
        keys = [p.split()[-1] for p in decl.split(",")]
        values = [cuh_expr(a, names) for a in args.split(",")]
        return str(cuh_struct(src, other, **dict(zip(keys, values)))[member])

    def evaluate(expr):
        return cuh_expr(re.sub(r"(\w+)<([^<>]*)>::(\w+)", nested, expr),
                        names)

    for member, expr in re.findall(r"static constexpr int (\w+) =\s*(.*?);",
                                   body, flags=re.S):
        names[member] = evaluate(expr)
    returned = re.search(r"bytes\(int P[^)]*\) \{\s*return (.*?);", body,
                         flags=re.S)
    if returned and "P" in params:
        names["bytes"] = evaluate(returned.group(1))
    return names
