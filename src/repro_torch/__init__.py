"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper GPU.

Same sub-packages and module names as the JAX reference, so the
counterpart of a reference file is found by name: ``kernels`` (the
hand-written CUDA kernels, their wrappers, the Strassen recursion over
them, the tuning cache), ``core`` (the matrix-power chains, ``expm``, the
Markov-chain workloads and the prefix scan), ``configs`` and ``models``
(the ten LM architectures), ``serve`` (the LM engine, and the
matrix-function serving engine with its ``torch`` / ``chain`` / ``fastmm``
/ ``evolve`` routes and its admission, scheduling and stream layers),
``train`` (loss, AdamW, the train step), ``data`` (the synthetic token
stream), ``checkpoint`` (the npz-shard checkpointer), ``parallel`` (so
far the int8 block quantization), ``runtime`` (telemetry and fault
handling) and ``launch`` (the ``matserve``, ``serve`` and ``train``
drivers). The port imports ``torch`` only — never ``jax`` and nothing of
``repro``.

Device rule. A function that takes tensors computes on the device those
tensors lie on: on a CUDA tensor the kernel wrappers launch the hand-written
kernels (or raise), on a CPU tensor they run the plain PyTorch version of the
same function. Anything that *makes* a tensor or picks a device goes through
:func:`default_device`, which means the GPU unless the caller names the CPU,
and raises when the GPU is asked for and there is none.
"""

from __future__ import annotations

import sys

import torch

__all__ = ["default_device", "kernels_run_on", "DTYPES", "dtype_name",
           "accum_dtype", "exact_matmul_settings", "is_dtensor"]

#: Working dtypes of the matrix-function path, by their reference names.
DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}

_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's name for ``dtype`` (``"float32"``, ``"bfloat16"`` …)."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype}; the port works in "
                        f"{sorted(DTYPES)}") from None


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of every multiply: fp32 for f32/bf16/f16 operands,
    f64 for f64 (other dtypes accumulate as themselves)."""
    if dtype in (torch.bfloat16, torch.float16, torch.float32):
        return torch.float32
    return dtype


def default_device(device=None) -> torch.device:
    """The device new tensors are made on: ``cuda`` unless the caller asks
    for another (``device="cpu"`` is how the CPU tests run).

    Raises ``RuntimeError`` when CUDA is asked for — explicitly or by
    default — and PyTorch sees no CUDA device. There is no silent fall-back
    to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor. Imports nothing:
    no DTensor exists before ``torch.distributed.tensor`` is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def kernels_run_on(device=None) -> bool:
    """Whether the hand-written kernels run on ``device`` (default: the
    package's, ``cuda``): a CUDA device that PyTorch sees. It answers and
    never raises; it picks nothing (``default_device`` does, and raises
    where this says False for ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def exact_matmul_settings() -> dict:
    """Make ``torch.matmul`` on CUDA accumulate at full fp32 and say so.

    Turns off TF32 for float32 products and the reduced-precision
    (16-bit) split-K reductions for bf16/f16 products, so the ``"torch"``
    backend and every plain version accumulate the way the kernels do.
    Returns the settings now in force.
    """
    mm = torch.backends.cuda.matmul
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_fp16_reduced_precision_reduction = False
    return {
        "allow_tf32": mm.allow_tf32,
        "allow_bf16_reduced_precision_reduction":
            mm.allow_bf16_reduced_precision_reduction,
        "allow_fp16_reduced_precision_reduction":
            mm.allow_fp16_reduced_precision_reduction,
    }
