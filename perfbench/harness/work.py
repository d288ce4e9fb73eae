"""The work a request asks for, and the least time an H100 needs for it.

The H100 constants are a frozen copy of ``PEAK_FLOPS`` / ``PEAK_BYTES`` in
``chip_smoke.py`` (the ``HW`` row of ``src/repro_torch/analysis/
roofline.py`` has the same data-sheet rates): NVIDIA H100 SXM data sheet,
dense rates, the fastest pipeline the card has for each type. The port has
no TF32 path, so float32 runs on the FMA pipeline (67 TFLOP/s); float64's
peak is its tensor cores' 67 TFLOP/s.

The work is the request's own dense chain, whatever route serves it: a
route that does fewer operations (Strassen) is still charged the dense
count, so routes are judged on the same work.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "ITEMSIZE", "matpow_multiplies",
           "dense_bound_s"]

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def matpow_multiplies(p: int) -> int:
    """Multiplies of A^p by repeated squaring: bit_length(p) - 1 squarings
    and popcount(p) - 1 combines (none for p = 0 or 1)."""
    if p < 0:
        raise ValueError(f"negative power {p}")
    if p == 0:
        return 0
    return (p.bit_length() - 1) + (bin(p).count("1") - 1)


def dense_bound_s(n: int, dtype: str, multiplies: int,
                  share: float = 1.0) -> float:
    """Least seconds ``multiplies`` dense (n, n) products take on one card:
    each the larger of its 2 n^3 operations over the dtype's peak and its
    bytes (two inputs read once, one output written once) over the memory
    bandwidth. ``share`` is the part of the work this card holds (a quarter
    on a 2 x 2 mesh)."""
    flops = 2.0 * n ** 3
    nbytes = 3.0 * n * n * ITEMSIZE[dtype]
    one = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
    return one * multiplies * share
