// K1-K3 (matmul, whole-operand squaring, panel squaring) for double operands.
// The kernels are the templates of gemm.cuh; each element type is its own
// translation unit so the four build in parallel.

#include "gemm.cuh"

REPRO_DEFINE_C_API(f64, double)
