// K1-K3 (matmul, whole-operand squaring, panel squaring) for double operands:
// the fp64 tensor-core kernels of gemm_dmma.cuh. Each element type is its
// own translation unit so the four build in parallel.

#include "gemm_dmma.cuh"

REPRO_DEFINE_DMMA_API(f64)
