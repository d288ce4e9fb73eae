// K1-K3 (matmul, whole-operand squaring, panel squaring) for double operands:
// K1 is the fp64 tensor-core kernel of gemm_dmma.cuh, K2 and K3 the FMA
// kernels of gemm.cuh. Each element type is its own translation unit so the
// four build in parallel.

#include "gemm_dmma.cuh"

REPRO_DEFINE_DMMA_API(f64)
