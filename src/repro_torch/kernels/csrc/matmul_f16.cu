// K1-K3 (matmul, whole-operand squaring, panel squaring) for __half operands:
// all three are the tensor-core kernels of gemm_tc.cuh. Each element type is
// its own translation unit so the four build in parallel.

#include "gemm_tc.cuh"

REPRO_DEFINE_TC_API(f16, __half)
