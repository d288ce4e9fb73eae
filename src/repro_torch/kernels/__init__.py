"""repro_torch.kernels — hand-written Hopper kernels for the compute hot-spots.

csrc/        : the CUDA C++ sources (gemm.cuh, the FMA kernels; gemm_tc.cuh,
               the 16-bit tensor-core K1 / K3; attention_tc.cuh, the 16-bit
               tensor-core K5; attention.cuh, the f32 / f64 K5 and the
               split-KV combine; one translation unit per element type),
               compiled for sm_90a at first use.
_build.py    : build-at-first-use with nvcc, ctypes binding, launch-error
               check.
matmul.py    : the tiled matmul kernel (K1) and the tiered squaring kernels
               (K2 whole-operand, K3 panel, K1 above them, chosen by the
               square_tier shared-memory / L2 policy), their plain PyTorch
               versions and the launch counters.
attention.py : flash attention (K5), its plain version, its tile tables,
               the split-KV rule and combine, and the launch counters.
autotune.py  : the persistent tuning cache (matmul, attention and
               square_panel namespaces) and the sweeps that fill it,
               measured on the card as device time of CUDA-graph replays.
ops.py       : public wrappers (padding, stacking, attention), the fused
               chain executor (MatmulChain) and the tile pickers
               (pick_blocks, pick_attn_blocks), which consult the cache.
fastmm.py    : the routes' error budgets (error_budget, DENSE_BUDGET); the
               Strassen recursion is ported into it later.
ref.py       : plain PyTorch oracles the kernels are held against.
"""

from repro_torch.kernels import (attention as attention_kernels, autotune,
                                 fastmm, matmul as matmul_kernels, ops, ref)
from repro_torch.kernels.attention import (flash_attention,
                                           flash_attention_plain)
from repro_torch.kernels.fastmm import DENSE_BUDGET, error_budget
from repro_torch.kernels.matmul import (LAUNCHES, launch_counts, matmul_cuda,
                                        matmul_plain, reset_launches,
                                        square_cuda, square_plain,
                                        square_tier)
from repro_torch.kernels.ops import (MatmulChain, PaddedChain, attention,
                                     matmul, pad_to_blocks, pick_attn_blocks,
                                     pick_blocks, square)

__all__ = ["fastmm", "matmul_kernels", "attention_kernels", "autotune", "ops",
           "ref", "matmul", "square", "attention", "MatmulChain",
           "PaddedChain", "pick_blocks", "pick_attn_blocks", "pad_to_blocks",
           "matmul_cuda", "matmul_plain", "square_cuda", "square_plain",
           "square_tier", "flash_attention", "flash_attention_plain",
           "LAUNCHES", "launch_counts", "reset_launches",
           "error_budget", "DENSE_BUDGET"]
