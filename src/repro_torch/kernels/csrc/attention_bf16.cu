// K5 (flash attention) for __nv_bfloat16 operands: the tensor-core kernel of
// attention_tc.cuh, and the split-KV combine of attention.cuh. Each element
// type is its own translation unit so the builds run in parallel.

#include "attention_tc.cuh"

REPRO_DEFINE_ATTENTION_TC_API(bf16, __nv_bfloat16)
