// K5 (flash attention) for __nv_bfloat16 operands. The kernel is the template of
// attention.cuh; each element type is its own translation unit so the
// builds run in parallel.

#include "attention.cuh"

REPRO_DEFINE_ATTENTION_API(bf16, __nv_bfloat16)
