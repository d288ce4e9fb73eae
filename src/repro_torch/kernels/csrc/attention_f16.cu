// K5 (flash attention) for __half operands: the tensor-core kernel of
// attention_tc.cuh, and the split-KV combine of attention.cuh. Each element
// type is its own translation unit so the builds run in parallel.

#include "attention_tc.cuh"

REPRO_DEFINE_ATTENTION_TC_API(f16, __half)
