// K5 (flash attention) for double operands. The kernel is the template of
// attention.cuh; each element type is its own translation unit so the
// builds run in parallel.

#include "attention.cuh"

REPRO_DEFINE_ATTENTION_API(f64, double)
