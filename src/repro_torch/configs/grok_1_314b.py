"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    grad_accum=16,
    # 314B params: bf16 optimizer moments (a training setting; serving
    # never reads it)
    optimizer_state_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="grok-1-314b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_experts=4, top_k=2,
    compute_dtype="float32", grad_accum=1,
)
