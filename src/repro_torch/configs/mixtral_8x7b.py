"""mixtral-8x7b [moe] — 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,          # Mixtral SWA
    rope_theta=1_000_000.0,
    grad_accum=8,
)

SMOKE = CONFIG.replace(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_experts=4, top_k=2, sliding_window=16,
    compute_dtype="float32", grad_accum=1,
)
