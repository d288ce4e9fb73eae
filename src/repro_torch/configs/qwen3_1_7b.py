"""qwen3-1.7b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,                  # qwen3 uses explicit head_dim 128
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    grad_accum=4,
)

SMOKE = CONFIG.replace(
    name="qwen3-1.7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256, compute_dtype="float32", grad_accum=1,
)
