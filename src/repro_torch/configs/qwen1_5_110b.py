"""qwen1.5-110b [dense] — QKV bias, GQA kv=8. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    grad_accum=16,
    optimizer_state_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-110b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, compute_dtype="float32", grad_accum=1,
)
