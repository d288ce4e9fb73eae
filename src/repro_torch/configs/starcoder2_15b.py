"""starcoder2-15b [dense] — GQA kv=4, RoPE, LN + plain GELU MLP, biases.
[arXiv:2402.19173; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm_type="layernorm",
    act="gelu",
    mlp_type="plain",
    qkv_bias=True,
    rope_theta=100_000.0,
    grad_accum=8,
)

SMOKE = CONFIG.replace(
    name="starcoder2-15b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, compute_dtype="float32", grad_accum=1,
)
