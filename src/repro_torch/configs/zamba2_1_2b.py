"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention block
every 6th layer (6 super-blocks of 5x mamba + 1x shared attn, +2 tail mamba
= 38 layers). [arXiv:2411.15242; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    layer_pattern=("m", "m", "m", "m", "m", "a"),
    n_pattern_repeats=6,
    n_tail_layers=2,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,               # MHA in the shared block
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    grad_accum=8,
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke",
    n_layers=8,
    layer_pattern=("m", "m", "a"),
    n_pattern_repeats=2,
    n_tail_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    compute_dtype="float32", grad_accum=1,
)
