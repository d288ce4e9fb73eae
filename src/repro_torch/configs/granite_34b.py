"""granite-34b [dense] — code model, MQA (kv=1), 88 layers.
[arXiv:2405.04324; hf]

The assignment tags this "llama-arch"; a plain (2-matrix) GELU MLP is used
instead of SwiGLU because that is what reproduces the published 34B
parameter count at these dims (SwiGLU would give 47B) — matching
hf:ibm-granite/granite-34b-code-base. RoPE + RMSNorm kept per the listing.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    mlp_type="plain",
    grad_accum=16,
)

SMOKE = CONFIG.replace(
    name="granite-34b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=256, compute_dtype="float32", grad_accum=1,
)
