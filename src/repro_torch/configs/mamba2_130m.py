"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

This arch carries the paper's technique most directly: the SSD inter-chunk
recurrence is evaluated with the log-depth doubling scan
(``repro_torch.core.scan.prefix_scan``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,                  # unused (attn-free); keeps d_head derivable
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,                # d_inner=1536 -> 24 ssm heads
    tie_embeddings=True,
    grad_accum=4,
)

SMOKE = CONFIG.replace(
    name="mamba2-130m-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    compute_dtype="float32", grad_accum=1,
)
