"""whisper-base [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings per the assignment). [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                   # decoder layers
    encoder_layers=6,
    encoder_seq=1500,             # 30s audio -> conv stride-2 -> 1500 frames
    cross_attention=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm_type="layernorm",
    act="gelu",
    mlp_type="plain",
    use_rope=False,               # sinusoidal absolute positions
    tie_embeddings=True,
    grad_accum=4,
)

SMOKE = CONFIG.replace(
    name="whisper-base-smoke",
    n_layers=2, encoder_layers=2, encoder_seq=16, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    compute_dtype="float32", grad_accum=1,
)
