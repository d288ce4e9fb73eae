"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres vision frontend
STUB (input_specs provides pre-projected patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    # anyres: base 576 tokens + 4 tiles x 576 = 2880 image tokens
    n_vision_tokens=2880,
    grad_accum=8,
)

SMOKE = CONFIG.replace(
    name="llava-next-mistral-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, n_vision_tokens=8,
    compute_dtype="float32", grad_accum=1,
)
