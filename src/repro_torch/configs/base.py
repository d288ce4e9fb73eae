"""ArchConfig + input-shape registry for the ten architectures.

The port of the reference's ``configs/base.py``. Every architecture is a
value of :class:`ArchConfig`; ``repro_torch.configs.get_config(name)``
returns the full published config and ``get_config(name, smoke=True)`` a
reduced same-family config for CPU smoke tests. ``input_specs(cfg, shape)``
and ``cache_specs`` describe inputs and decode caches as
:class:`TensorSpec` values (shape and torch dtype), never allocating.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import DTYPES

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "TensorSpec", "input_specs",
           "cache_specs", "shape_applicable"]


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact published dims in configs/<id>.py)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads

    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    sliding_window: Optional[int] = None   # mixtral SWA
    rope_theta: float = 10_000.0
    use_rope: bool = True            # whisper uses sinusoidal abs positions
    causal: bool = True

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # --- hybrid (zamba2) ------------------------------------------------------
    # repeating layer pattern, e.g. ("m","m","m","m","m","a"); "a" layers share
    # ONE weight set (zamba2's global shared block). Empty -> homogeneous.
    layer_pattern: Tuple[str, ...] = ()
    n_pattern_repeats: int = 0
    n_tail_layers: int = 0           # trailing "m" layers after the repeats

    # --- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame count (conv stub output)
    cross_attention: bool = False

    # --- multimodal stubs ------------------------------------------------------
    n_vision_tokens: int = 0         # llava anyres patch embeddings (stub)

    # --- numerics / structure ---------------------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    mlp_type: str = "swiglu"         # swiglu | plain (starcoder2/whisper)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # --- distribution defaults (overridable per launch) --------------------------
    grad_accum: int = 1              # microbatch accumulation steps
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots | proj — models._maybe_remat
    attention_bwd: str = "recompute"  # recompute (flash-style) | stash
    scan_layers: bool = True
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16 (grok fit)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        if self.layer_pattern:
            n = (len(self.layer_pattern) * self.n_pattern_repeats
                 + self.n_tail_layers)
            if n != self.n_layers:
                raise ValueError(f"{self.name}: pattern covers {n} layers, "
                                 f"config says {self.n_layers}")

    # ---- derived ---------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:        # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode shape?"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        return _count_params(self)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        return _count_params(self, active_only=True)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def _ffn_params(cfg: ArchConfig) -> int:
    # SwiGLU: gate + up + down; plain: up + down
    mult = 3 if cfg.mlp_type == "swiglu" else 2
    return mult * cfg.d_model * cfg.d_ff


def _attn_params(cfg: ArchConfig) -> int:
    d_q = cfg.n_heads * cfg.d_head
    d_kv = cfg.n_kv_heads * cfg.d_head
    p = cfg.d_model * (2 * d_q + 2 * d_kv)
    if cfg.qkv_bias:
        p += d_q + 2 * d_kv
    if cfg.qk_norm:
        p += 2 * cfg.d_head
    return p


def _norm_params(cfg: ArchConfig) -> int:
    return cfg.d_model * (2 if cfg.norm_type == "layernorm" else 1)


def _ssm_params(cfg: ArchConfig) -> int:
    di, g, ds = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    conv_dim = di + 2 * g * ds
    in_proj = cfg.d_model * (2 * di + 2 * g * ds + cfg.ssm_n_heads)
    conv = conv_dim * (cfg.ssm_conv_width + 1)     # weight + bias
    out = di * cfg.d_model
    return in_proj + conv + out + 3 * cfg.ssm_n_heads + di


def _layer_params(cfg: ArchConfig, kind: str, active_only: bool) -> int:
    if kind == "m":
        return _ssm_params(cfg) + _norm_params(cfg)
    p = _attn_params(cfg) + 2 * _norm_params(cfg)
    if cfg.n_experts:
        router = cfg.d_model * cfg.n_experts
        mult = cfg.top_k if active_only else cfg.n_experts
        return p + router + mult * _ffn_params(cfg)
    return p + _ffn_params(cfg)


def _count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model          # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model     # lm head
    total += _norm_params(cfg)                    # final norm
    if cfg.layer_pattern:
        kinds = list(cfg.layer_pattern) * cfg.n_pattern_repeats
        kinds += ["m"] * cfg.n_tail_layers
        # shared attention block counted ONCE (weight sharing)
        n_attn = sum(1 for k in kinds if k == "a")
        n_m = sum(1 for k in kinds if k == "m")
        total += n_m * _layer_params(cfg, "m", active_only)
        if n_attn:
            total += _layer_params(cfg, "a", active_only)
    elif cfg.family == "ssm":
        total += cfg.n_layers * _layer_params(cfg, "m", active_only)
    else:
        total += cfg.n_layers * _layer_params(cfg, "a", active_only)
    if cfg.encoder_layers:
        # encoder self-attn + ffn blocks, + the decoder layers' extra
        # cross-attn sublayer, + the encoder's final norm.
        enc = cfg.encoder_layers * (_attn_params(cfg) + _ffn_params(cfg)
                                    + 2 * _norm_params(cfg))
        cross = cfg.n_layers * (_attn_params(cfg) + _norm_params(cfg))
        total += enc + cross + _norm_params(cfg)
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch per shape id.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k dense KV cache "
                       "exceeds per-chip HBM; shape requires sub-quadratic "
                       "attention")
    return True, ""


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is described, not allocated (the
    reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _sds(shape, dtype):
    return TensorSpec(tuple(shape), dtype)


def cache_specs(cfg: ArchConfig, batch: int, cache_len: int):
    """TensorSpecs of the decode cache tree (``serve.engine.init_cache``)."""
    cdt = DTYPES[cfg.compute_dtype]
    specs = {}
    eff_len = cache_len if cfg.sliding_window is None else min(
        cache_len, cfg.sliding_window)
    n_attn, n_ssm = _layer_counts(cfg)
    if n_attn:
        specs["k"] = _sds((n_attn, batch, eff_len, cfg.n_kv_heads, cfg.d_head), cdt)
        specs["v"] = _sds((n_attn, batch, eff_len, cfg.n_kv_heads, cfg.d_head), cdt)
    if n_ssm:
        specs["ssm_state"] = _sds(
            (n_ssm, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state),
            torch.float32)
        conv_dim = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        specs["conv_state"] = _sds(
            (n_ssm, batch, cfg.ssm_conv_width - 1, conv_dim), cdt)
    if cfg.cross_attention:
        specs["enc_k"] = _sds(
            (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.d_head), cdt)
        specs["enc_v"] = _sds(
            (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.d_head), cdt)
    specs["pos"] = _sds((batch,), torch.int32)
    return specs


def _layer_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(#attention layers needing KV cache, #ssm layers needing state)."""
    if cfg.layer_pattern:
        kinds = list(cfg.layer_pattern) * cfg.n_pattern_repeats
        kinds += ["m"] * cfg.n_tail_layers
        return sum(k == "a" for k in kinds), sum(k == "m" for k in kinds)
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    return cfg.n_layers, 0


def input_specs(cfg: ArchConfig, shape_name: str):
    """TensorSpec stand-ins for one (arch x shape) cell.

    Returns (step_kind, kwargs-dict-of-specs). Frontend stubs per the
    assignment: audio/vlm entries receive precomputed frame/patch embeddings.
    """
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name} skipped: {why}")
    b, s = shape.global_batch, shape.seq_len
    cdt = DTYPES[cfg.compute_dtype]
    specs = {}

    # vlm: image tokens occupy the front of the sequence; text tokens fill
    # the rest so TOTAL length is the assigned seq_len.
    s_text = s - cfg.n_vision_tokens if cfg.family == "vlm" else s

    if shape.kind == "train":
        specs["tokens"] = _sds((b, s_text), torch.int32)
        specs["targets"] = _sds((b, s_text), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _sds((b, s_text), torch.int32)
    else:  # decode: one new token against a cache of seq_len
        specs["tokens"] = _sds((b, 1), torch.int32)
        specs["cache"] = cache_specs(cfg, b, s)

    if cfg.family == "audio" and shape.kind != "decode":
        # conv frontend stub: encoder frame embeddings, precomputed
        specs["frames"] = _sds((b, cfg.encoder_seq, cfg.d_model), cdt)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vision_embeds"] = _sds((b, cfg.n_vision_tokens, cfg.d_model), cdt)
    return shape.kind, specs
