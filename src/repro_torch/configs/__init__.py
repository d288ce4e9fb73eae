"""Architecture registry: ``get_config(name)`` / ``get_config(name, smoke=True)``.

The port of the reference's ``configs``: the ten architectures, their
published values copied into ``configs/<arch>.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ArchConfig, ShapeSpec, SHAPES, TensorSpec, input_specs, cache_specs,
    shape_applicable,
)

_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "TensorSpec", "input_specs",
           "cache_specs", "shape_applicable", "get_config", "ARCH_NAMES"]
