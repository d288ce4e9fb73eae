"""Blockwise symmetric int8 quantization (the reference's
``parallel/collectives.py``, its first two functions).

``quantize_int8`` / ``dequantize_int8`` hold a tensor as int8 blocks of
``block`` values with one fp32 scale per block: the optimizer's int8
moment storage (``train.optimizer.QTensor``). The compressed all-reduce
built on them (``compressed_psum``, ``ef_compress``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor, *, block: int = 256):
    """Blockwise symmetric int8 quantization. Returns (q, scales, meta):
    q int8 (n_blocks, block), scales fp32 (n_blocks,), meta (shape, n)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).float()
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], (tuple(x.shape), n)


def dequantize_int8(q, scale, meta, dtype=torch.float32) -> torch.Tensor:
    shape, n = meta
    x = (q.float() * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)
