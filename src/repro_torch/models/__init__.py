"""repro_torch.models — config-driven LM substrate for the ten architectures.

The reference's names are functions over a parameter tree (nested dicts of
tensors, layers stacked on a leading axis): ``init_params``, ``forward``,
``decode_step``, ``unembed``, ``ShardCtx`` and ``NO_SHARD``. ``LM`` is the
same tree owned by an ``nn.Module``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ShardCtx, NO_SHARD
from repro_torch.models.model import (init_params, forward, decode_step,
                                      unembed)

__all__ = ["ShardCtx", "NO_SHARD", "init_params", "forward", "decode_step",
           "unembed", "LM"]


def _register(mod: nn.Module, tree) -> nn.Module:
    """Hold the tree in ``mod``: each tensor leaf a parameter, each dict a
    submodule, so ``state_dict()`` keys are the tree's paths joined by dots
    (``embed``, ``blocks.attn.wq``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            mod.add_module(k, _register(nn.Module(), v))
        else:
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return mod


def _tree(mod: nn.Module):
    out = dict(mod.named_parameters(recurse=False))
    out.update((k, _tree(child)) for k, child in mod.named_children())
    return out


class LM(nn.Module):
    """A language model of ``cfg`` owning its parameter tree.

    ``LM(cfg, generator=g)`` draws the weights with ``init_params(cfg, g)``
    on ``g``'s device; ``LM(cfg, params=tree)`` adopts a tree (for example
    ``convert.params_from_reference(...)``). The parameters are registered
    under the tree's paths, stacked layers on their leading axis, so
    ``.to(device)`` and ``state_dict()`` work; ``params()`` gives the tree
    back for the functions. Weights are served, not trained, in this slice:
    they do not require grad (``ops.dense_matmul`` has no backward yet).
    """

    def __init__(self, cfg: ArchConfig, params=None, *,
                 generator: torch.Generator = None):
        super().__init__()
        if (params is None) == (generator is None):
            raise ValueError("LM takes exactly one of params= and "
                             "generator=")
        self.cfg = cfg
        _register(self, params if params is not None
                  else init_params(cfg, generator))

    def params(self):
        """The parameter tree (nested dicts of the registered tensors)."""
        return _tree(self)

    def forward(self, tokens, **kw):
        return forward(self.cfg, self.params(), tokens, **kw)

    def decode_step(self, tokens, cache, **kw):
        return decode_step(self.cfg, self.params(), tokens, cache, **kw)

    def unembed(self, x):
        return unembed(self.cfg, self.params(), x)
