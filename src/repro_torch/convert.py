"""Carrying operands, results and weights between the reference and the port.

What crosses the framework boundary is numpy arrays (``np.asarray(
jax_array)`` on the reference's side). ``from_reference`` takes such an
array to a tensor on the port's device, ``to_numpy`` brings a tensor back,
``params_from_reference`` carries an LM's whole parameter tree and
``train_state_from_reference`` a whole train state (params, AdamW moments
including int8 ``QTensor`` leaves, step):

    lm = models.LM(cfg, params_from_reference(ref_params, device="cpu"))
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device

__all__ = ["from_reference", "to_numpy", "params_from_reference",
           "train_state_from_reference"]


def from_reference(array, *, device=None, dtype=None) -> torch.Tensor:
    """A contiguous tensor holding ``array``'s values, on ``device``.

    ``array`` is anything ``np.asarray`` takes, including
    ``ml_dtypes.bfloat16`` arrays (which ``torch.from_numpy`` refuses: their
    bits are reinterpreted as ``torch.bfloat16``, exactly). ``device=None``
    means the package default — the GPU, and an error when there is none;
    pass ``device="cpu"`` for the CPU. ``dtype`` converts after the transfer.
    """
    dev = default_device(device)
    arr = np.asarray(array)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)    # keeps 0-d
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    t = t.to(dev)
    if dtype is not None:
        t = t.to(dtype)
    return t.contiguous()


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` as a numpy array on the host. bfloat16 has no numpy dtype
    of its own: it comes back as float32, an exact widening."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_reference(params, *, device=None, dtype=None):
    """The port's parameter tree for the reference's: nested dicts with the
    same keys, each leaf through :func:`from_reference` (``np.asarray`` of
    a jax array, or a numpy array) onto ``device``, converted to ``dtype``
    when given. Pass the result to the model functions, or to
    ``repro_torch.models.LM(cfg, params=...)``."""
    if isinstance(params, dict):
        return {k: params_from_reference(v, device=device, dtype=dtype)
                for k, v in params.items()}
    return from_reference(params, device=device, dtype=dtype)


def _moments_from_reference(tree, device):
    from repro_torch.train.optimizer import QTensor
    if isinstance(tree, dict):
        return {k: _moments_from_reference(v, device)
                for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QTensor(from_reference(tree.q, device=device),
                       from_reference(tree.scale, device=device),
                       tuple(tree.shape), int(tree.n))
    return from_reference(tree, device=device)


def train_state_from_reference(state, *, device=None):
    """The port's train state for the reference's ``init_train_state``
    output (or a state its train step returned): ``params`` through
    :func:`params_from_reference`, the moments ``m`` / ``v`` leaf by leaf
    (a reference ``QTensor`` becomes the port's, its ``q`` and ``scale``
    carried as they are) and ``step`` as a 0-d int32 tensor, all on
    ``device``."""
    opt = state["opt"]
    return {"params": params_from_reference(state["params"], device=device),
            "opt": {"m": _moments_from_reference(opt["m"], device),
                    "v": _moments_from_reference(opt["v"], device),
                    "step": from_reference(opt["step"], device=device,
                                           dtype=torch.int32)}}
