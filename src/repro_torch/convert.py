"""Carrying operands, results and weights between the reference and the port.

What crosses the framework boundary is numpy arrays (``np.asarray(
jax_array)`` on the reference's side). ``from_reference`` takes such an
array to a tensor on the port's device, ``to_numpy`` brings a tensor back,
and ``params_from_reference`` carries an LM's whole parameter tree:

    lm = models.LM(cfg, params_from_reference(ref_params, device="cpu"))
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device

__all__ = ["from_reference", "to_numpy", "params_from_reference"]


def from_reference(array, *, device=None, dtype=None) -> torch.Tensor:
    """A contiguous tensor holding ``array``'s values, on ``device``.

    ``array`` is anything ``np.asarray`` takes, including
    ``ml_dtypes.bfloat16`` arrays (which ``torch.from_numpy`` refuses: their
    bits are reinterpreted as ``torch.bfloat16``, exactly). ``device=None``
    means the package default — the GPU, and an error when there is none;
    pass ``device="cpu"`` for the CPU. ``dtype`` converts after the transfer.
    """
    dev = default_device(device)
    arr = np.ascontiguousarray(np.asarray(array))
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
