"""A^p requests: ``submit("matpow", A, power=p)``.

Checked number ``rel_err``: over the checked answers, the largest
``max |C - R| / max |R|``, C the served A^p and R the reference's float64
A^p of the same operand.
"""

from __future__ import annotations

import torch

from perfbench import reference
from perfbench.harness import operands, work


class Op:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.dtype_name = config["dtype"]
        self.dtype = getattr(torch, self.dtype_name)
        gen = operands.generator(seed, device)
        self.pool = {n: operands.power_operands(
            mix["pool"], n, self.dtype, device, gen,
            config["operand"]["eps"]) for n in mix["sizes"]}

    def operand(self, req) -> torch.Tensor:
        return self.pool[req.n][req.operand]

    def submit(self, engine, req):
        return engine.submit("matpow", self.operand(req), power=req.power)

    def warm_classes(self, mix: dict) -> list:
        """(op, n, dtype, power) to warm: one power per size (the kernels
        and routes do not depend on it), with a squaring and a combine."""
        return [("matpow", n, self.dtype, 3) for n in mix["sizes"]]

    def token(self, value):
        """What the work count needs of an answer: nothing."""
        return None

    def multiplies(self, req, token) -> int:
        return work.matpow_multiplies(req.power)

    def weight(self, req) -> float:
        """How long a request is: its dense work."""
        return work.matpow_multiplies(req.power) * float(req.n) ** 3

    def keep(self, value):
        return value

    def control(self, req):
        """The reference one precision below float32 (TF32), in the served
        answer's place."""
        return reference.matpow(self.operand(req), req.power,
                                dtype=torch.float32, tf32=True)

    def numbers(self, samples) -> dict:
        worst = 0.0
        for req, kept in samples:
            want = reference.matpow(self.operand(req), req.power)
            got = kept.to(torch.float64)
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                return {"rel_err": float("inf")}
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
            del want, got
        return {"rel_err": worst}
