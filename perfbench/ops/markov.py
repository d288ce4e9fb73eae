"""Steady-state requests: ``submit("markov", P)`` resolves with the port's
``SteadyStateResult`` (pi, matrix, squarings, residual).

Checked numbers, over the checked answers, against the reference's own
float64 squaring loop on the same chain with the configuration's ``tol``
and ``max_squarings``:

``squarings_gap``  the largest ``|k - k_ref|`` of the squarings paid
                   (exact: limit 0);
``pi_gap``         the largest ``max |pi - pi_ref| / max pi_ref``;
``residual``       the largest residual the program reports, held to the
                   configuration's ``tol`` (its own guarantee).
"""

from __future__ import annotations

import torch

from perfbench import reference
from perfbench.harness import operands


class Op:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.dtype_name = config["dtype"]
        self.dtype = getattr(torch, self.dtype_name)
        chain = config["chain"]
        self.tol = float(chain["tol"])
        self.max_squarings = int(chain["max_squarings"])
        self.eps = operands.ncd_eps(mix["pool"], *chain["eps"])
        gen = operands.generator(seed, device)
        self.pool = {n: operands.ncd_operands(
            mix["pool"], n, chain["blocks"], self.eps, self.dtype, device,
            gen) for n in mix["sizes"]}

    def operand(self, req) -> torch.Tensor:
        return self.pool[req.n][req.operand]

    def submit(self, engine, req):
        return engine.submit("markov", self.operand(req))

    def warm_classes(self, mix: dict) -> list:
        return [("markov", n, self.dtype, 1) for n in mix["sizes"]]

    def token(self, value):
        """The squarings the answer paid (a 0-d tensor on the card)."""
        return value.squarings

    def multiplies(self, req, token) -> int:
        return int(token)

    def weight(self, req) -> float:
        """How long a request is: the weaker the coupling, the more
        squarings it needs."""
        return float(req.n) ** 3 / self.eps[req.operand]

    def keep(self, value):
        return (value.pi, value.squarings, value.residual)

    def control(self, req):
        """The reference one precision below float64 (float32), in the
        served answer's place."""
        ref = reference.steady_state(
            self.operand(req), tol=self.tol,
            max_squarings=self.max_squarings, dtype=torch.float32)
        return (ref.pi, torch.tensor(ref.squarings),
                torch.tensor(ref.residual))

    def numbers(self, samples) -> dict:
        pi_gap, k_gap, resid = 0.0, 0, 0.0
        for req, (pi, k, r) in samples:
            ref = reference.steady_state(self.operand(req), tol=self.tol,
                                         max_squarings=self.max_squarings)
            got = pi.to(torch.float64)
            if got.shape != ref.pi.shape \
                    or not bool(torch.isfinite(got).all()):
                return {"squarings_gap": float("inf"),
                        "pi_gap": float("inf"), "residual": float("inf")}
            pi_gap = max(pi_gap, float((got - ref.pi).abs().max()
                                       / ref.pi.abs().max()))
            k_gap = max(k_gap, abs(int(k) - ref.squarings))
            r = float(r)
            resid = max(resid, r if r == r else float("inf"))
        return {"squarings_gap": k_gap, "pi_gap": pi_gap, "residual": resid}
