"""repro_torch.core — the paper's contribution as a PyTorch library.

Matrix exponentiation by squaring (O(N) -> O(log N) multiplies), its
data-driven-power and stacked forms, the scaling-and-squaring matrix
exponential built on it, and the Markov-chain workloads (steady state,
distribution evolution). (The prefix scan and the sharded chain of the
reference's ``repro.core`` are ported later.)
"""

from repro_torch.core.matpow import (
    matpow_naive,
    matpow_binary,
    matpow_binary_traced,
    matmul_backend,
    chain_for,
)
from repro_torch.core.expm import expm
from repro_torch.core.batched import (
    BatchedMatmulChain,
    batched_matpow,
    batched_expm,
)
from repro_torch.core.markov import (
    validate_stochastic,
    markov_power,
    steady_state,
    evolve_distributions,
    SteadyStateResult,
)

__all__ = [
    "matpow_naive", "matpow_binary", "matpow_binary_traced", "matmul_backend",
    "chain_for",
    "expm", "BatchedMatmulChain", "batched_matpow", "batched_expm",
    "validate_stochastic", "markov_power", "steady_state",
    "evolve_distributions", "SteadyStateResult",
]
