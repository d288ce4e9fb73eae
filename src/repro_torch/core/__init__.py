"""repro_torch.core — the paper's contribution as a PyTorch library.

Matrix exponentiation by squaring (O(N) -> O(log N) multiplies), its
data-driven-power and stacked forms, the scaling-and-squaring matrix
exponential built on it, the Markov-chain workloads (steady state,
distribution evolution), and the sharded chain over a ``torch.distributed``
device mesh, and the log-depth prefix scan the SSM blocks of the LM
substrate run on (``scan``).
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
from repro_torch.core.scan import prefix_scan, prefix_products, decay_prefix
from repro_torch.core.distributed import (
    matmul_2d_gather,
    matmul_cannon,
    sharded_matmul,
    ShardedMatmulChain,
    matpow_sharded,
    expm_sharded,
)

__all__ = [
    "matpow_naive", "matpow_binary", "matpow_binary_traced", "matmul_backend",
    "chain_for",
    "expm", "BatchedMatmulChain", "batched_matpow", "batched_expm",
    "validate_stochastic", "markov_power", "steady_state",
    "evolve_distributions", "SteadyStateResult",
    "matmul_2d_gather", "matmul_cannon", "sharded_matmul",
    "ShardedMatmulChain", "matpow_sharded", "expm_sharded",
    "prefix_scan", "prefix_products", "decay_prefix",
]
