"""repro_torch.parallel — sharding rules and collective building blocks.

The collective-matmul schedules and the distributed squaring chain live in
``repro_torch.core.distributed`` (the paper's algorithm at mesh scale);
they are re-exported here so mesh-level code can import every collective
primitive from one package.
"""
from repro_torch.parallel import sharding, collectives
from repro_torch.core.distributed import (
    matmul_2d_gather,
    matmul_cannon,
    sharded_matmul,
    ShardedMatmulChain,
    matpow_sharded,
    expm_sharded,
)

__all__ = [
    "sharding", "collectives",
    "matmul_2d_gather", "matmul_cannon", "sharded_matmul",
    "ShardedMatmulChain", "matpow_sharded", "expm_sharded",
]
