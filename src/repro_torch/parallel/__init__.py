"""repro_torch.parallel — collective building blocks.

Only the int8 block quantization of ``collectives`` is ported so far (the
optimizer's int8 moments use it); the compressed all-reduce, the sharding
rules and the mesh-level re-exports of the reference come with the
``parallel`` slice (ROADMAP queue 1 item 8.6).
"""
from repro_torch.parallel import collectives

__all__ = ["collectives"]
