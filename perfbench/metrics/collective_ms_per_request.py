"""Collective schedule (``core/distributed.py``): ms of NCCL kernels on
rank 0's card in the profiled window per request answered in it. Mesh
cells only."""


def read(r):
    s = r.summary
    if s is None or r.mode != "mesh" or not r.traced or s.nccl_s <= 0:
        return None
    return s.nccl_s * 1e3 / len(r.traced)
