"""A cell on several chips: one process a rank, joined by a ``file://``
rendezvous, the engine on a 2-D ``DeviceMesh`` (dims ``data`` and
``model``) of the configuration's shape. Rank 0 is the process that was
started; it starts the other ranks and ends the run if one of them dies.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import threading

import torch

__all__ = ["session", "spawn", "reap"]


def session(rank: int, world: int, rdzv: str, shape, body,
            device_type: str = "cuda"):
    """Join the group (``nccl`` on the card, ``gloo`` on the CPU), build
    the mesh, return ``body(mesh, device)``, leave the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    cuda = device_type == "cuda"
    if cuda:
        os.environ["NCCL_SHM_DISABLE"] = "1"
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=rdzv,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300),
                            **({"device_id": device} if cuda else {}))
    try:
        mesh = init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=("data", "model"))
        return body(mesh, device)
    finally:
        dist.destroy_process_group()


def spawn(argv: list, world: int, rdzv: str) -> list:
    """Start ranks 1..world-1 as ``argv + ["--rank", r, "--rdzv", rdzv]``
    (their standard output goes to this process's standard error), and
    watch them: if one exits non-zero the others are killed and this
    process exits with 1, since rank 0 would wait for it forever."""
    children = [subprocess.Popen(argv + ["--rank", str(r), "--rdzv", rdzv],
                                 stdout=sys.stderr) for r in range(1, world)]

    def wait(p, r):
        if p.wait() != 0:
            print(f"perfbench: rank {r} exited with {p.returncode}",
                  file=sys.stderr, flush=True)
            for q in children:
                if q.poll() is None:
                    q.kill()
            os._exit(1)

    for r, p in enumerate(children, 1):
        threading.Thread(target=wait, args=(p, r), daemon=True).start()
    return children


def reap(children, timeout: float = 120.0) -> None:
    """Wait for the other ranks; kill any that outlive ``timeout``."""
    for p in children:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        if p.poll() is None:
            p.kill()
            p.wait()
