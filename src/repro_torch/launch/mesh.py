"""Production meshes. Functions, not module state: importing this module
touches no process group and no device.

The port of the reference's ``launch/mesh.py``: the same shapes and axis
names, as a ``torch.distributed`` ``DeviceMesh`` over the default process
group (which the caller initialises: ``nccl`` on the cards, or a fake group
of 256 / 512 ranks to lay the production mesh out without devices).
"""

from __future__ import annotations

__all__ = ["make_production_mesh", "dp_axes"]


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 ranks per pod over ("data", "model"); 2x16x16 = 512
    ranks multi-pod over ("pod", "data", "model"). Raises ``ValueError``
    when the default process group has another world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != want:
        raise ValueError(f"the production mesh {shape} needs a default "
                         f"process group of {want} ranks, got {world}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return ("pod", "data") if "pod" in names else ("data",)
