"""The ("data", "model") mesh on ``torch.distributed`` (rs_ov/parallel/mesh.py).

``initialize_distributed`` starts the process group: NCCL for the card,
gloo for the CPU; ``env://`` under ``torchrun`` (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT), or a ``file://`` or ``tcp://`` store given with
the world size and rank. ``make_mesh`` lays the ranks out as a
``DeviceMesh`` with the JAX package's axis names: rank = data * model_size +
model. Nothing falls back to one process: a failed start raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["initialize_distributed", "make_mesh", "mesh_groups"]


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, device=None) -> None:
    """Join the process group (no-op when already joined). ``device``: the
    card (``cuda:N``, NCCL, bound to that card) or ``cpu`` (gloo); default
    the card of ``torch.cuda.current_device()``."""
    if dist.is_initialized():
        return
    device = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    kwargs = {}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    if device.type == "cuda":
        kwargs["device_id"] = torch.device("cuda", device.index or 0)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method or "env://", **kwargs)


def make_mesh(data: int | None = None, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group; data
    defaults to world // model."""
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_groups(mesh: DeviceMesh | None):
    """(data group, model group) of this rank; (None, None) without a mesh."""
    if mesh is None:
        return None, None
    return mesh.get_group("data"), mesh.get_group("model")
