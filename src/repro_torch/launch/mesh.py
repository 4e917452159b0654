"""Device meshes over `torch.distributed`, the counterpart of
`repro/launch/mesh.py`. Functions, not module constants, so that
importing this module touches no device and no process group.

Both build on a process group the caller has initialized
(`torch.distributed.init_process_group`, given its address, world size
and rank): NCCL over one card a rank on `device="cuda"`, gloo over
processes on `device="cpu"`, which only a caller asks for.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world(device: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n:
            raise RuntimeError(f"device {device!r}: {n} ranks but "
                               f"{cards} cards")
    return n


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production meshes: (data=16, model=16) over 256
    ranks, or (pod=2, data=16, model=16) over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 1
    for s in shape:
        want *= s
    n = _world(device)
    if n != want:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"mesh {shape} needs a world of {want} ranks; "
                         f"the process group has {n}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """A (data=world // model, model) mesh over the initialized process
    group (tests, examples, one machine's cards)."""
    n = _world(device)
    if n % model:
        raise ValueError(f"model={model} does not divide the world of {n}")
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))
