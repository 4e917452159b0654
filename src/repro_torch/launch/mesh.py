"""Device meshes over `torch.distributed`, the counterpart of
`repro/launch/mesh.py`. Functions, not module constants, so that
importing this module touches no device and no process group.

Both build on a process group the caller has initialized
(`torch.distributed.init_process_group`, given its address, world size
and rank): NCCL over one card a rank on `device="cuda"`, gloo over
processes on `device="cpu"`, which only a caller asks for, or the fake
world of :func:`fake_world`.

:func:`fake_world` is the dry run's world: one process that is rank 0 of
a group of 256 or 512 ranks, whose collectives move nothing
(PyTorch's testing backend "fake"). `make_production_mesh` builds the
reference's meshes on it, and sharded `meta` tensors then carry each
rank's local shapes. Its mesh stays of device type "cuda", with or
without a card: DTensor on a "cpu" mesh runs a Shard-to-Shard
all-to-all as an all-gather and a chunk (gloo has no all-to-all), so it
would not count what NCCL runs, and on a "meta" mesh DTensor has no
device handle to propagate a dtype cast (`_to_copy`) with. Nothing is
placed on a card either way: the tensors are on `meta`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world(device: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if torch.device(device).type == "cuda" and dist.get_backend() != "fake":
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


@contextlib.contextmanager
def fake_world(world: int):
    """A process group of `world` ranks in this one process, rank 0, on
    PyTorch's fake backend (module docstring), destroyed on exit. Refuses
    to replace a group that is already initialized."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: "
                           "fake_world does not replace it")
    # PyTorch's testing module registers the "fake" backend on import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
