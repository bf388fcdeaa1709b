"""Device meshes over a torch.distributed world.

Twin of `repro/launch/mesh.py`. The reference drives one process over a
`jax.sharding.Mesh`; the port is SPMD: every rank runs the same entry
point with the same arguments under a `DeviceMesh` whose axis names are
the reference's, ("data", "model") or ("pod", "data", "model"), and every
rank returns the whole result. A mesh is built over the world of an
initialised process group (NCCL on the card, gloo on the CPU; gloo may
also drive ranks that share one card, its traffic through host copies).

A rank's device is its mesh's `device_type`: cuda:{local rank % cards}
on the card, the CPU for a 'cpu' mesh. Functions only: importing this
module touches no process group and no device.

The production meshes of the reference's dry-run, (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model"), are
built over a fake world (`fake_world`): one process stands for rank 0 of
256 or 512, its collectives do nothing, and DTensors on the mesh carry
each rank's shard shapes (`make_production_mesh`).
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")


def init_distributed(device="cuda", *, init_method: str = "env://",
                     world_size=None, rank=None) -> str:
    """Join the process group of a `torchrun` launch (env://) or of
    `init_method` (e.g. file:// or tcp://localhost:<port>, with world_size
    and rank) unless it is already joined: NCCL for device 'cuda', gloo
    for 'cpu'. On the card the rank's device becomes the current one
    first. Returns the backend."""
    dev_type = torch.device(device).type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for a gloo world on the host")
    if dist.is_initialized():
        return dist.get_backend()
    if dev_type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    backend = "nccl" if dev_type == "cuda" else "gloo"
    kw = {}
    if world_size is not None:
        kw.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, init_method=init_method, **kw)
    return backend


@contextlib.contextmanager
def world_of_one(device="cuda", store_dir=None):
    """A process group of this process alone (a file store in `store_dir`,
    default a temporary directory), destroyed on exit: the mesh entry
    points on one host without a launcher. Yields the backend."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        backend = init_distributed(device,
                                   init_method=f"file://{store_dir}/store",
                                   world_size=1, rank=0)
        try:
            yield backend
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of `world_size` ranks in which this process
    is rank 0 (torch's `fake` backend: collectives return at once and
    move nothing), destroyed on exit. Raises if a process group is
    already initialised: `init_distributed` would join a leaked fake
    group silently. Yields the world size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group to be "
                           "initialised; one already is "
                           f"({dist.get_backend()}, world "
                           f"{dist.get_world_size()})")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield int(world_size)
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The reference's production mesh over the initialised world (a
    `fake_world` of 256 or 512 ranks): (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, device_type=device_type)


def local_rank() -> int:
    """The rank on this host: $LOCAL_RANK (torchrun), else the global rank
    (one host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_mesh(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of `shape` named `axes` over the initialised world (its size
    must be the shape's product). device_type 'cuda' (the default; raises
    without a card) or 'cpu'."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch.mesh.init_distributed or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} holds "
                         f"{math.prod(shape)} ranks, the world has {world}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' mesh needs a card; pass "
                               "device_type='cpu' for a host mesh")
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"unsupported device_type {device_type!r}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, model_ways: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """(world / model_ways, model_ways) over ("data", "model")."""
    world = dist.get_world_size()
    if world % model_ways:
        raise ValueError(f"model_ways={model_ways} does not divide the "
                         f"world of {world} ranks")
    return make_mesh((world // model_ways, model_ways), AXES,
                     device_type=device_type)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda",
                            local_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis `name`, 1 where the mesh has none."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def coordinate(mesh: DeviceMesh, rank: int) -> dict:
    """{axis: index} of world rank `rank` on the mesh."""
    where = (mesh.mesh == rank).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(i) for i in where[0])))
