"""The device mesh of the multi-device prove (mirrors
tpu_plonk/dist/mesh.py): one process, a "rank", per shard, joined by a
torch.distributed process group.  A rank holds its block of rows of
every sharded vector (`shard_rows`) and runs its kernels on its own
device, the current CUDA device (each rank calls torch.cuda.set_device
before it touches a kernel) or the CPU.

A process that started no group is a mesh of one: its collectives are
the identity, and the sharded programs still run their sharded
algorithm (the four-step transform, the per-shard commit)."""

import dataclasses

import torch
import torch.distributed as dist

from ..kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the group: `rank` of `size`, its `device`,
    the group's `backend` ("gloo", "nccl", or None without a group) and
    the process `group` (None without one)."""
    rank: int
    size: int
    device: torch.device
    backend: str = None
    group: object = None


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialised (default) process group, on `device`
    (cuda unless named: the current CUDA device).  Without an
    initialised group, a mesh of one."""
    dv = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(0, 1, dv)
    backend = dist.get_backend()
    if backend == "nccl" and dv.type != "cuda":
        raise ValueError("an nccl group needs CUDA tensors; pass "
                         "device='cuda' or use gloo")
    return Mesh(dist.get_rank(), dist.get_world_size(), dv, backend,
                dist.group.WORLD)


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's block of an n-row axis: rows [rank n/D, (rank+1) n/D).
    D must divide n."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    m = n // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)
