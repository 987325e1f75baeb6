"""Process-group bootstrap and the collectives of the mesh path (mirrors
tpu_plonk/dist/multihost.py, on torch.distributed).

One process per shard.  Every rank runs the same transcript and the
same replicated rounds; only the sharded transforms and commits split
the work, and `allgather` brings their row shards back whole to every
rank.  The backend is the caller's choice, named explicitly: `nccl` when
each rank has a card of its own, `gloo` otherwise (CPU ranks, or ranks
sharing one card: NCCL refuses two ranks on one device, "Duplicate GPU
detected"; gloo runs `all_to_all_single` and `all_gather_into_tensor` on
CUDA tensors as they are, checked on an H100 by
scripts/torch_dist_probe.py).

A process that started no group is a mesh of one (dist/mesh.py): the
collectives below are then the identity.
"""

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, make_mesh, shard_rows

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None, backend: str = None) -> None:
    """Join the process group: `num_processes` ranks rendezvous at
    `coordinator_address` (a "tcp://host:port" or "file://path" URL; a
    bare "host:port" means tcp) on `backend` ("gloo" or "nccl").  With
    one process it does nothing, so the same program runs alone."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if process_id is None or coordinator_address is None:
        raise ValueError("a group of several processes needs the "
                         "coordinator's address and this process's id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def is_coordinator() -> bool:
    """True on rank 0, and in a process that started no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _grouped(mesh: Mesh) -> bool:
    return mesh.backend is not None


def all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x: (D, ...) with x[d] the block for rank d -> (D, ...) with out[d]
    the block rank d sent to this one."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} != "
                         f"{mesh.size} ranks")
    if not _grouped(mesh):
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def allgather(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Each rank's block along `dim` -> the blocks of all ranks,
    concatenated in rank order, on every rank (contiguous)."""
    if not _grouped(mesh):
        return x.contiguous()
    lead = x.movedim(dim, 0).contiguous()
    out = torch.empty((mesh.size * lead.shape[0],) + tuple(lead.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, lead, group=mesh.group)
    return out.movedim(0, dim).contiguous()


def global_put(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A tensor replicated on every rank -> this rank's block of rows
    along `dim` (contiguous)."""
    rows = shard_rows(mesh, x.shape[dim])
    return x.narrow(dim, rows.start, rows.stop - rows.start).contiguous()


def _rank_main(rank, size, fn, args, backend, device, url, out):
    """One spawned rank: its device first, then the group, then fn."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=url, world_size=size,
                                rank=rank)
        try:
            value = fn(make_mesh(device), *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, size: int, args=(), *, backend: str, device=None,
           store_dir: str, timeout: float = 600.0) -> list:
    """Run `fn(mesh, *args)` in `size` ranks, each a fresh process
    (started with `spawn`, as CUDA needs) that sets its device (cuda
    unless named: card rank % device_count) and joins a group of `size`
    on `backend` through a `file://` store in `store_dir`.  Returns the
    ranks' return values in rank order (they must pickle).  Raises, with
    the rank's traceback, if a rank fails, and TimeoutError after
    `timeout` seconds; either way every rank is stopped before it
    returns.  Build the kernels (kernels.library()) before: each rank
    then loads the built library instead of building its own."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = "cuda" if device is None else str(device)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tpu_plonk_torch: no CUDA device is available; "
                           "pass device='cpu' to run the ranks on the CPU")
    fd, store = tempfile.mkstemp(prefix="tpk_store_", dir=store_dir)
    os.close(fd)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, fn, args, backend, device,
                               f"file://{store}", out))
             for r in range(size)]
    results = [None] * size
    received = 0
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while received < size:
            try:
                rank, ok, value = out.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"{size} ranks did not finish in "
                                   f"{timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{value}")
            results[rank] = value
            received += 1
    finally:
        for p in procs:
            if p.pid is None:                  # never started
                continue
            p.join(timeout=30 if received == size else 0)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):      # the store removes it when done
            os.remove(store)
    return results
