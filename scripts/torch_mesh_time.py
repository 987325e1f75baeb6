#!/usr/bin/env python3
"""Where a mesh prove's time goes (tpu_plonk_torch/dist), on the card.
Run from the repository root on the machine with the card:

    python3 scripts/torch_mesh_time.py [log_n] [--ranks N --backend B]

(log_n 20 by default.)  Proves the 2^log_n Poseidon circuit of
chip_smoke.py on two meshes in turn: two gloo ranks sharing card 0
(nccl refuses two ranks on one device), then an nccl group of one; or,
with --ranks and --backend, on that one mesh (rank r on card r % the
card count: `--ranks 4 --backend nccl` on a four-card machine gives
each rank a card).  Each rank preprocesses through a cache in a
temporary directory (the first mesh misses, collectively, the second
hits), makes one first prove of each kind on its DevicePK, then a
steady unblinded and a steady blinded prove in which every collective
(multihost.all_to_all, allgather) is timed between two
synchronisations, and the sharded transforms and the commits are timed
likewise.  Rank 0 then makes the same two steady proves on one device
(the whole SRS table, no mesh) for comparison; the mesh proofs must
equal them.  Prints the card line, then one JSON line a mesh: per rank
the steady proves' seconds and rounds, and the seconds, calls and bytes
of the collectives, the sharded transforms (collectives included) and
the commits; rank 0's single-device seconds.  The synchronisations
make the timed proves a little slower than untimed ones.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the circuit; imports nothing heavy)


def _timed(torch, table, name, fn, nbytes=None):
    """fn wrapped: its seconds between two synchronisations, its calls
    and (if nbytes(args) is given) the bytes it was handed, in table."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        row = table.setdefault(name, {"s": 0.0, "calls": 0, "bytes": 0})
        row["s"] += time.perf_counter() - t0
        row["calls"] += 1
        if nbytes is not None:
            row["bytes"] += nbytes(*args)
        return out
    return run


def mesh_rank(mesh, log_n: int, cache_dir: str):
    import torch
    from tpu_plonk_torch.dist import multihost, ntt_sharded
    from tpu_plonk_torch.dist.msm_sharded import ShardedCommitter
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system import engine_device
    from tpu_plonk_torch.proof_system.preprocess import (
        preprocess_device_cached)

    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    cs = chip_smoke.poseidon_circuit(log_n)
    n = cs.padded_size()
    table = srs_device.device_srs_points(n + 8)
    com = ShardedCommitter.from_table(mesh, table)
    if mesh.rank:
        del table
    t0 = time.perf_counter()
    pk, _ = preprocess_device_cached(cs, com, cache_dir)
    torch.cuda.synchronize()
    out["preprocess_s"] = time.perf_counter() - t0
    dpk = engine_device.DevicePK(pk)
    for seed in (None, chip_smoke.PROVE_SEED):        # first proves
        engine_device.prove_device(cs, pk, com, dpk=dpk, mesh=mesh,
                                   blinding_seed=seed)
    size = lambda x, *rest: x.numel() * x.element_size()  # noqa: E731
    for name, seed in (("steady", None), ("steady_zk", chip_smoke.PROVE_SEED)):
        parts = {}
        saved = (multihost.all_to_all, multihost.allgather,
                 engine_device.ntt_sharded.ntt_replicated, com.commit)
        multihost.all_to_all = _timed(torch, parts, "all_to_all",
                                      saved[0], lambda m, x: size(x))
        multihost.allgather = _timed(torch, parts, "allgather", saved[1],
                                     lambda m, x, *r: size(x))
        ntt_sharded.ntt_replicated = _timed(torch, parts, "transforms",
                                            saved[2])
        com.commit = _timed(torch, parts, "commits", saved[3])
        rounds = {}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = engine_device.prove_device(cs, pk, com, dpk=dpk,
                                               mesh=mesh, timings=rounds,
                                               blinding_seed=seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            (multihost.all_to_all, multihost.allgather,
             ntt_sharded.ntt_replicated, com.commit) = saved
        out[name] = {"s": wall, "rounds": rounds, "parts": parts,
                     "proof": proof.to_bytes()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if mesh.rank == 0:
        single = srs_device.PackedCommitter(table)
        for name, seed in (("single", None),
                           ("single_zk", chip_smoke.PROVE_SEED)):
            rounds = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            proof = engine_device.prove_device(cs, pk, single, dpk=dpk,
                                               timings=rounds,
                                               blinding_seed=seed)
            torch.cuda.synchronize()
            out[name] = {"s": time.perf_counter() - t0, "rounds": rounds,
                         "proof": proof.to_bytes()}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_mesh_time: no CUDA device", file=sys.stderr)
        return 2
    from tpu_plonk_torch import kernels
    from tpu_plonk_torch.dist import multihost
    ap = argparse.ArgumentParser()
    ap.add_argument("log_n", type=int, nargs="?", default=20)
    ap.add_argument("--ranks", type=int)
    ap.add_argument("--backend", choices=multihost.BACKENDS)
    a = ap.parse_args()
    meshes = [(2, "gloo"), (1, "nccl")]
    if a.ranks or a.backend:
        if not (a.ranks and a.backend):
            ap.error("--ranks and --backend go together")
        meshes = [(a.ranks, a.backend)]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.library()
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="tpk_mesh_time_") as tmp:
        for size, backend in meshes:
            t0 = time.perf_counter()
            ranks = multihost.launch(mesh_rank, size, (a.log_n, tmp),
                                     backend=backend, store_dir=tmp,
                                     timeout=900)
            wall = time.perf_counter() - t0
            for r in ranks:
                for name in ("steady", "steady_zk"):
                    ref = ranks[0]["single" + name[6:]]["proof"]
                    if r[name].pop("proof") != ref:
                        raise AssertionError(f"rank {r['rank']} {name}: the "
                                             f"mesh proof differs from the "
                                             f"single-device one")
            for name in ("single", "single_zk"):
                ranks[0][name].pop("proof")
            print(json.dumps({"log_n": a.log_n, "ranks": size,
                              "backend": backend, "cards": cards,
                              "ranks_a_card": -(-size // cards),
                              "wall_s": wall, "mesh_equals_single": True,
                              "per_rank": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
