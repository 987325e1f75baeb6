#!/usr/bin/env python3
"""What torch.distributed's backends do on this machine's card(s), for
the mesh path (tpu_plonk_torch/dist/).  Run from the repository root on
the machine with the card:

    python3 scripts/torch_dist_probe.py

Each case runs in fresh `spawn`ed ranks that rendezvous through a
`file://` store in a temporary directory, with a time limit, and prints
one JSON line: the case, whether it worked, and the error if not.
Cases:
  gloo_cuda_2   two gloo ranks sharing card 0: all_to_all_single,
                all_gather_into_tensor and all_gather on CUDA int32
                tensors, each result checked;
  gloo_cpu_2    the same on CPU tensors;
  nccl_1        one nccl rank: the same collectives;
  nccl_shared_2 two nccl ranks on the same card (expected to be
                refused).
Prints the card line (nvidia-smi name, power limit) and the versions
first.  Exits 0 once every case has reported, whatever it reported.
"""

import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LIMIT_S = 120


def _rank(rank, world, backend, device_type, store, out):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dv = torch.device("cuda", 0)
        else:
            dv = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank)
        n = 8 * world
        x = (torch.arange(n * 3, dtype=torch.int32, device=dv)
             .reshape(n, 3) + 1000 * rank)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        blk = n // world
        want = torch.cat([torch.arange(n * 3, dtype=torch.int32,
                                       device=dv).reshape(n, 3)
                          [rank * blk:(rank + 1) * blk] + 1000 * r
                          for r in range(world)])
        ok_a2a = bool(torch.equal(y, want))
        g = torch.empty((world * n, 3), dtype=x.dtype, device=dv)
        dist.all_gather_into_tensor(g, x)
        ok_agt = all(bool(torch.equal(g[r * n:(r + 1) * n],
                                      x - 1000 * rank + 1000 * r))
                     for r in range(world))
        lst = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(lst, x)
        ok_ag = all(bool(torch.equal(lst[r], x - 1000 * rank + 1000 * r))
                    for r in range(world))
        if device_type == "cuda":
            torch.cuda.synchronize()
        out.put((rank, {"all_to_all_single": ok_a2a,
                        "all_gather_into_tensor": ok_agt,
                        "all_gather": ok_ag}))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - reported, this is a probe
        out.put((rank, {"error": f"{type(e).__name__}: {e}"[:600],
                        "where": traceback.format_exc()[-400:]}))


def run_case(name, world, backend, device_type):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, world, backend,
                                                 device_type, store, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results = {}
        import queue
        try:
            for _ in range(world):
                r, res = out.get(timeout=LIMIT_S)
                results[r] = res
        except queue.Empty:
            pass
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    worked = (len(results) == world
              and all("error" not in v and all(v.values())
                      for v in results.values()))
    print(json.dumps({"case": name, "worked": worked,
                      "ranks_reported": len(results),
                      "results": {str(k): v for k, v in
                                  sorted(results.items())}}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "gloo": dist.is_gloo_available(),
                      "devices": torch.cuda.device_count()}), flush=True)
    run_case("gloo_cuda_2", 2, "gloo", "cuda")
    run_case("gloo_cpu_2", 2, "gloo", "cpu")
    run_case("nccl_1", 1, "nccl", "cuda")
    run_case("nccl_shared_2", 2, "nccl", "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
