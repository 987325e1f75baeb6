"""Time the port's NTT on one NVIDIA GPU at the sizes and batches given,
for the checkout this script lives in or for another one (`--root`, e.g.
an unpacked `git archive` of a parent commit, to compare two trees in
one call).

Usage:  python3 scripts/torch_ntt_time.py [--root DIR] [--reps N]
            [--shapes 18x1,18x6,20x1,22x1]

For each shape (log_n x batch) it runs `poly.ntt.ntt_many` forward on
random canonical words, warm, and prints one JSON line: per shape the
device time per call (the sum of every kernel's device time in a
torch.profiler trace of --reps calls, whatever the kernels are named),
the median of CUDA events around single calls, the CUDA kernels the
trace saw per call, and the card's nvidia-smi line.

A trace must hold exactly the launches the checkout's schedule makes,
--reps times: `len(pass_plan(log_n))` where `poly/ntt.py` has a pass
plan, else 1 + log_n (a bit reversal and one launch a stage, the
radix-2 schedule before it).  CUPTI has been seen to drop kernel
records, so a trace that holds another count is taken again, up to
three times, and then the script fails instead of printing a sum of
what the trace kept.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", default="18x1,18x6,20x1,22x1")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        print("torch_ntt_time: no CUDA device", file=sys.stderr)
        return 2
    from tpu_plonk_torch.poly import ntt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(7)
    out = {"card": card, "root": os.path.abspath(args.root)}
    for shape in args.shapes.split(","):
        log_n, batch = (int(v) for v in shape.split("x"))
        raw = rng.integers(0, 1 << 32, size=(batch << log_n, 8),
                           dtype=np.uint64)
        raw[:, 7] &= (1 << 30) - 1          # below 2^254 < r
        x = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).cuda()
        x = x.reshape(batch, 1 << log_n, 8)
        ntt.ntt_many(x, log_n)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            ntt.ntt_many(x, log_n)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        want = (len(ntt.pass_plan(log_n)) if hasattr(ntt, "pass_plan")
                else 1 + log_n) * args.reps
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    ntt.ntt_many(x, log_n)
                torch.cuda.synchronize()
            rows = [(evt.key, evt.self_device_time_total, evt.count)
                    for evt in prof.key_averages()
                    if evt.self_device_time_total > 0]
            seen = sum(r[2] for r in rows)
            if seen == want:
                break
            print(f"torch_ntt_time: {shape}: the trace holds {seen} of "
                  f"{want} launches", file=sys.stderr)
        else:
            raise SystemExit(f"torch_ntt_time: {shape}: no trace held all "
                             f"{want} launches")
        out[shape] = {
            "device_ms": sum(r[1] for r in rows) / args.reps / 1e3,
            "events_ms": statistics.median(times),
            "kernels_per_call": {k[:48]: c / args.reps for k, _, c in rows}}
        del x
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
