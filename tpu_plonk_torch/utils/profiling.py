"""Profiling of the port on the card (the counterpart of
tpu_plonk/utils/profiling.py): which __global__ functions stand behind
each kernel wrapper, and one call traced by torch.profiler (CUPTI) with
its device time summed by port kernel."""

import time

import torch

#: port kernel (kernels.counts() key) -> its __global__ functions,
#: demangled and mangled
TRACE_NAMES = {
    "fr_mont_mul": ("mul_kernel<FrParams>", "mul_kernelI8FrParams"),
    "fp_mont_mul": ("mul_kernel<FpParams>", "mul_kernelI8FpParams"),
    "fr_add_sub": ("addsub_kernel",),
    "ntt": ("pass_kernel",),
    "g1_add": ("::add_kernel", "10add_kernel"),
    "g1_csr_walk": ("walk_kernel<true>", "walk_kernelILb1E"),
    "g1_csr_walk_proj": ("walk_kernel<false>", "walk_kernelILb0E"),
    "g1_bucket_weight": ("weight_kernel", "weight_tree_kernel"),
    "quotient_phase": ("quotient_kernel",),
}


def trace(fn):
    """Run fn() once under torch.profiler and synchronise.  Returns
    (wall seconds, device-busy seconds, {port kernel: [device seconds,
    launches]}, the 8 kernels that took most as {name: [seconds,
    calls]}).  CUPTI has been seen to drop kernel records, so device
    times and launches are lower bounds."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        # an aten:: op's self device time repeats its kernels' own rows
        if us > 0 and not evt.key.startswith("aten::"):
            per[evt.key] = (us / 1e6, evt.count)
    busy = sum(v for v, _ in per.values())
    port = {}
    for name, globs in TRACE_NAMES.items():
        rows = [v for k, v in per.items() if any(g in k for g in globs)]
        if rows:
            port[name] = [round(sum(v for v, _ in rows), 4),
                          sum(c for _, c in rows)]
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    return wall, busy, port, {k[:60]: [round(v, 4), c]
                              for k, (v, c) in top}
