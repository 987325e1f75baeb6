"""Time the port's kernel library build two ways on the same sources:
one `nvcc` process per source, all started together, then a link
(`tpu_plonk_torch.kernels.build`, what the port does), against one
`nvcc` call that compiles every source in turn into the library.

Usage:  python scripts/torch_build_time.py
Builds in the order parallel, serial, serial, parallel, each in a fresh
directory under tpu_plonk_torch/_build/timing/ (removed afterwards), and
prints one JSON line with the seconds of each build.
Needs nvcc (no card).
"""

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tpu_plonk_torch import kernels  # noqa: E402


def serial(out_dir: str, so: str):
    srcs = [os.path.join(kernels.CSRC, f) for f in kernels._sources()
            if f.endswith(".cu")]
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                          "-o", so] + srcs, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)


def main() -> int:
    root = os.path.join(kernels.BUILD_ROOT, "timing")
    times = {"parallel": [], "serial": []}
    order = ["parallel", "serial", "serial", "parallel"]
    try:
        for k, how in enumerate(order):
            out_dir = os.path.join(root, f"{k}-{how}")
            os.makedirs(out_dir)
            so = os.path.join(out_dir, "libtpk.so")
            t0 = time.perf_counter()
            if how == "parallel":
                kernels.build(out_dir, so)
            else:
                serial(out_dir, so)
            times[how].append(round(time.perf_counter() - t0, 2))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"build_seconds": times, "order": order,
                      "sources": [f for f in kernels._sources()
                                  if f.endswith(".cu")],
                      "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
