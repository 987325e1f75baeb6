"""Occupancy against gathers in the port's CSR walk (csrc/g1.cu), on one
NVIDIA GPU: build the kernel library several ways from the repository's
sources, each with one change to the walk, and time the level-1 (affine)
and level-2 (projective) walks of one 2^18 commit (c = 13) on each.

Usage:  python scripts/torch_walk_occupancy.py [--reps N]

Variants (csrc/g1.cu's TPK_WALK_* settings, set with -D at build time):
  shipped      the walk as it is: blocks of 64 threads, 6 a SM for the
               affine walk (12 warps, at most 168 registers), 8 for the
               projective one (16 warps, at most 128);
  affine16     the affine walk at 8 blocks a SM (16 warps) too;
  proj12       the projective walk at 6 blocks a SM (12 warps) too;
  no_overlap   as shipped, but each entry waits for the next entry's
               gather before its add (TPK_WALK_OVERLAP=0), so the
               random gather is no longer hidden behind the add.
Each variant's output must equal the plain version's exactly.  Prints
the card's nvidia-smi line, then one JSON line: per variant, ptxas's
registers and spills and the median device time (CUDA events over
--reps calls) of each level.
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_plonk_torch import kernels  # noqa: E402
from tpu_plonk_torch.curves import device_g1 as dg1  # noqa: E402
from tpu_plonk_torch.fields import device as dev  # noqa: E402
from tpu_plonk_torch.pcs import csr_device  # noqa: E402

VARIANTS = {
    "shipped": [],
    "affine16": ["-DTPK_WALK_BLOCKS_AFFINE=8"],
    "proj12": ["-DTPK_WALK_BLOCKS=6"],
    "no_overlap": ["-DTPK_WALK_OVERLAP=0"],
}


def build(root: str, name: str, defines):
    """Build the library with `defines` added to the compile flags;
    returns (loaded library, ptxas lines of the two walk kernels)."""
    out_dir = os.path.join(root, name)
    os.makedirs(out_dir)
    so = os.path.join(out_dir, "libtpk.so")
    report = kernels.build(out_dir, so, kernels.NVCC_FLAGS + defines)
    ptxas, fn = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif fn and "walk_kernel" in fn and ("spill" in line
                                             or "Used" in line):
            level = "l1" if "ILb1E" in fn else "l2"
            ptxas[level] = (ptxas.get(level, "") + " " + line.strip()).strip()
    lib = ctypes.CDLL(so)
    for sym in ("tpk_g1_walk_affine", "tpk_g1_walk_proj"):
        getattr(lib, sym).argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_void_p]
        getattr(lib, sym).restype = ctypes.c_int
    return lib, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walk_occupancy: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cuda = torch.device("cuda")
    rng = np.random.default_rng(2024)
    n = 1 << 18

    def words(count, ctx):
        raw = rng.integers(0, 1 << 32, size=(count, ctx.n_words),
                           dtype=np.uint64)
        t = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(cuda)
        t[:, -1] &= (1 << ((ctx.modulus.bit_length() - 1) % 32)) - 1
        return t

    c = csr_device.default_c(n)
    table = torch.stack([words(n + 8, dev.FP), words(n + 8, dev.FP)], dim=1)
    scal = dev.from_mont(words(n, dev.FR), dev.FR)
    ent, rs, rl, bf, br = csr_device.csr_rows(
        scal, c, csr_device.default_chunk(n, c))
    want1 = dg1.accumulate_csr_plain(table, True, ent, rs, rl)
    ids = torch.arange(1, rs.shape[0] + 1, dtype=torch.int32, device=cuda)
    want2 = dg1.accumulate_csr_plain(want1, False, ids, bf, br)
    levels = {"l1": ("tpk_g1_walk_affine", table, ent, rs, rl, want1),
              "l2": ("tpk_g1_walk_proj", want1, ids, bf, br, want2)}
    out = {}
    root = tempfile.mkdtemp(dir=kernels.BUILD_ROOT if os.path.isdir(
        kernels.BUILD_ROOT) else None)
    try:
        for name, defines in VARIANTS.items():
            lib, ptxas = build(root, name, defines)
            res = {"ptxas": ptxas}
            for level, (sym, tbl, idx, start, length,
                        want) in levels.items():
                got = torch.empty_like(want)
                fn = getattr(lib, sym)

                def call():
                    rc = fn(tbl.data_ptr(), idx.data_ptr(), start.data_ptr(),
                            length.data_ptr(), got.data_ptr(),
                            start.shape[0],
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name} {sym}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {level}: kernel != plain")
                times = []
                for _ in range(args.reps):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    call()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
                res[f"{level}_ms"] = statistics.median(times)
            out[name] = res
            print(name, json.dumps(res), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"walk_variants": out, "rows_l1": int(rs.shape[0]),
                      "entries_l1": int(rl.sum()),
                      "rows_l2": int(bf.shape[0]), "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
