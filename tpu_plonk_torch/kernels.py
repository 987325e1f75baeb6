"""Build, load and launch the port's CUDA kernels.

All sources under `csrc/` are compiled by ONE `nvcc` call into one
shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), loaded with `ctypes`.  The library is built at
first use into `_build/<hash of sources and flags>/`, a directory that
git ignores, so a fresh checkout builds it on its own.  A failed build
raises; nothing falls back to the plain versions on a CUDA tensor.

Every exported entry point takes the CUDA stream as its last argument
and returns `cudaGetLastError()` after its launches; `Kernel.__call__`
raises on a nonzero code and counts the launch.  The counts let a run
show which kernels its path went through (`reset_counts`, `counts`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_ROOT = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Without a card, the default raises instead of quietly
    running the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_plonk_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev


class Library:
    """The loaded kernel library and how it was built."""

    def __init__(self, lib, path: str, build_seconds: float, report: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.report = report          # nvcc -Xptxas -v output


_library = None


def _sources():
    return sorted(f for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libtpk.so")
    log = os.path.join(out_dir, "ptxas.txt")
    seconds = 0.0
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
            os.path.join(CSRC, f) for f in _sources() if f.endswith(".cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + res.stdout + res.stderr)
        with open(log, "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, so)
    with open(log) as f:
        report = f.read()
    _library = Library(ctypes.CDLL(so), so, seconds, report)
    _library.lib.tpk_error_string.argtypes = [ctypes.c_int]
    _library.lib.tpk_error_string.restype = ctypes.c_char_p
    return _library


P = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int

#: name -> Kernel, in the order the modules declare them
KERNELS = {}


class Kernel:
    """One exported C entry point and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library().lib, self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            msg = library().lib.tpk_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check_words(t: torch.Tensor, words: int, what: str):
    """Validate a tensor handed to a kernel: CUDA, int32, contiguous,
    last axis `words` wide."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if words and (t.dim() == 0 or t.shape[-1] != words):
        raise ValueError(f"{what}: last axis must be {words}, got "
                         f"{tuple(t.shape)}")


def operand_rows(x: torch.Tensor, shape, tail: int):
    """x as a kernel operand for an output of `shape` whose last `tail`
    axes are one element: (contiguous tensor, rows) where output element
    i reads element i % rows of x.  Suffix broadcasts (a (1, W) scalar,
    an (n, W) table under a (B, n, W) batch) pass as they are; any other
    broadcast is materialised."""
    lead = list(x.shape[:-tail])
    while lead and lead[0] == 1:
        lead.pop(0)
    if lead != list(shape[len(shape) - tail - len(lead):len(shape) - tail]):
        x = x.expand(shape)
        lead = list(shape[:-tail])
    rows = 1
    for d in lead:
        rows *= d
    return x.contiguous(), rows
