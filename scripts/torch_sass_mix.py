"""Instruction mix of a CUDA kernel of the port, read from its SASS.

Usage (on a machine with the CUDA toolkit):

    python3 scripts/torch_sass_mix.py [--csrc DIR] [--out DIR] [--tag T]
        quotient.cu:quotient_kernel
        [ntt.cu:pass_kernel ...]

or, on a SASS listing saved by an earlier run (no toolkit needed):

    python3 scripts/torch_sass_mix.py --sass FILE quotient.cu:quotient_kernel

For each `source:kernel` it compiles the source under `--csrc` (default
the port's `tpu_plonk_torch/csrc`) to a cubin with the library's own
flags (`kernels.NVCC_FLAGS`), keeps ptxas's report, disassembles the
cubin with `cuobjdump -sass` and saves the listing under `--out`.  In
the kernel whose mangled name contains `kernel` it takes the loop that
one work item runs (the backward branch of the kernel's own body whose
range holds the most instructions, with calls) and counts what one trip
of it issues: its own instructions plus, for each CALL in it, the
called function's instructions up to its RET (recursively).  The counts
are by class: IMAD (every IMAD form but IMAD.MOV, i.e. the multiplies
and multiply-adds, lo, hi, wide and with carry), IADD3, other integer
ALU, moves, shared / global / local memory, calls and returns, and the
rest.  It prints one JSON object: per kernel, the classes, the total,
ptxas's registers, stack frame and spills, and the issue bound of a
launch over n items, total x (n / 32) warp instructions over
132 SMs x 4 schedulers x 1.98 GHz (`--n`, default 2^18).
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: warp instructions a second the card can issue: 132 SMs x 4 schedulers
#: x 1.98 GHz boost
ISSUE_PER_S = 132 * 4 * 1.98e9

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD":
        return "move" if op.startswith("IMAD.MOV") else "imad"
    if base in ("IADD3", "IADD", "IADD32I"):
        return "iadd3"
    if base in ("LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "SEL", "LEA",
                "IABS", "FLO", "POPC", "BREV", "PRMT", "VIADD", "IMNMX",
                "ISCADD", "PLOP3", "P2R", "R2P"):
        return "int_alu"
    if base in ("MOV", "MOV32I", "UMOV", "S2R", "S2UR", "CS2R", "R2UR",
                "LDC", "ULDC"):
        return "move"
    if base in ("LDS", "STS", "LDSM", "ATOMS"):
        return "shared"
    if base in ("LDG", "STG", "LD", "ST", "LDGSTS", "RED", "ATOMG"):
        return "global"
    if base in ("LDL", "STL"):
        return "local"
    if base in ("CALL", "RET"):
        return "call_ret"
    return "other"


def parse(listing: str) -> dict:
    """function name -> [(address, opcode, operands)] in order."""
    funcs, cur = {}, None
    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def _target(operands: str) -> int:
    m = _TARGET.search(operands)
    if not m:
        raise ValueError(f"no branch target in {operands!r}")
    return int(m.group(1), 16)


def trip_mix(code) -> dict:
    """Instruction classes one trip of the kernel's work loop issues,
    with the functions it calls."""
    at = {addr: k for k, (addr, _, _) in enumerate(code)}
    callees = sorted({_target(ops) for _, op, ops in code
                      if op.startswith("CALL.REL")})
    body_end = at[callees[0]] if callees else len(code)

    def span(lo, hi):
        return code[lo:hi + 1]

    loops = []
    for k in range(body_end):
        addr, op, ops = code[k]
        if op.startswith("BRA"):
            tgt = _target(ops)
            if tgt < addr and tgt in at:
                loops.append((at[tgt], k))
    if loops:
        lo, hi = max(loops, key=lambda r: (
            sum(op.startswith("CALL") for _, op, _ in span(*r)),
            r[1] - r[0]))
    else:
        lo, hi = 0, body_end - 1

    counts = collections.Counter()
    opcodes = collections.Counter()

    def add(instrs, depth=0):
        if depth > 8:
            raise ValueError("call depth past 8")
        for _, op, ops in instrs:
            counts[classify(op)] += 1
            opcodes[op] += 1
            if op.startswith("CALL.REL"):
                start = at[_target(ops)]
                end = next(j for j in range(start, len(code))
                           if code[j][1].startswith("RET"))
                add(span(start, end), depth + 1)

    add(span(lo, hi))
    out = dict(sorted(counts.items()))
    out["total"] = sum(counts.values())
    out["loop_instructions"] = hi - lo + 1
    out["calls_in_loop"] = sum(op.startswith("CALL")
                               for _, op, _ in span(lo, hi))
    out["top_opcodes"] = dict(opcodes.most_common(12))
    return out


def ptxas_lines(report: str) -> list:
    """ptxas's lines on registers, stack frames and spills, with the
    function each is about."""
    keys = ("registers", "stack frame", "Function properties",
            "Compiling entry")
    return [line.strip() for line in report.splitlines()
            if any(k in line for k in keys)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="+", help="source.cu:kernel_substring")
    ap.add_argument("--csrc", default=os.path.join(ROOT, "tpu_plonk_torch",
                                                   "csrc"))
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "sass"))
    ap.add_argument("--sass", help="parse this saved listing instead")
    ap.add_argument("--tag", default="", help="file name prefix of the "
                    "saved listings")
    ap.add_argument("--n", type=int, default=1 << 18)
    args = ap.parse_args()
    res = {}
    for spec in args.specs:
        src, kname = spec.split(":")
        report = ""
        if args.sass:
            with open(args.sass) as f:
                listing = f.read()
        else:
            from tpu_plonk_torch import kernels
            os.makedirs(args.out, exist_ok=True)
            with tempfile.TemporaryDirectory() as tmp:
                cubin = os.path.join(tmp, "k.cubin")
                flags = [f for f in kernels.NVCC_FLAGS
                         if f not in ("-Xcompiler", "-fPIC")]
                run = subprocess.run(
                    [kernels._nvcc(), *flags, "-cubin",
                     os.path.join(args.csrc, src), "-o", cubin],
                    capture_output=True, text=True)
                report = run.stdout + run.stderr
                if run.returncode:
                    raise RuntimeError(f"nvcc failed on {src}:\n{report}")
                dis = os.path.join(os.path.dirname(kernels._nvcc()),
                                   "cuobjdump")
                listing = subprocess.run([dis, "-sass", cubin],
                                         capture_output=True, text=True,
                                         check=True).stdout
            stem = os.path.join(args.out, f"{args.tag}{src}")
            with open(stem + ".sass", "w") as f:
                f.write(listing)
            with open(stem + ".ptxas", "w") as f:
                f.write(report)
        funcs = parse(listing)
        names = [f for f in funcs if kname in f]
        if not names:
            raise ValueError(f"{kname} not in {sorted(funcs)}")
        for name in names:
            mix = trip_mix(funcs[name])
            mix["issue_bound_ms"] = (mix["total"] * (args.n / 32)
                                     / ISSUE_PER_S * 1e3)
            mix["imad_share"] = mix.get("imad", 0) / mix["total"]
            mix["ptxas"] = ptxas_lines(report)
            res[f"{src}:{name}"] = mix
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
