#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tpu_plonk_torch) on one NVIDIA
GPU (written for an H100, sm_90a).  Run from the repository root:

    python3 chip_smoke.py

Phases, one line each (flushed, so a cut run shows how far it got):
  0  the card's name and power limit (nvidia-smi);
  1  the kernel build (one nvcc per source, all started together) and
     ptxas's registers / spills;
  2  every kernel against its plain PyTorch version on the card, exact,
     at the shapes of the 2^18 prove, with device times: the field
     kernels, the NTT, the G1 add, the CSR walk's level 1 (affine) and
     level 2 (projective) on one commit's lists, and the bucket weighting
     on that commit's level-2 output (W = 20, B = 4,096; also B = 8);
  3  the golden circuit's proof bytes, unblinded and blinded, against
     tests/vectors/golden_proof.hex and golden_proof_zk.hex, and the
     every-widget circuit preprocessed on the card and proved there and
     on the CPU (plain versions), unblinded and blinded: identical bytes;
  4  the 2^18-gate Poseidon circuit: SRS on the card, preprocess_device,
     two unblinded proves (first, steady) and two blinded ones on the
     same DevicePK, with round times, host verify; every kernel's launch
     count must rise on that path, the weighting must run once per
     commit of a steady prove and the G1 add not at all (it runs in the
     SRS stage); one more traced prove of each kind gives each kernel's
     device time per prove;
  5  a `kernels` JSON line; then the card line and the result line.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.  Any failure raises.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published HBM rate (bytes/s).
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer multiply issue rate: 64 INT32 lanes per SM (half the 128
#: FP32 lanes behind the 67 TFLOP/s FP32 figure), 132 SMs, 1.98 GHz boost.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: 32-bit multiply instructions (lo and hi of each 32x32->64 product count
#: one each) per Montgomery multiply: CIOS does N^2 + N^2 wide products
#: and N single ones.
MUL_OPS = {8: 2 * (64 + 64) + 8, 12: 2 * (144 + 144) + 12}
G1_ADD_OPS = 12 * MUL_OPS[12]          # twelve Fp products per RCB add
G1_MADD_OPS = 11 * MUL_OPS[12]         # eleven per mixed add (z2 = 1)

LOG_N = 18
#: the blinding seeds of the golden fixture (written by the reference's
#: host prover) and of the other blinded proves
GOLDEN_SEED = b"golden-zk"
MIXED_SEED = b"smoke-zk"
PROVE_SEED = b"smoke-zk-2^18"

#: the __global__ functions behind each wrapper, demangled and mangled,
#: for reading their device time out of a profiler trace
K_FRMUL = ("mul_kernel<FrParams>", "mul_kernelI8FrParams")
K_FPMUL = ("mul_kernel<FpParams>", "mul_kernelI8FpParams")
K_ADDSUB = ("addsub_kernel",)
K_NTT = ("bitrev_kernel", "stage_kernel")
K_G1ADD = ("::add_kernel", "10add_kernel")
K_WALK = ("walk_kernel<true>", "walk_kernelILb1E")
K_WALK_PROJ = ("walk_kernel<false>", "walk_kernelILb0E")
K_WEIGHT = ("weight_kernel", "weight_tree_kernel")
K_QUOT = ("quotient_kernel",)
#: port kernel -> its __global__ functions
TRACE_NAMES = {"fr_mont_mul": K_FRMUL, "fp_mont_mul": K_FPMUL,
               "fr_add_sub": K_ADDSUB, "ntt": K_NTT, "g1_add": K_G1ADD,
               "g1_csr_walk": K_WALK, "g1_csr_walk_proj": K_WALK_PROJ,
               "g1_bucket_weight": K_WEIGHT, "quotient_phase": K_QUOT}
#: kernels every steady prove must launch
PROVE_KERNELS = ("fr_mont_mul", "fr_add_sub", "ntt", "g1_csr_walk",
                 "g1_csr_walk_proj", "g1_bucket_weight", "quotient_phase")


def say(*parts):
    print(*parts, flush=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_adds(torch, idx, row_start, row_len) -> int:
    """The adds a CSR walk needs on this data: each row's live (nonzero)
    entries less one, since a row's first point is loaded, not added."""
    lens = row_len.to(torch.int64)
    total = int(lens.sum())
    rows = torch.repeat_interleave(torch.arange(lens.numel(),
                                                device=lens.device),
                                   lens, output_size=total)
    pos = (row_start.to(torch.int64)[rows]
           + torch.arange(total, device=lens.device)
           - (torch.cumsum(lens, 0) - lens)[rows])
    live = torch.zeros_like(lens).index_add_(
        0, rows, (idx[pos] != 0).to(torch.int64))
    return int((live - 1).clamp(min=0).sum())


def cuda_ms(torch, fn, reps: int, kernels=()):
    """Milliseconds per call of `fn` on the card: (the device time of the
    named __global__ kernels from a torch.profiler (CUPTI) trace of
    `reps` calls, or None without names or trace; the median of CUDA
    events around single calls, which also counts the host's launch path
    whenever that is longer than the kernel)."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    events = statistics.median(times)
    if not kernels:
        return None, events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(evt, "self_device_time_total", 0.0)
             for evt in prof.key_averages()
             if any(k in evt.key for k in kernels))
    return (us / reps / 1e3 if us > 0 else None), events


def max_abs_err(torch, a, b):
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


#: ptxas's names of the kernels (and of the functions it compiles on their
#: own: the weighting's add and the quotient kernel's widget functions)
PTXAS_NAMES = ("mul_kernel", "addsub_kernel", "bitrev_kernel",
               "stage_kernel", "add_kernel", "walk_kernel",
               "weight_kernel", "weight_tree_kernel", "add_points",
               "quotient_kernel",
               "arith_term", "range_term", "logic_term", "fixed_term",
               "vgadd_term", "finish")


def ptxas_summary(report: str) -> dict:
    """kernel -> 'R regs, S B spill' from nvcc -Xptxas -v output (device
    functions: their stack frame and spills only)."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            full = line.split("'")[1] if "'" in line else line.split()[-1]
            key = next((k for k in PTXAS_NAMES if k in full), None)
            if key is None:
                name = None
                continue
            tag = next((t for m, t in (
                ("FpParams", "FpParams"), ("FrParams", "FrParams"),
                ("ILb1E", "affine"), ("ILb0E", "projective"))
                if m in full), "")
            name = key + (f"<{tag}>" if tag else "")
        elif name and "spill stores" in line:
            out[name] = line.strip().split(",")[0] + ", " + \
                line.strip().split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} regs, {out.get(name, '')}"
    return out


# ---------------------------------------------------------------------------
# circuits (on the port's composer)
# ---------------------------------------------------------------------------

def golden_circuit():
    """tests/test_golden_proof.py:_circuit."""
    from tpu_plonk_torch.params import R_MOD
    from tpu_plonk_torch.cs import Composer
    from tpu_plonk_torch.gadgets import AllocatedScalar, range_check
    cs = Composer()
    a = cs.add_input(1234)
    b = cs.add_input(5678)
    c = cs.mul(1, a, b, 7)
    cs.constrain_to_constant(c, 0, (-(1234 * 5678 + 7)) % R_MOD)
    w = AllocatedScalar.allocate(cs, 4242)
    range_check(cs, 1000, 10000, w)
    x = cs.add_input(0b1010)
    y = cs.add_input(0b0111)
    cs.xor_gate(x, y, 4)
    return cs


def mixed_circuit():
    """tests/test_engine_device.py:_mixed_circuit (every widget)."""
    from tpu_plonk_torch.params import R_MOD
    from tpu_plonk_torch.cs import Composer, PointVar
    from tpu_plonk_torch.gadgets import AllocatedScalar, range_check
    from tpu_plonk_torch.curves import jubjub
    cs = Composer()
    a = cs.add_input(37)
    b = cs.add_input(21)
    c = cs.mul(1, a, b, 5)
    cs.constrain_to_constant(c, 0, (-782) % R_MOD)
    w = AllocatedScalar.allocate(cs, 999)
    range_check(cs, 100, 2000, w)
    x = cs.add_input(0b1011)
    y = cs.add_input(0b0110)
    cs.xor_gate(x, y, 4)
    k = cs.add_input(0xABCDEF)
    p = cs.fixed_base_scalar_mul(k, jubjub.GENERATOR)
    q_pt = jubjub.mul(jubjub.GENERATOR, 3)
    qv = PointVar(cs.add_input(q_pt[0]), cs.add_input(q_pt[1]), q_pt)
    cs.point_addition_gate(p, qv)
    if not cs.check_satisfied():
        raise AssertionError("mixed circuit not satisfied")
    return cs


def poseidon_circuit(log_gates: int):
    """scripts/prove_scale.py:build_circuit(log_gates, poseidon=True):
    a Poseidon sponge gadget plus arithmetic fill to 2^log_gates - 1
    gates (padded size 2^log_gates)."""
    from tpu_plonk_torch.cs import Composer
    from tpu_plonk_torch.gadgets import poseidon
    cs = Composer()
    prev = cs.add_input(3)
    prev = poseidon.sponge_gadget(cs, [prev, cs.add_input(5),
                                       cs.add_input(7), cs.add_input(11)])
    target = (1 << log_gates) - 1
    while cs.n_gates < target:
        prev = cs.mul(1, prev, prev, 3)
    return cs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, np, dev, kernels):
    """Phase 2: each kernel against its plain version at the slice's
    shapes.  Returns {name: metrics} (launches filled in later)."""
    from tpu_plonk_torch.poly import ntt
    from tpu_plonk_torch.curves import device_g1 as dg1
    from tpu_plonk_torch.pcs import csr_device, srs_device, msm_csr
    from tpu_plonk_torch.proof_system import quotient

    cuda = torch.device("cuda")
    rng = np.random.default_rng(2024)
    n = 1 << LOG_N

    def words(count, ctx):
        raw = rng.integers(0, 1 << 32, size=(count, ctx.n_words),
                           dtype=np.uint64)
        t = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(cuda)
        # clear the top word's bits from the modulus' top bit up: every
        # value is then below q
        t[:, -1] &= (1 << ((ctx.modulus.bit_length() - 1) % 32)) - 1
        return t

    res = {}

    def record(name, source, replaces, err, timed, plain_timed, nbytes,
               ops, shape):
        (trace_ms, events_ms), (_, plain_ms) = timed, plain_timed
        ms = events_ms if trace_ms is None else trace_ms
        b, by = bound_ms(nbytes, ops)
        res[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "shape": shape}
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (err {err})")
        say(f"phase 2 {name} {shape}: exact, {ms:.4f} ms device time "
            f"(CUDA events per call {events_ms:.4f} ms; plain "
            f"{plain_ms:.2f} ms; bound {b:.4f} ms by {by})")

    # Fr multiply and add/sub, 2^18 elements
    fr = dev.FR
    a, b = words(n, fr), words(n, fr)
    err = max_abs_err(torch, dev.mont_mul(a, b, fr),
                      dev.mont_mul_plain(a, b, fr))
    record("fr_mont_mul", "tpu_plonk_torch/csrc/field_ops.cu",
           "tpu_plonk/fields/pallas_fr.py:166", err,
           cuda_ms(torch, lambda: dev.mont_mul(a, b, fr), 20, K_FRMUL),
           cuda_ms(torch, lambda: dev.mont_mul_plain(a, b, fr), 3),
           3 * 32 * n, MUL_OPS[8] * n, f"2^{LOG_N}")
    err = max(max_abs_err(torch, dev.add_mod(a, b, fr),
                          dev.add_mod_plain(a, b, fr)),
              max_abs_err(torch, dev.sub_mod(a, b, fr),
                          dev.sub_mod_plain(a, b, fr)))
    record("fr_add_sub", "tpu_plonk_torch/csrc/field_ops.cu",
           "none: XLA add_mod/sub_mod in tpu_plonk/fields/device.py:142",
           err, cuda_ms(torch, lambda: dev.sub_mod(a, b, fr), 20, K_ADDSUB),
           cuda_ms(torch, lambda: dev.sub_mod_plain(a, b, fr), 3),
           3 * 32 * n, 2 * 8 * n, f"2^{LOG_N}")

    # Fp multiply at the SRS normalisation's size
    fp = dev.FP
    m = n + 8
    a, b = words(m, fp), words(m, fp)
    err = max_abs_err(torch, dev.mont_mul(a, b, fp),
                      dev.mont_mul_plain(a, b, fp))
    record("fp_mont_mul", "tpu_plonk_torch/csrc/field_ops.cu",
           "none: XLA mont_mul (FP) in tpu_plonk/fields/device.py:327",
           err, cuda_ms(torch, lambda: dev.mont_mul(a, b, fp), 20, K_FPMUL),
           cuda_ms(torch, lambda: dev.mont_mul_plain(a, b, fp), 3),
           3 * 48 * m, MUL_OPS[12] * m, f"2^{LOG_N}+8")

    # NTT, iNTT, coset NTT at 2^18
    x = dev.mont_mul(words(n, fr), fr.const(1, cuda), fr)[None]
    g = 7
    err = 0
    for inv, sc in ((False, 1), (True, 1), (False, g)):
        err = max(err, max_abs_err(torch, ntt.ntt_many(x, LOG_N, inv, sc),
                                   ntt.transform_plain(x, LOG_N, inv, sc)))
    butterflies = (n // 2) * LOG_N
    record("ntt", "tpu_plonk_torch/csrc/ntt.cu",
           "tpu_plonk/poly/ntt_mxu_pl.py:149,291", err,
           cuda_ms(torch, lambda: ntt.ntt_many(x, LOG_N), 10, K_NTT),
           cuda_ms(torch, lambda: ntt.transform_plain(x, LOG_N), 1),
           32 * n + 32 * n + 32 * (n // 2), MUL_OPS[8] * butterflies,
           f"2^{LOG_N} forward (iNTT and coset NTT also compared)")

    # G1 add on 2^16 real points: identity, equal and negated lanes
    half = 1 << 15
    tbl = srs_device.walk_table(13, msm_csr.signed_window_count(13), cuda)
    one = fp.const(1, cuda)
    pts = torch.cat([tbl, one.expand(tbl.shape[0], 1, 12)], dim=1)
    p = pts[:2 * half].clone()
    q = pts[torch.arange(2 * half, device=cuda) * 7 % pts.shape[0]].clone()
    q[:256] = p[:256]                        # doubling lanes
    q[256:512] = p[256:512]                  # y negated below: P - P
    p[512:768] = dg1.identity((256,), cuda)  # identity + Q
    q[768:1024] = dg1.identity((256,), cuda)  # P + identity
    for lo, hi in ((256, 512), (4096, 8192)):  # P - P, P - Q lanes
        q[lo:hi, 1] = dev.sub_mod_plain(torch.zeros_like(q[lo:hi, 1]),
                                        q[lo:hi, 1], fp)
    err = max_abs_err(torch, dg1.add(p, q), dg1.add_plain(p, q))
    record("g1_add", "tpu_plonk_torch/csrc/g1.cu",
           "tpu_plonk/curves/pallas_g1.py:271", err,
           cuda_ms(torch, lambda: dg1.add(p, q), 10, K_G1ADD),
           cuda_ms(torch, lambda: dg1.add_plain(p, q), 1),
           3 * 144 * 2 * half, G1_ADD_OPS * 2 * half, "2^16")

    # CSR walk on the level-1 lists of one 2^18 commit (c = 13), against
    # a 2^18-row affine table, then level 2 on its output, then the
    # bucket weighting on level 2's output
    c = csr_device.default_c(n)
    chunk = csr_device.default_chunk(n, c)
    table = torch.stack([words(n + 8, fp), words(n + 8, fp)], dim=1)
    scal = dev.from_mont(words(n, fr), fr)
    ent, rs, rl, bf, br = csr_device.csr_rows(scal, c, chunk)
    l1 = dg1.accumulate_csr(table, True, ent, rs, rl)
    err = max_abs_err(torch, l1, dg1.accumulate_csr_plain(table, True, ent,
                                                          rs, rl))
    entries = int(rl.sum())
    rows = rs.shape[0]
    record("g1_csr_walk", "tpu_plonk_torch/csrc/g1.cu",
           "tpu_plonk/curves/pallas_g1.py:416", err,
           cuda_ms(torch, lambda: dg1.accumulate_csr(table, True, ent, rs,
                                                     rl), 3, K_WALK),
           cuda_ms(torch, lambda: dg1.accumulate_csr_plain(table, True, ent,
                                                           rs, rl), 1),
           96 * table.shape[0] + 4 * ent.numel() + 8 * rows + 144 * rows,
           G1_MADD_OPS * walk_adds(torch, ent, rs, rl),
           f"level 1 of a 2^{LOG_N} commit: {rows} rows, {entries} "
           f"entries")
    del table
    ids = torch.arange(1, rows + 1, dtype=torch.int32, device=cuda)
    buckets = dg1.accumulate_csr(l1, False, ids, bf, br)
    err = max_abs_err(torch, buckets,
                      dg1.accumulate_csr_plain(l1, False, ids, bf, br))
    nb = bf.shape[0]
    record("g1_csr_walk_proj", "tpu_plonk_torch/csrc/g1.cu",
           "tpu_plonk/curves/pallas_g1.py:416", err,
           cuda_ms(torch, lambda: dg1.accumulate_csr(l1, False, ids, bf, br),
                   5, K_WALK_PROJ),
           cuda_ms(torch, lambda: dg1.accumulate_csr_plain(l1, False, ids,
                                                           bf, br), 1),
           144 * rows + 4 * rows + 8 * nb + 144 * nb,
           G1_ADD_OPS * walk_adds(torch, ids, bf, br),
           f"level 2 of the same commit: {nb} buckets over {rows} rows")
    del l1
    W = msm_csr.signed_window_count(c)
    bk = buckets.reshape(W, nb // W, 3, 12)
    bk8 = bk[:, :8].contiguous()
    err = max(max_abs_err(torch, msm_csr.weighted_window_sums(bk),
                          msm_csr.weighted_window_sums_plain(bk)),
              max_abs_err(torch, msm_csr.weighted_window_sums(bk8),
                          msm_csr.weighted_window_sums_plain(bk8)))
    # the bound counts the function's least work, a running sum over the
    # buckets (2 (B - 1) adds a window), not the adds the kernel's
    # segmented scheme does, which the note gives with its depth
    B = bk.shape[1]
    depth, adds = msm_csr.weighting_counts(B)
    record("g1_bucket_weight", "tpu_plonk_torch/csrc/g1.cu",
           "tpu_plonk/pcs/msm_csr.py:526 (the K4-driven scan)", err,
           cuda_ms(torch, lambda: msm_csr.weighted_window_sums(bk), 10,
                   K_WEIGHT),
           cuda_ms(torch, lambda: msm_csr.weighted_window_sums_plain(bk), 1),
           144 * W * B + 144 * W, G1_ADD_OPS * W * 2 * (B - 1),
           f"W = {W}, B = {B} (one 2^{LOG_N} commit; B = 8 also "
           f"compared): bound from {W * 2 * (B - 1)} adds; the kernel does "
           f"{W * adds} at depth {depth}, "
           f"{msm_csr.weighting_plan(B)} (L, T, NB)")
    del buckets, bk, bk8

    # the quotient body on one 2^18 phase coset: 23 random inputs
    vecs = dict(zip(quotient.IN_NAMES,
                    (words(n, fr) for _ in quotient.IN_NAMES)))
    scal = [words(1, fr) for _ in range(8)]
    args = ({w: vecs[w] for w in "abcd"}, vecs["z"], vecs["pi"],
            {k: vecs[k] for k in quotient.SEL_ORDER},
            [vecs[f"sigma{j}"] for j in range(1, 5)], vecs["xpts"],
            scal[6], dict(zip(("beta", "gamma", "range", "logic", "fixed",
                               "vgadd"), scal[:6])), scal[7], vecs["l1"])
    err = max_abs_err(torch, quotient.quotient_phase_kernel(*args),
                      quotient.quotient_phase_plain(*args))
    record("quotient_phase", "tpu_plonk_torch/csrc/quotient.cu",
           "tpu_plonk/proof_system/quotient_pallas.py:215", err,
           cuda_ms(torch, lambda: quotient.quotient_phase_kernel(*args), 10,
                   K_QUOT),
           cuda_ms(torch, lambda: quotient.quotient_phase_plain(*args), 1),
           (len(quotient.IN_NAMES) + 1) * 32 * n,
           quotient.MULS_PER_POINT * MUL_OPS[8] * n,
           f"one 2^{LOG_N} phase coset, 23 inputs")
    del vecs, args
    torch.cuda.empty_cache()
    return res


def phase_proof_bytes(torch, dev):
    """Phase 3: golden bytes on the card, unblinded and blinded; the
    mixed circuit card vs CPU, unblinded and blinded."""
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system.preprocess import preprocess_device
    from tpu_plonk_torch.proof_system.engine_device import prove_device
    from tpu_plonk_torch.proof_system.proof import BLINDED_PROOF_SIZE
    from tpu_plonk_torch.proof_system.verifier import verify

    vsrs = srs_device.VerifierSRS()
    cs = golden_circuit()
    n = cs.padded_size()
    table = srs_device.device_srs_points(n + 8)
    committer = srs_device.PackedCommitter(table)
    pk, vk = preprocess_device(cs, committer)
    for fixture, seed in (("golden_proof.hex", None),
                          ("golden_proof_zk.hex", GOLDEN_SEED)):
        proof = prove_device(cs, pk, committer, blinding_seed=seed)
        with open(os.path.join(HERE, "tests", "vectors", fixture)) as f:
            golden = f.read().strip()
        if proof.to_bytes().hex() != golden:
            raise AssertionError(f"golden circuit: proof bytes differ from "
                                 f"tests/vectors/{fixture}")
        if not verify(proof, vk, cs.pi, vsrs):
            raise AssertionError(f"golden proof ({fixture}) does not verify")
        say(f"phase 3 golden circuit (n={n}): proof bytes equal {fixture}, "
            f"{len(proof.to_bytes())} bytes, verified")

    cs = mixed_circuit()
    n = cs.padded_size()
    table = srs_device.device_srs_points(n + 8)
    committer = srs_device.PackedCommitter(table)
    t0 = time.perf_counter()
    pk, vk = preprocess_device(cs, committer)
    say(f"phase 3 mixed circuit (n={n}), preprocess on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    # the CPU proves start from the card's keys: the card's preprocess is
    # held by the golden bytes and by every proof verifying against vk
    pk_cpu = dataclasses.replace(
        pk, selector_coeffs={k: v.cpu() for k, v in
                             pk.selector_coeffs.items()},
        sigma_coeffs=[s.cpu() for s in pk.sigma_coeffs])
    proofs = {}
    for where, key, com, device in (
            ("card", pk, committer, None),
            ("cpu", pk_cpu, srs_device.PackedCommitter(table.cpu()), "cpu")):
        for seed in (None, MIXED_SEED):
            t0 = time.perf_counter()
            proofs[where, seed] = prove_device(
                cs, key, com, device=device, blinding_seed=seed)
            say(f"phase 3 mixed circuit (n={n}) on the {where}, "
                f"{'blinded' if seed else 'unblinded'}: "
                f"{time.perf_counter() - t0:.1f} s")
    for seed in (None, MIXED_SEED):
        card = proofs["card", seed].to_bytes()
        if card != proofs["cpu", seed].to_bytes():
            raise AssertionError(f"mixed circuit: card and CPU proofs "
                                 f"differ (seed {seed})")
        if not verify(proofs["card", seed], vk, cs.pi, vsrs):
            raise AssertionError(f"mixed proof does not verify (seed {seed})")
    if len(proofs["card", MIXED_SEED].to_bytes()) != BLINDED_PROOF_SIZE:
        raise AssertionError("blinded mixed proof is not 1088 bytes")
    say("phase 3 mixed circuit: card and CPU proof bytes identical, "
        "unblinded and blinded, verified")


def phase_prove(torch, kernels):
    """Phase 4: the 2^18-gate Poseidon circuit end to end."""
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system.preprocess import preprocess_device
    from tpu_plonk_torch.proof_system.engine_device import (
        prove_device, DevicePK)
    from tpu_plonk_torch.proof_system.verifier import verify

    stages, counts, commits = {}, {}, [0]

    def stage(name, fn):
        kernels.reset_counts()
        commits[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        counts[name] = kernels.counts()
        counts[name]["commits"] = commits[0]
        say(f"phase 4 {name}: {stages[name]:.3f} s, launches "
            f"{json.dumps(counts[name])}")
        return out

    cs = stage("circuit", lambda: poseidon_circuit(LOG_N))
    n = cs.padded_size()
    if n != 1 << LOG_N:
        raise AssertionError(f"padded size {n} != 2^{LOG_N}")
    say(f"phase 4 circuit: {cs.n_gates} gates, padded n = {n}")
    table = stage("srs", lambda: srs_device.device_srs_points(n + 8))
    committer = srs_device.PackedCommitter(table)
    commit_one = committer.commit

    def counted_commit(coeffs):
        commits[0] += 1
        return commit_one(coeffs)
    committer.commit = counted_commit
    pk, vk = stage("preprocess", lambda: preprocess_device(cs, committer))
    dpk = stage("device_pk", lambda: DevicePK(pk))
    rounds = {}
    proofs = {}
    for name, seed in (("prove_first", None), ("prove_steady", None),
                       ("prove_zk_first", PROVE_SEED),
                       ("prove_zk_steady", PROVE_SEED)):
        rounds[name] = {}
        proofs[name] = stage(name, lambda: prove_device(
            cs, pk, committer, dpk=dpk, timings=rounds[name],
            blinding_seed=seed))
        say(f"phase 4 {name} rounds: " + json.dumps(
            {k: round(v, 4) for k, v in rounds[name].items()}))
    data = {k: p.to_bytes() for k, p in proofs.items()}
    if data["prove_first"] != data["prove_steady"]:
        raise AssertionError("first and steady proofs differ")
    if data["prove_zk_first"] != data["prove_zk_steady"]:
        raise AssertionError("first and steady blinded proofs differ")
    if data["prove_zk_steady"] == data["prove_steady"]:
        raise AssertionError("blinded and unblinded proofs are equal")
    vsrs = srs_device.VerifierSRS()
    for name in ("prove_steady", "prove_zk_steady"):
        if not stage(f"verify_{name[6:]}",
                     lambda: verify(proofs[name], vk, cs.pi, vsrs)):
            raise AssertionError(f"2^18 proof ({name}) does not verify")
        say(f"phase 4 {name} verified: proof {len(data[name])} bytes")
    trace_prove(torch, "unblinded",
                lambda: prove_device(cs, pk, committer, dpk=dpk))
    trace_prove(torch, "blinded", lambda: prove_device(
        cs, pk, committer, dpk=dpk, blinding_seed=PROVE_SEED))
    return stages, counts, rounds


def trace_prove(torch, what, prove):
    """One more steady prove under torch.profiler: wall time, the summed
    device time of all kernels (the card's busy share), each port
    kernel's device time and calls, and the kernels that take most."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prove()
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
    say(f"phase 4 traced {what} prove: wall {wall:.3f} s (under the "
        f"profiler), device busy {busy:.3f} s ({100 * busy / wall:.1f}%)")
    say(f"phase 4 traced {what} port kernels (s, launches): "
        + json.dumps(port))
    say(f"phase 4 traced {what} top kernels (s, calls): " + json.dumps(
        {k[:60]: [round(v, 4), c] for k, (v, c) in top}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpu_plonk_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    from tpu_plonk_torch import kernels
    from tpu_plonk_torch.fields import device as dev

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"phase 0 card: {card}")

    lib = kernels.library()
    say(f"phase 1 build: {lib.build_seconds:.1f} s (one nvcc per source, "
        f"in parallel), {lib.path}")
    say("phase 1 ptxas: " + json.dumps(ptxas_summary(lib.report)))

    metrics = phase_kernels(torch, np, dev, kernels)
    phase_proof_bytes(torch, dev)
    stages, counts, rounds = phase_prove(torch, kernels)

    main_path = ("srs", "preprocess", "device_pk", "prove_first",
                 "prove_steady", "prove_zk_first", "prove_zk_steady")
    total = {k: sum(counts[s][k] for s in main_path) for k in kernels.KERNELS}
    for name, m in metrics.items():
        m["launches"] = total[name]
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    for name, phases in (("prove_steady", 4), ("prove_zk_steady", 8)):
        steady = counts[name]
        idle = [k for k in PROVE_KERNELS if steady[k] == 0]
        if idle:
            raise AssertionError(f"{name}: launch counters did not rise: "
                                 f"{idle}")
        if steady["quotient_phase"] != phases:
            raise AssertionError(f"{name}: {steady['quotient_phase']} "
                                 f"quotient launches, not {phases}")
        if steady["g1_bucket_weight"] != steady["commits"]:
            raise AssertionError(f"{name}: {steady['g1_bucket_weight']} "
                                 f"weighting calls for {steady['commits']} "
                                 f"commits")
        if steady["g1_add"] != 0:
            raise AssertionError(f"{name}: g1_add launched "
                                 f"{steady['g1_add']} times in a prove")
        say(f"phase 4 launches per {name} 2^18 prove: " + json.dumps(steady))
    for k in ("fp_mont_mul", "g1_add"):
        if counts["srs"][k] == 0:
            raise AssertionError(f"launch counters did not rise in the SRS "
                                 f"stage: {k}")
    say("phase 4 stages (s): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))

    kern = [{k: v for k, v in m.items() if k != "shape"}
            for m in metrics.values()]
    say(f"phase 5 total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kern}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
