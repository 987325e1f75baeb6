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
     kernels, the NTT (batch 1 and the quotient phases' batch 6, with its
     launches per call from a trace), the G1 add, the CSR walk's level 1
     (affine) and
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
     device time per prove, and the NTT's calls, transforms and CUDA
     launches per prove;
  6  the user entry points: `tpu_plonk_torch.cli prove` on the
     MockCircuit (n = 4,096), unblinded and --blind, whose .proof/.vk/.pi
     must equal the reference CLI's (tests/vectors/mock_circuit*) byte
     for byte, `cli verify` (0 on them, 1 with one bit flipped), and the
     Circuit API (compile, gen_proof, verify_proof) on a small circuit;
  7  the 2^20-gate Poseidon circuit at full width: preprocess through
     preprocess_device_cached in a temporary directory (a miss, then a
     hit with equal keys; the directory is kept for phase 8), then one
     unblinded and one blinded prove, both verified, with stage seconds,
     peak device memory and launches per prove checked as in phase 4;
  8  the mesh (tpu_plonk_torch/dist): two ranks, spawned, share the card
     on gloo (nccl refuses two ranks on one device) and prove the same
     2^20 circuit through phase 7's cache (a hit) with the SRS table
     sharded, unblinded and blinded: both ranks' bytes must equal phase
     7's single-device proofs, which verify; launches per mesh prove
     checked as in phase 4 on every rank; stage seconds and peak memory
     per rank.  Then a group of one on nccl: the sharded NTT and commit
     at 2^20 against the single-device ones;
  9  sponge_hash_device (batched Poseidon on the field kernels) on 2^16
     three-element messages against its plain version and the host
     sponge; a 2^18 prove_device(ckpt=) that fails in round 3 on purpose,
     then resumes to phase 4's bytes;
  5  (printed last) a `kernels` JSON line (launches on the 2^18 path,
     and on the paths of phases 6 to 9); then the card line and the
     result line.

Exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.  Any failure raises.
"""

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
#: the size of phase 7's prove: the benchmark's headline circuit
SCALE_LOG_N = 20

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


def cuda_ms(torch, fn, reps: int, kernels=(), per_call: int = 1):
    """Milliseconds per call of `fn` on the card, as (ms, ms_by, events):
    `events` is the median of CUDA events around single calls, which also
    counts the host's launch path whenever that is longer than the
    kernel; `ms` is the device time of the named __global__ kernels from
    a torch.profiler (CUPTI) trace of `reps` calls (`ms_by` "trace"), or,
    without names or usable trace, `events` again (`ms_by` "events").
    `per_call` is the CUDA launches one call makes: a trace that recorded
    another count than reps x per_call of them (CUPTI has been seen to
    drop records) is not used, and the line says so."""
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
        return events, "events", events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [evt for evt in prof.key_averages()
            if any(k in evt.key for k in kernels)]
    us = sum(getattr(evt, "self_device_time_total", 0.0) for evt in rows)
    seen = sum(evt.count for evt in rows)
    if seen != reps * per_call:
        say(f"phase 2 note: the trace recorded {seen} of {reps * per_call} "
            f"launches of {kernels[0]}; CUDA events time it instead")
        return events, "events", events
    if us <= 0:
        return events, "events", events
    return us / reps / 1e3, "trace", events


def max_abs_err(torch, a, b):
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


#: ptxas's names of the kernels (and of the functions it compiles on their
#: own: the weighting's add and the quotient kernel's widget functions)
PTXAS_NAMES = ("mul_kernel", "addsub_kernel", "pass_kernel",
               "add_kernel", "walk_kernel",
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
    from tpu_plonk_torch.utils.profiling import TRACE_NAMES as TN

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
               ops, shape, store=True):
        (ms, ms_by, events_ms), plain_ms = timed, plain_timed[0]
        b, by = bound_ms(nbytes, ops)
        if store:
            res[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": err, "ms": ms, "ms_by": ms_by,
                         "plain_ms": plain_ms, "bound_ms": b,
                         "bound_by": by, "library_ms": None, "shape": shape}
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (err {err})")
        say(f"phase 2 {name} {shape}: exact, {ms:.4f} ms by {ms_by} "
            f"(CUDA events per call {events_ms:.4f} ms; plain "
            f"{plain_ms:.2f} ms; bound {b:.4f} ms by {by})")

    # Fr multiply and add/sub, 2^18 elements
    fr = dev.FR
    a, b = words(n, fr), words(n, fr)
    err = max_abs_err(torch, dev.mont_mul(a, b, fr),
                      dev.mont_mul_plain(a, b, fr))
    record("fr_mont_mul", "tpu_plonk_torch/csrc/field_ops.cu",
           "tpu_plonk/fields/pallas_fr.py:166", err,
           cuda_ms(torch, lambda: dev.mont_mul(a, b, fr), 20,
                   TN["fr_mont_mul"]),
           cuda_ms(torch, lambda: dev.mont_mul_plain(a, b, fr), 3),
           3 * 32 * n, MUL_OPS[8] * n, f"2^{LOG_N}")
    err = max(max_abs_err(torch, dev.add_mod(a, b, fr),
                          dev.add_mod_plain(a, b, fr)),
              max_abs_err(torch, dev.sub_mod(a, b, fr),
                          dev.sub_mod_plain(a, b, fr)))
    record("fr_add_sub", "tpu_plonk_torch/csrc/field_ops.cu",
           "none: XLA add_mod/sub_mod in tpu_plonk/fields/device.py:142",
           err, cuda_ms(torch, lambda: dev.sub_mod(a, b, fr), 20,
                        TN["fr_add_sub"]),
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
           err, cuda_ms(torch, lambda: dev.mont_mul(a, b, fp), 20,
                        TN["fp_mont_mul"]),
           cuda_ms(torch, lambda: dev.mont_mul_plain(a, b, fp), 3),
           3 * 48 * m, MUL_OPS[12] * m, f"2^{LOG_N}+8")

    # NTT, iNTT, coset NTT at 2^18, batch 1 and 6 (a quotient phase's
    # batch); the bound scales with the batch, the twiddle table is read
    # once
    butterflies = (n // 2) * LOG_N
    g = 7
    for batch in (1, 6):
        x = dev.mont_mul(words(batch * n, fr), fr.const(1, cuda),
                         fr).reshape(batch, n, 8)
        err = 0
        for inv, sc in ((False, 1), (True, 1), (False, g)):
            err = max(err, max_abs_err(
                torch, ntt.ntt_many(x, LOG_N, inv, sc),
                ntt.transform_plain(x, LOG_N, inv, sc)))
        record("ntt", "tpu_plonk_torch/csrc/ntt.cu",
               "tpu_plonk/poly/ntt_mxu_pl.py:149,291", err,
               cuda_ms(torch, lambda: ntt.ntt_many(x, LOG_N), 10, TN["ntt"],
                       len(ntt.pass_plan(LOG_N))),
               cuda_ms(torch, lambda: ntt.transform_plain(x, LOG_N), 1),
               batch * 64 * n + 32 * (n // 2),
               batch * MUL_OPS[8] * butterflies,
               f"2^{LOG_N} forward, batch {batch} (iNTT and coset NTT "
               f"also compared)", store=batch == 1)
    # warm inverse calls: CUDA launches from a trace, and no multiply
    # launched beside the transform (the n^-1 s^j scale is in its store)
    from torch.profiler import profile, ProfilerActivity
    ntt.ntt_many(x, LOG_N, True, g)        # builds the n^-1 g^j table
    torch.cuda.synchronize()
    mul_before = kernels.counts()["fr_mont_mul"]
    calls, plan = 5, ntt.pass_plan(LOG_N)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ntt.ntt_many(x, LOG_N, True, g)
            torch.cuda.synchronize()
        launched = {evt.key[:40]: evt.count for evt in prof.key_averages()
                    if evt.self_device_time_total > 0}
        if launched:
            break
        # a trace that recorded nothing at all (seen with one call under
        # a newer torch) is taken again
    # (one launch a pass by construction; the trace bounds it from above,
    # since CUPTI has been seen to miss a record)
    passes = sum(c for k, c in launched.items() if TN["ntt"][0] in k)
    if (not 1 <= passes <= calls * len(plan) or len(launched) != 1
            or kernels.counts()["fr_mont_mul"] != mul_before):
        raise AssertionError(f"ntt: {calls} inverse calls at 2^{LOG_N} "
                             f"launched {launched}, not {plan} passes each")
    say(f"phase 2 ntt launches in {calls} inverse calls at 2^{LOG_N}: "
        f"{passes} in the trace (pass plan {plan}), no other kernel")
    del x

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
           cuda_ms(torch, lambda: dg1.add(p, q), 10, TN["g1_add"]),
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
                                                     rl), 3,
                   TN["g1_csr_walk"]),
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
                   5, TN["g1_csr_walk_proj"]),
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
                   TN["g1_bucket_weight"],
                   1 + (msm_csr.weighting_plan(B)[2] > 1)),
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
                   TN["quotient_phase"]),
           cuda_ms(torch, lambda: quotient.quotient_phase_plain(*args), 1),
           (len(quotient.IN_NAMES) + 1) * 32 * n,
           quotient.KERNEL_MULS_PER_POINT * MUL_OPS[8] * n,
           f"one 2^{LOG_N} phase coset, 23 inputs; bound from the "
           f"kernel's {quotient.KERNEL_MULS_PER_POINT} multiplies a point "
           f"(the plain version does {quotient.MULS_PER_POINT})")
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
    from tpu_plonk_torch.poly import ntt

    stages, counts, commits, transforms = {}, {}, [0], [0]
    # count the polynomials each NTT kernel call transforms
    transform_kernel = ntt._transform_kernel

    def counted_transform(x, *rest):
        transforms[0] += x.shape[0]
        return transform_kernel(x, *rest)
    ntt._transform_kernel = counted_transform

    def stage(name, fn):
        kernels.reset_counts()
        commits[0] = transforms[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        counts[name] = kernels.counts()
        counts[name]["commits"] = commits[0]
        counts[name]["ntt_transforms"] = transforms[0]
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
    traced = {
        "prove_steady": trace_prove(torch, "unblinded", lambda: prove_device(
            cs, pk, committer, dpk=dpk)),
        "prove_zk_steady": trace_prove(torch, "blinded", lambda: prove_device(
            cs, pk, committer, dpk=dpk, blinding_seed=PROVE_SEED))}
    ntt._transform_kernel = transform_kernel
    committer.commit = commit_one
    for name, port in traced.items():
        calls = counts[name]["ntt"]
        launches = port.get("ntt", [0.0, 0])
        say(f"phase 4 ntt per {name} 2^{LOG_N} prove: {calls} calls, "
            f"{counts[name]['ntt_transforms']} transforms, {launches[1]} "
            f"CUDA launches and {launches[0]} s device time (traced prove)")
        if not 0 < launches[1] <= 3 * calls:
            raise AssertionError(f"{name}: {launches[1]} NTT launches for "
                                 f"{calls} calls")
    context = {"cs": cs, "pk": pk, "committer": committer, "dpk": dpk,
               "proof": data["prove_steady"]}
    return stages, counts, rounds, context


def trace_prove(torch, what, prove):
    """One more steady prove under torch.profiler: wall time, the summed
    device time of all kernels (the card's busy share), each port
    kernel's device time and calls, and the kernels that take most."""
    from tpu_plonk_torch.utils import profiling
    wall, busy, port, top = profiling.trace(prove)
    say(f"phase 4 traced {what} prove: wall {wall:.3f} s (under the "
        f"profiler), device busy {busy:.3f} s ({100 * busy / wall:.1f}%)")
    say(f"phase 4 traced {what} port kernels (s, launches): "
        + json.dumps(port))
    say(f"phase 4 traced {what} top kernels (s, calls): " + json.dumps(top))
    return port


def check_prove_launches(name: str, steady: dict, phases: int, where: str):
    """A prove's launch counts: every prove kernel ran, the quotient
    kernel once a phase, the weighting once a commit, the G1 add never
    (it runs in the SRS stage)."""
    idle = [k for k in PROVE_KERNELS if steady[k] == 0]
    if idle:
        raise AssertionError(f"{where} {name}: launch counters did not "
                             f"rise: {idle}")
    if steady["quotient_phase"] != phases:
        raise AssertionError(f"{where} {name}: {steady['quotient_phase']} "
                             f"quotient launches, not {phases}")
    if steady["g1_bucket_weight"] != steady["commits"]:
        raise AssertionError(f"{where} {name}: {steady['g1_bucket_weight']} "
                             f"weighting calls for {steady['commits']} "
                             f"commits")
    if steady["g1_add"] != 0:
        raise AssertionError(f"{where} {name}: g1_add launched "
                             f"{steady['g1_add']} times in a prove")


def phase_entry_points(torch, kernels):
    """Phase 6: the user entry points on the card.  `cli prove` on the
    MockCircuit (n = 4,096), unblinded and --blind: its artifacts equal
    the reference CLI's (tests/vectors/mock_circuit*) byte for byte;
    `cli verify` accepts them and refuses a copy with one bit flipped;
    the Circuit API (compile, gen_proof, verify_proof) on a small
    circuit.  Returns the path's launch counts."""
    import contextlib
    import io
    import shutil
    import tempfile
    from tpu_plonk_torch import cli
    from tpu_plonk_torch.params import R_MOD
    from tpu_plonk_torch.circuits import Circuit, verify_proof
    from tpu_plonk_torch.pcs import srs as srs_mod

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        return rc, buf.getvalue().strip()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    kernels.reset_counts()
    try:
        for name, extra in (("mock_circuit", []),
                            ("mock_circuit_zk", ["--blind", "mock-zk"])):
            out = os.path.join(tmp, name)
            t0 = time.perf_counter()
            rc, text = run_cli(["prove", "--engine", "device", "--out", out]
                               + extra)
            if rc != 0:
                raise AssertionError(f"cli prove {extra} exited {rc}: {text}")
            secs = time.perf_counter() - t0
            for ext in ("proof", "vk", "pi"):
                with open(f"{out}.{ext}", "rb") as f, open(os.path.join(
                        HERE, "tests", "vectors", f"{name}.{ext}"), "rb") as g:
                    if f.read() != g.read():
                        raise AssertionError(f"cli prove: {name}.{ext} "
                                             f"differs from the reference's")
            rc, text = run_cli(["verify", "--out", out])
            if rc != 0:
                raise AssertionError(f"cli verify of {name} exited {rc}: "
                                     f"{text}")
            with open(f"{out}.proof", "r+b") as f:
                data = bytearray(f.read())
                data[-40] ^= 1
                f.seek(0)
                f.write(data)
            rc_bad, text_bad = run_cli(["verify", "--out", out])
            if rc_bad != 1:
                raise AssertionError(f"cli verify of a flipped {name} "
                                     f"exited {rc_bad}: {text_bad}")
            say(f"phase 6 cli prove {name} (n = 4096) on the card: "
                f"{secs:.2f} s, .proof/.vk/.pi equal the reference's; "
                f"verify {text} (rc 0); one bit flipped: rc {rc_bad}")
    finally:
        shutil.rmtree(tmp)

    class Factor(Circuit):
        """Knowledge of p, q with p q = n for a public n."""

        def __init__(self, p, q):
            self.p, self.q = p, q

        def gadget(self, composer):
            a = composer.add_input(self.p)
            b = composer.add_input(self.q)
            c = composer.mul(1, a, b, 0)
            composer.constrain_to_constant(
                c, 0, (-(self.p * self.q)) % R_MOD)

    circ = Factor(31, 41)
    srs = srs_mod.setup(circ.padded_gates() + 8)
    pk, vd = circ.compile(srs)
    for seed in (None, b"smoke-circuit"):
        proof = circ.gen_proof(srs, pk, b"factors", blinding_seed=seed)
        pi = circ.public_inputs()
        if not verify_proof(proof, vd, pi, srs, b"factors"):
            raise AssertionError(f"Circuit API proof (seed {seed}) does "
                                 f"not verify")
        if verify_proof(proof, vd, [(pi[0] + 1) % R_MOD], srs, b"factors"):
            raise AssertionError("Circuit API proof verifies a wrong PI")
    say(f"phase 6 Circuit API on the card (n = {circ.padded_gates()}): "
        f"compile, gen_proof unblinded and blinded, verify_proof accepts "
        f"them and refuses a wrong public input")
    counts = kernels.counts()
    idle = [k for k in PROVE_KERNELS if counts[k] == 0]
    if idle:
        raise AssertionError(f"phase 6: launch counters did not rise: "
                             f"{idle}")
    say("phase 6 launches: " + json.dumps(counts))
    return counts


def phase_scale(torch, kernels, log_n: int, tmp: str):
    """Phase 7: the 2^log_n-gate Poseidon circuit through the cached
    preprocess in the temporary directory `tmp` (a miss, then a hit with
    equal keys; phase 8's ranks hit the entry again, and the caller
    deletes it), then one unblinded and one blinded prove on one
    DevicePK, both verified, with stage seconds, peak device memory and
    launches per prove.  Returns the path's launch counts (SRS to the
    last prove), the proofs' bytes by name and the verifier key."""
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system.preprocess import (
        cache_path, preprocess_device_cached)
    from tpu_plonk_torch.proof_system.engine_device import (
        prove_device, DevicePK)
    from tpu_plonk_torch.proof_system.verifier import verify

    total = {k: 0 for k in kernels.KERNELS}
    stages, peaks, commits = {}, {}, [0]

    def stage(name, fn):
        kernels.reset_counts()
        commits[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        counts = dict(kernels.counts(), commits=commits[0])
        for k in total:
            total[k] += counts[k]
        say(f"phase 7 {name}: {stages[name]:.3f} s, peak "
            f"{peaks[name]:.2f} GiB, launches {json.dumps(counts)}")
        return out, counts

    t0 = time.perf_counter()
    cs = poseidon_circuit(log_n)
    n = cs.padded_size()
    if n != 1 << log_n:
        raise AssertionError(f"padded size {n} != 2^{log_n}")
    say(f"phase 7 circuit: {cs.n_gates} gates, padded n = {n}, "
        f"{time.perf_counter() - t0:.3f} s")
    table, _ = stage("srs", lambda: srs_device.device_srs_points(n + 8))
    committer = srs_device.PackedCommitter(table)
    commit_one = committer.commit

    def counted_commit(coeffs):
        commits[0] += 1
        return commit_one(coeffs)
    committer.commit = counted_commit
    (mpk, mvk), _ = stage("preprocess_miss", lambda:
                          preprocess_device_cached(cs, committer, tmp))
    size = os.path.getsize(cache_path(cs, tmp))
    (pk, vk), hit = stage("preprocess_hit", lambda:
                          preprocess_device_cached(cs, committer, tmp))
    if hit["commits"] != 0 or hit["ntt"] != 0:
        raise AssertionError(f"the cache hit preprocessed again: {hit}")
    same = (vk.to_bytes() == mvk.to_bytes()
            and all(torch.equal(pk.selector_coeffs[k], v)
                    for k, v in mpk.selector_coeffs.items())
            and all(torch.equal(a, b)
                    for a, b in zip(pk.sigma_coeffs, mpk.sigma_coeffs)))
    if not same:
        raise AssertionError("the cache hit's keys differ from the miss's")
    say(f"phase 7 preprocess cache: entry of {size / 2**20:.1f} MiB, the "
        f"hit's tensors and verifier key equal the miss's")
    del mpk
    dpk, _ = stage("device_pk", lambda: DevicePK(pk))
    vsrs = srs_device.VerifierSRS()
    proofs = {}
    for name, seed, phases in (("prove", None, 4),
                               ("prove_zk", PROVE_SEED, 8)):
        rounds = {}
        proof, counts = stage(name, lambda: prove_device(
            cs, pk, committer, dpk=dpk, timings=rounds, blinding_seed=seed))
        proofs[name] = proof.to_bytes()
        check_prove_launches(name, counts, phases, f"2^{log_n}")
        if not verify(proof, vk, cs.pi, vsrs):
            raise AssertionError(f"2^{log_n} proof ({name}) does not verify")
        say(f"phase 7 {name} (first on the DevicePK) verified, "
            f"{len(proof.to_bytes())} bytes; rounds " + json.dumps(
                {k: round(v, 4) for k, v in rounds.items()}))
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"2^{log_n} path: kernels never launched: "
                             f"{missing}")
    say("phase 7 stages (s): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    say("phase 7 peak device memory (GiB): " + json.dumps(
        {k: round(v, 2) for k, v in peaks.items()}))
    return total, proofs, vk, cs.pi


def _rank_stage(torch, kernels, out, name, fn):
    """One stage of a rank: seconds, peak device memory (GiB) and launch
    counts into out[...][name]."""
    kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    value = fn()
    torch.cuda.synchronize()
    out["stages"][name] = time.perf_counter() - t0
    out["peaks"][name] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"][name] = kernels.counts()
    return value


def mesh_prove_rank(mesh, log_n: int, cache_dir: str):
    """Phase 8, one rank of the mesh: the 2^log_n Poseidon circuit, its SRS
    table on the card (this rank keeps its rows), the preprocess cache
    phase 7 wrote (must hit), then one unblinded and one blinded mesh
    prove.  Returns the proofs' bytes and each stage's seconds, peak
    memory, launches and commits."""
    import torch
    from tpu_plonk_torch import kernels
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.dist.msm_sharded import ShardedCommitter
    from tpu_plonk_torch.proof_system.preprocess import (
        preprocess_device_cached)
    from tpu_plonk_torch.proof_system.engine_device import (
        prove_device, DevicePK)

    out = {"stages": {}, "peaks": {}, "launches": {}, "rounds": {},
           "proofs": {}, "rank": mesh.rank, "size": mesh.size,
           "backend": mesh.backend, "device": str(mesh.device)}
    commits = [0]

    def stage(name, fn):
        commits[0] = 0
        value = _rank_stage(torch, kernels, out, name, fn)
        out["launches"][name]["commits"] = commits[0]
        return value

    cs = stage("circuit", lambda: poseidon_circuit(log_n))
    n = cs.padded_size()
    com = stage("srs", lambda: ShardedCommitter.from_table(
        mesh, srs_device.device_srs_points(n + 8)))
    commit_one = com.commit

    def counted_commit(coeffs):
        commits[0] += 1
        return commit_one(coeffs)
    com.commit = counted_commit
    pk, _ = stage("preprocess_hit", lambda: preprocess_device_cached(
        cs, com, cache_dir))
    hit = out["launches"]["preprocess_hit"]
    if hit["commits"] or hit["ntt"]:
        raise AssertionError(f"rank {mesh.rank}: the preprocess cache "
                             f"missed: {hit}")
    dpk = stage("device_pk", lambda: DevicePK(pk))
    for name, seed in (("mesh_prove", None), ("mesh_prove_zk", PROVE_SEED)):
        rounds = out["rounds"][name] = {}
        out["proofs"][name] = stage(name, lambda: prove_device(
            cs, pk, com, dpk=dpk, mesh=mesh, timings=rounds,
            blinding_seed=seed)).to_bytes()
    return out


def nccl_rank(mesh, log_n: int):
    """Phase 8, a group of one on nccl: the sharded NTT (batch 2: forward,
    inverse, coset-scaled) and a sharded commit of random 2^log_n
    coefficients against the single-device transform and commit."""
    import numpy as np
    import torch
    from tpu_plonk_torch import kernels
    from tpu_plonk_torch.poly import ntt
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.dist.msm_sharded import ShardedCommitter
    from tpu_plonk_torch.dist.ntt_sharded import ntt_replicated

    out = {"stages": {}, "peaks": {}, "launches": {}, "equal": {},
           "backend": mesh.backend, "size": mesh.size}
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    raw = rng.integers(0, 1 << 32, size=(2, n, 8), dtype=np.uint64)
    raw[..., 7] &= (1 << 29) - 1
    x = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(
        mesh.device)
    for inverse, scale in ((False, 1), (True, 1), (False, 7)):
        key = f"ntt_inverse={inverse}_scale={scale}"
        got = _rank_stage(torch, kernels, out, f"sharded_{key}",
                          lambda: ntt_replicated(mesh, x, log_n, inverse,
                                                 scale))
        want = _rank_stage(torch, kernels, out, f"single_{key}",
                           lambda: ntt.ntt_many(x, log_n, inverse, scale))
        out["equal"][key] = bool(torch.equal(got, want))
    table = srs_device.device_srs_points(n)
    coeffs = x[0]             # canonical words below r: Montgomery values
    sharded = ShardedCommitter.from_table(mesh, table)
    single = srs_device.PackedCommitter(table)
    got = _rank_stage(torch, kernels, out, "sharded_commit",
                      lambda: sharded.commit(coeffs))
    want = _rank_stage(torch, kernels, out, "single_commit",
                       lambda: single.commit(coeffs))
    out["equal"]["commit"] = got == want
    return out


def phase_mesh(torch, kernels, log_n: int, cache_dir: str, single: dict,
               vk, pi):
    """Phase 8: the mesh.  Two ranks share the card on gloo (nccl refuses
    two ranks on one device) and prove the 2^log_n Poseidon circuit,
    unblinded and blinded: both ranks' bytes must equal each other and
    phase 7's single-device proofs, and verify.  Then a group of one on
    nccl: the sharded NTT and commit at 2^log_n against the
    single-device ones.  Returns rank 0's launches per mesh prove and on
    the whole mesh path."""
    from tpu_plonk_torch.dist import multihost
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system.proof import Proof
    from tpu_plonk_torch.proof_system.verifier import verify

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = multihost.launch(mesh_prove_rank, 2, (log_n, cache_dir),
                             backend="gloo", store_dir=cache_dir,
                             timeout=600)
    wall = time.perf_counter() - t0
    for r in ranks:
        say(f"phase 8 rank {r['rank']} of {r['size']} ({r['backend']}, "
            f"{r['device']}, one card shared by both ranks): stages (s) "
            + json.dumps({k: round(v, 3) for k, v in r["stages"].items()})
            + "; peak GiB " + json.dumps(
                {k: round(v, 2) for k, v in r["peaks"].items()})
            + "; rounds (s) " + json.dumps(
                {k: {q: round(v, 4) for q, v in d.items()}
                 for k, d in r["rounds"].items()}))
    for name, ref, phases in (("mesh_prove", "prove", 4),
                              ("mesh_prove_zk", "prove_zk", 8)):
        got = {r["proofs"][name] for r in ranks}
        if got != {single[ref]}:
            raise AssertionError(f"phase 8 {name}: the ranks' proofs differ "
                                 f"from each other or from phase 7's")
        for r in ranks:
            check_prove_launches(name, r["launches"][name], phases,
                                 f"2^{log_n} mesh rank {r['rank']}")
        if not verify(Proof.from_bytes(single[ref]), vk, pi,
                      srs_device.VerifierSRS()):
            raise AssertionError(f"phase 8 {name}: the proof does not "
                                 f"verify")
        say(f"phase 8 {name}: both ranks' {len(single[ref])} bytes equal "
            f"phase 7's single-device proof, verified; launches per rank "
            + json.dumps(ranks[0]["launches"][name]))
    say(f"phase 8 two-rank launch: {wall:.1f} s wall, spawn and CUDA start "
        f"included")
    t0 = time.perf_counter()
    (one,) = multihost.launch(nccl_rank, 1, (log_n,), backend="nccl",
                              store_dir=cache_dir, timeout=300)
    wall1 = time.perf_counter() - t0
    if one["backend"] != "nccl" or not all(one["equal"].values()):
        raise AssertionError(f"phase 8 nccl: {one['equal']}")
    say(f"phase 8 nccl group of one at 2^{log_n}: sharded equals single "
        + json.dumps(one["equal"]) + "; seconds " + json.dumps(
            {k: round(v, 4) for k, v in one["stages"].items()})
        + f"; {wall1:.1f} s wall")
    path = ("srs", "preprocess_hit", "device_pk", "mesh_prove",
            "mesh_prove_zk")
    total = {k: sum(ranks[0]["launches"][s][k] for s in path)
             for k in kernels.KERNELS}
    missing = [k for k in PROVE_KERNELS if total[k] == 0]
    if missing:
        raise AssertionError(f"phase 8: kernels never launched on the mesh "
                             f"path: {missing}")
    return {"mesh_prove": ranks[0]["launches"]["mesh_prove"],
            "mesh_prove_zk": ranks[0]["launches"]["mesh_prove_zk"],
            "path": total}


def phase_poseidon_checkpoint(torch, kernels, ctx: dict):
    """Phase 9: sponge_hash_device on 2^16 three-element messages against
    its plain version (whole batch) and the host sponge (64 of them);
    then a 2^18 checkpointed prove that fails in round 3 on purpose and
    resumes, whose bytes must be phase 4's.  Returns the launches of
    the sponge and of the resumed prove."""
    import shutil
    import tempfile
    import numpy as np
    from tpu_plonk_torch.params import R_MOD
    from tpu_plonk_torch.gadgets import poseidon, poseidon_device
    from tpu_plonk_torch.proof_system import engine_device
    from tpu_plonk_torch.utils.checkpoint import RoundCheckpoint

    rng = np.random.default_rng(16)
    vals = [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(3 << 16)]
    msgs = [vals[i:i + 3] for i in range(0, len(vals), 3)]
    out = {"stages": {}, "peaks": {}, "launches": {}}
    got = _rank_stage(torch, kernels, out, "sponge",
                      lambda: poseidon_device.sponge_hash_device(msgs))
    plain = _rank_stage(torch, kernels, out, "sponge_plain",
                        lambda: poseidon_device.sponge_hash_plain(msgs,
                                                                  "cuda"))
    if got != plain:
        raise AssertionError("phase 9: the sponge's kernels and its plain "
                             "version differ")
    sample = rng.choice(len(msgs), 64, replace=False)
    if any(got[i] != poseidon.sponge_hash(msgs[i]) for i in sample):
        raise AssertionError("phase 9: the sponge differs from the host's")
    sponge = out["launches"]["sponge"]
    say(f"phase 9 sponge_hash_device, 2^16 messages of 3: "
        f"{out['stages']['sponge']:.3f} s (plain version "
        f"{out['stages']['sponge_plain']:.3f} s), equal to the plain "
        f"version on all and to the host sponge on 64; launches "
        f"{json.dumps(sponge)}")

    def broken(*args):
        raise RuntimeError("round 3 fails on purpose")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    path = os.path.join(tmp, "prove.ckpt")
    quotient_dev = engine_device.quotient_phase_dev
    try:
        engine_device.quotient_phase_dev = broken
        try:
            engine_device.prove_device(ctx["cs"], ctx["pk"], ctx["committer"],
                                       dpk=ctx["dpk"],
                                       ckpt=RoundCheckpoint(path))
            raise AssertionError("phase 9: the broken prove did not fail")
        except RuntimeError as e:
            if "on purpose" not in str(e):
                raise
        finally:
            engine_device.quotient_phase_dev = quotient_dev
        saved = RoundCheckpoint(path).completed()
        if saved != ["r1", "r2"]:
            raise AssertionError(f"phase 9: rounds saved {saved}")
        ck = RoundCheckpoint(path)
        proof = _rank_stage(torch, kernels, out, "resumed", lambda:
                            engine_device.prove_device(
                                ctx["cs"], ctx["pk"], ctx["committer"],
                                dpk=ctx["dpk"], ckpt=ck))
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp)
    if proof.to_bytes() != ctx["proof"]:
        raise AssertionError("phase 9: the resumed proof differs from "
                             "phase 4's")
    resumed = out["launches"]["resumed"]
    if resumed["g1_bucket_weight"] != 6:
        raise AssertionError(f"phase 9: the resumed prove committed "
                             f"{resumed['g1_bucket_weight']} times, not 6 "
                             f"(rounds 3 and 5)")
    say(f"phase 9 checkpointed 2^{LOG_N} prove: failed in round 3 on "
        f"purpose with {saved} saved, resumed in "
        f"{out['stages']['resumed']:.3f} s to phase 4's bytes (checkpoint "
        f"{size / 2**20:.1f} MiB); launches {json.dumps(resumed)}")
    return {"sponge": sponge, "resumed": resumed}


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
    stages, counts, rounds, ctx = phase_prove(torch, kernels)

    main_path = ("srs", "preprocess", "device_pk", "prove_first",
                 "prove_steady", "prove_zk_first", "prove_zk_steady")
    total = {k: sum(counts[s][k] for s in main_path) for k in kernels.KERNELS}
    for name, m in metrics.items():
        m["launches"] = total[name]
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the path: {missing}")
    for name, phases in (("prove_steady", 4), ("prove_zk_steady", 8)):
        check_prove_launches(name, counts[name], phases, "2^18")
        say(f"phase 4 launches per {name} 2^18 prove: "
            + json.dumps(counts[name]))
    for k in ("fp_mont_mul", "g1_add"):
        if counts["srs"][k] == 0:
            raise AssertionError(f"launch counters did not rise in the SRS "
                                 f"stage: {k}")
    say("phase 4 stages (s): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))

    entry = phase_entry_points(torch, kernels)
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_ppcache_")
    try:
        scale, single, vk, pi = phase_scale(torch, kernels, SCALE_LOG_N,
                                            cache_dir)
        mesh = phase_mesh(torch, kernels, SCALE_LOG_N, cache_dir, single,
                          vk, pi)
    finally:
        shutil.rmtree(cache_dir)
    later = phase_poseidon_checkpoint(torch, kernels, ctx)
    for name, m in metrics.items():
        m["launches_entry_points"] = entry[name]
        m[f"launches_2^{SCALE_LOG_N}"] = scale[name]
        m[f"launches_mesh_2^{SCALE_LOG_N}_path_rank0"] = mesh["path"][name]
        m["launches_per_mesh_prove"] = mesh["mesh_prove"][name]
        m["launches_per_mesh_prove_zk"] = mesh["mesh_prove_zk"][name]
        m["launches_sponge_2^16"] = later["sponge"][name]
        m["launches_resumed_prove"] = later["resumed"][name]

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
