"""End-to-end scale prove of the PyTorch + CUDA port on one card (the
counterpart of scripts/prove_scale.py): build a 2^log_gates circuit,
generate the SRS on the card, preprocess through
preprocess_device_cached (its default directory, outside the
repository), prove twice (first, steady) with prove_device, verify on
the host and check that a tampered proof is rejected, then trace one
more steady prove (device time and launches by port kernel).

Usage:  python3 scripts/torch_prove_scale.py [log_gates] [--poseidon]
            [--blind] [--tag=NAME]

Prints a line per stage and, last, one JSON line: stage seconds and
peak device memory (torch.cuda.max_memory_allocated, per stage and
overall), whether the preprocess cache hit, per-round seconds and
kernel launches of the steady prove, the traced prove's kernel times,
and the card's `nvidia-smi` name and power limit.  Writes nothing into
the repository.  Needs a CUDA device; exits 2 without one.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_circuit(log_gates: int, poseidon: bool):
    """scripts/prove_scale.py:build_circuit on the port's composer."""
    from tpu_plonk_torch.cs import Composer
    from tpu_plonk_torch.gadgets import poseidon as pos

    cs = Composer()
    prev = cs.add_input(3)
    if poseidon:
        # config-3 shape: Poseidon sponge gadgets + arithmetic fill
        h = pos.sponge_gadget(cs, [prev, cs.add_input(5), cs.add_input(7),
                                   cs.add_input(11)])
        prev = h
    target = (1 << log_gates) - 1
    while cs.n_gates < target:
        prev = cs.mul(1, prev, prev, 3)
    return cs


def main() -> int:
    log_gates = int(sys.argv[1]) if len(sys.argv) > 1 and \
        not sys.argv[1].startswith("--") else 18
    poseidon = "--poseidon" in sys.argv
    blind = b"prove-scale-blind-seed" if "--blind" in sys.argv else None
    tag = next((a.split("=", 1)[1] for a in sys.argv
                if a.startswith("--tag=")), "")

    import torch
    if not torch.cuda.is_available():
        print("torch_prove_scale: no CUDA device", file=sys.stderr)
        return 2
    from tpu_plonk_torch import kernels
    from tpu_plonk_torch.params import R_MOD
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.proof_system.preprocess import (
        cache_path, preprocess_device_cached)
    from tpu_plonk_torch.proof_system.engine_device import (
        prove_device, DevicePK)
    from tpu_plonk_torch.proof_system.proof import Proof
    from tpu_plonk_torch.proof_system.verifier import verify
    from tpu_plonk_torch.utils import profiling

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"log_gates": log_gates, "poseidon": poseidon, "tag": tag,
           "blind": blind is not None, "card": card,
           "device": torch.cuda.get_device_name(0), "stages_s": {},
           "peak_gb": {}}
    print(f"card: {card}", flush=True)

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["stages_s"][name] = time.perf_counter() - t0
        out["peak_gb"][name] = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name}: {out['stages_s'][name]:.3f} s, peak "
              f"{out['peak_gb'][name]:.2f} GiB", flush=True)
        return res

    kernels.library()         # the build is set-up, not a stage
    cs = stage("compose", lambda: build_circuit(log_gates, poseidon))
    n = cs.padded_size()
    out.update(n=n, gates=cs.n_gates)
    table = stage("srs", lambda: srs_device.device_srs_points(n + 8))
    committer = srs_device.PackedCommitter(table)
    commit_one, commits = committer.commit, [0]

    def counted_commit(coeffs):
        commits[0] += 1
        return commit_one(coeffs)
    committer.commit = counted_commit
    out["preprocess_cache"] = ("hit" if os.path.exists(cache_path(cs))
                               else "miss")
    pk, vk = stage("preprocess",
                   lambda: preprocess_device_cached(cs, committer))
    dpk = stage("device_pk", lambda: DevicePK(pk))

    def prove(timings=None):
        return prove_device(cs, pk, committer, dpk=dpk, timings=timings,
                            blinding_seed=blind)
    first = stage("prove_first", prove)
    rounds = {}
    kernels.reset_counts()
    commits[0] = 0
    proof = stage("prove_steady", lambda: prove(rounds))
    out["rounds_s"] = rounds
    out["launches_steady"] = dict(kernels.counts(), commits=commits[0])
    if proof.to_bytes() != first.to_bytes():
        raise AssertionError("first and steady proofs differ")
    vsrs = srs_device.VerifierSRS()
    out["verified"] = stage("verify",
                            lambda: verify(proof, vk, cs.pi, vsrs))
    bad = Proof.from_bytes(proof.to_bytes())
    bad.evals["a"] = (bad.evals["a"] + 1) % R_MOD
    out["tampered_rejected"] = not verify(bad, vk, cs.pi, vsrs)
    out["proof_bytes"] = len(proof.to_bytes())
    wall, busy, port, top = profiling.trace(prove)
    out["traced"] = {"wall_s": wall, "busy_s": busy, "port": port,
                     "top": top}
    out["max_memory_allocated_gb"] = max(out["peak_gb"].values())
    print(json.dumps(out), flush=True)
    return 0 if out["verified"] and out["tampered_rejected"] else 1


if __name__ == "__main__":
    sys.exit(main())
