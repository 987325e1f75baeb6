"""Command-line entry of the port: `python -m tpu_plonk_torch.cli <cmd>`
(mirrors tpu_plonk/cli.py: the same commands and output keys).

Commands:
  demo        build the MockCircuit, prove, verify, print per-stage
              metrics JSON (exit 0 iff verified)
  prove       prove the MockCircuit and write <out>.proof/.vk/.pi
              artifacts
  verify      load <out>.proof/.vk/.pi and verify (validating codecs —
              the untrusted-input path; needs only the SRS's two G2
              points)
  setup       generate the SRS table of 2^log_gates + 8 points
  cache-warm  fill the preprocess cache (preprocess_device_cached, under
              preprocess.DEFAULT_CACHE_DIR) for a 2^log_gates arithmetic
              circuit and prove it once
  info        torch's version and the CUDA devices

`--engine device` (the default) runs on the card, `--engine host` on
the CPU through the plain versions (utils/config.py).  `main(argv)` may
be called in-process; it returns the exit code.
"""

import json
import sys
import time

from .params import R_MOD
from .circuits.mock_circuit import build_mock_circuit
from .cs import Composer
from .pcs import srs_device
from .proof_system.engine_device import prove_device, DevicePK
from .proof_system.preprocess import (
    VerifierKey, preprocess_device, preprocess_device_cached)
from .proof_system.proof import Proof
from .proof_system.verifier import verify
from .utils.config import parse_args
from .utils.metrics import Metrics


def _mock_circuit():
    composer, _pub = build_mock_circuit(
        note_value=10_000, private_key=0xDEADBEEF,
        hash_inputs=[1, 2, 3, 4], tx_value=7_000, gas_fee=500)
    return composer


def _committer(n: int, cfg):
    """A committer over the SRS table of n + 8 points, generated on the
    engine's device."""
    return srs_device.PackedCommitter(
        srs_device.device_srs_points(n + 8, device=cfg.device))


def _seed(cfg):
    return cfg.blind.encode() or None


def cmd_demo(cfg):
    met = Metrics()
    with met.timed("compose"):
        composer = _mock_circuit()
    n = composer.padded_size()
    met.count("gates", composer.n_gates)
    met.count("padded", n)
    with met.timed("srs"):
        committer = _committer(n, cfg)
    with met.timed("preprocess"):
        pk, vk = preprocess_device(composer, committer, cfg.device)
    with met.timed("prove"):
        proof = prove_device(composer, pk, committer, device=cfg.device,
                             blinding_seed=_seed(cfg))
    with met.timed("verify"):
        ok = verify(proof, vk, composer.pi, srs_device.VerifierSRS())
    met.count("proof_bytes", len(proof.to_bytes()))
    out = met.to_dict()
    out["verified"] = ok
    print(json.dumps(out, sort_keys=True))
    return 0 if ok else 1


def cmd_prove(cfg):
    """Prove the demo circuit; write proof/vk/public-input artifacts
    (dusk-bytes-style encodings) under the --out prefix."""
    if not cfg.out:
        print("prove needs --out <prefix>", file=sys.stderr)
        return 2
    composer = _mock_circuit()
    committer = _committer(composer.padded_size(), cfg)
    pk, vk = preprocess_device(composer, committer, cfg.device)
    proof = prove_device(composer, pk, committer, device=cfg.device,
                         blinding_seed=_seed(cfg))
    with open(cfg.out + ".proof", "wb") as f:
        f.write(proof.to_bytes())
    with open(cfg.out + ".vk", "wb") as f:
        f.write(vk.to_bytes())
    with open(cfg.out + ".pi", "w") as f:
        json.dump({str(k): v for k, v in composer.pi.items()}, f)
    print(json.dumps({"proof_bytes": len(proof.to_bytes()),
                      "out": cfg.out}))
    return 0


def cmd_verify(cfg):
    """Load artifacts written by `prove` and verify.  Everything comes
    through the validating from_bytes codecs — this is the
    untrusted-input path a proof consumer runs."""
    if not cfg.out:
        print("verify needs --out <prefix>", file=sys.stderr)
        return 2
    try:
        with open(cfg.out + ".proof", "rb") as f:
            proof = Proof.from_bytes(f.read())
        with open(cfg.out + ".vk", "rb") as f:
            vk = VerifierKey.from_bytes(f.read())
        with open(cfg.out + ".pi") as f:
            pi = {int(k): int(v) % R_MOD
                  for k, v in json.load(f).items()}
    except (ValueError, TypeError, OSError, json.JSONDecodeError) as e:
        print(json.dumps({"verified": False,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    t0 = time.time()
    ok = verify(proof, vk, pi, srs_device.VerifierSRS())
    print(json.dumps({"verified": ok,
                      "verify_ms": round((time.time() - t0) * 1e3, 1)}))
    return 0 if ok else 1


def cmd_setup(cfg):
    t0 = time.time()
    table = srs_device.device_srs_points((1 << cfg.log_gates) + 8,
                                         device=cfg.device)
    print(json.dumps({"max_degree": table.shape[0] - 1,
                      "seconds": round(time.time() - t0, 2)}))
    return 0


def cmd_cache_warm(cfg):
    """Fill the preprocess cache for the 2^log_gates arithmetic circuit
    (selector/sigma coefficients + commitments, keyed by circuit hash)
    and prove once, so that a later run reaches its steady prove
    without the 15 preprocessing transforms and commits."""
    t0 = time.time()
    cs = Composer()
    prev = cs.add_input(3)
    while cs.n_gates < (1 << cfg.log_gates) - 1:
        prev = cs.mul(1, prev, prev, 3)
    n = cs.padded_size()
    committer = _committer(n, cfg)
    srs_s = round(time.time() - t0, 1)
    t0 = time.time()
    pk, vk = preprocess_device_cached(cs, committer, verbose=True,
                                      device=cfg.device)
    pp_s = round(time.time() - t0, 1)
    t0 = time.time()
    prove_device(cs, pk, committer, dpk=DevicePK(pk), device=cfg.device)
    print(json.dumps({"n": n, "srs_s": srs_s, "preprocess_s": pp_s,
                      "prove_compile_s": round(time.time() - t0, 1),
                      "backend": committer.device.type}))
    return 0


def cmd_info(_cfg):
    import torch
    cuda = torch.cuda.is_available()
    print(json.dumps({
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "backend": "cuda" if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmds = {"demo": cmd_demo, "prove": cmd_prove, "verify": cmd_verify,
            "setup": cmd_setup, "info": cmd_info,
            "cache-warm": cmd_cache_warm}
    if not argv or argv[0] not in cmds:
        print("usage: python -m tpu_plonk_torch.cli "
              "{demo|prove|verify|setup|info|cache-warm} [options]",
              file=sys.stderr)
        return 2
    cfg = parse_args(argv[1:])
    return cmds[argv[0]](cfg)


if __name__ == "__main__":
    sys.exit(main())
