"""Typed configuration of the command line (mirrors
tpu_plonk/utils/config.py): a dataclass + argparse, no dynamic flag
system.

`--engine` keeps the reference's spelling: `device` runs on the card
(the CUDA kernels), `host` on the CPU (their plain PyTorch versions);
the port has no host prover of its own.  The default is `device` (the
reference's is `host`): the port's entry points run on the card unless
the caller asks for the CPU.  `--checkpoint` names the round-boundary
resume file of `demo`'s prove (utils/checkpoint.py; the reference's
memoizes its host prover, the port's `prove_device`).  The reference's
`--msm-window-bits` and `--mesh-devices`, which its commands never
read, are not carried over."""

import argparse
import dataclasses


@dataclasses.dataclass
class Config:
    log_gates: int = 10           # circuit size target (2^k gates)
    engine: str = "device"        # 'device' (the card) | 'host' (CPU)
    checkpoint: str = ""          # round-boundary resume file ('' = off)
    blind: str = ""               # ZK blinding seed ('' = deterministic)
    out: str = ""                 # artifact path prefix for prove/verify

    @property
    def device(self):
        """The torch device the engine names: None (the card) or 'cpu'."""
        return None if self.engine == "device" else "cpu"


def parse_args(argv=None) -> Config:
    p = argparse.ArgumentParser(prog="tpu-plonk-torch")
    p.add_argument("--log-gates", type=int, default=10)
    p.add_argument("--engine", choices=["host", "device"],
                   default="device",
                   help="device: the CUDA kernels on the card; host: "
                        "their plain PyTorch versions on the CPU")
    p.add_argument("--checkpoint", default="",
                   help="resume file: prover rounds memoized at this "
                        "path survive a crash/restart")
    p.add_argument("--blind", default="",
                   help="ZK variant: seed for deterministic blinding "
                        "(5-chunk quotient, 1088-byte proofs); keep "
                        "the seed secret and fresh per proof")
    p.add_argument("--out", default="",
                   help="artifact path prefix: prove writes "
                        "<out>.proof/.vk/.pi, verify reads them")
    a = p.parse_args(argv)
    return Config(log_gates=a.log_gates, engine=a.engine,
                  checkpoint=a.checkpoint, blind=a.blind, out=a.out)
