"""Checkpoint / resume (mirrors tpu_plonk/utils/checkpoint.py): persist
the prover's per-round state so a failed prove resumes at the last
round boundary (rounds are the natural checkpoints).

`prove_device(..., ckpt=RoundCheckpoint(path))` saves each round's
outputs as host data (`to_host`: tensors become numpy arrays; ints,
points and containers stay as they are) and a restart loads them back
onto its device (`to_device`).  The transcript is not stored: it
replays deterministically from the saved commitments.  `transcript_state`
/ `restore_transcript` serialise one anyway, through its strobe bytes
and positions.

SECURITY: checkpoint files are TRUSTED local artifacts: pickle.load
executes code, so a checkpoint path must point at a file this process
(or an equally trusted one) wrote.  Untrusted inputs (proofs, keys)
have their own validating codecs and never go through this module.
"""

import os
import pickle

import numpy as np
import torch


def save(path: str, payload) -> None:
    """Pickle `payload` to `path`, replacing it whole (a reader never
    sees a partial file)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def transcript_state(t) -> dict:
    s = t.strobe
    return {"state": bytes(s.state), "pos": s.pos,
            "pos_begin": s.pos_begin, "cur_flags": s.cur_flags}


def restore_transcript(state: dict):
    from ..transcript import Transcript
    from ..transcript.strobe import Strobe128
    s = Strobe128.__new__(Strobe128)
    s.state = bytearray(state["state"])
    s.pos = state["pos"]
    s.pos_begin = state["pos_begin"]
    s.cur_flags = state["cur_flags"]
    t = Transcript.__new__(Transcript)
    t.strobe = s
    return t


def to_host(value):
    """A round's outputs with every tensor as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    return value


def to_device(value, device):
    """to_host's output with every numpy array as a tensor on `device`."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value).to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: to_device(v, device) for k, v in value.items()}
    return value


class RoundCheckpoint:
    """Round-boundary memo for the prover: pass `ckpt=RoundCheckpoint(
    path)` to prove_device; each round's outputs are saved after they
    are computed, and a restart loads them instead of computing them
    again."""

    def __init__(self, path: str):
        self.path = path
        self.data = load(path) if os.path.exists(path) else {}

    def memo(self, key: str, fn):
        if key in self.data:
            return self.data[key]
        value = fn()
        self.data[key] = value
        save(self.path, self.data)
        return value

    def completed(self):
        return sorted(self.data)
