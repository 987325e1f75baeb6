"""SRS generation on the device (mirrors the walk generator of
tpu_plonk/pcs/srs_device.py) and the committer over its table.

[tau^i]G = sum_w d_{i,w} [2^(c w)]G for the signed digits d of tau^i, and
[d 2^(c w)]G over all (w, 1 <= d <= 2^(c-1)) is a small table (81,920
points at c = 13).  So: build that table on the device (a doubling
ladder of batched G1 adds from the W host-computed bases, then one Fp
batch inversion to affine), derive every tau^i on the device (a
prefix-product scan), extract signed digits, and walk each point's W
table indices with the same CSR walk kernel the MSM uses (one row per
point).  A final batch inversion makes the table affine, as the
committer's walk requires.  Same deterministic, INSECURE tau as the
reference's host setup, so the points are the same.
"""

import hashlib

import numpy as np
import torch

from ..params import R_MOD
from ..kernels import resolve_device
from ..curves import g1
from ..curves import device_g1 as dg1
from ..fields import device as dev
from . import csr_device
from . import msm_csr
from .commit_device import DeviceCommitter

SEED = b"tpu-plonk insecure srs"


def _tau() -> int:
    """The reference host setup's tau (the same SEED, the same hash)."""
    return int.from_bytes(hashlib.sha512(SEED).digest(), "little") % R_MOD


def normalize_affine(pts):
    """(N, 3, 12) projective points (none the identity) -> (N, 2, 12)
    affine, by one Fp batch inversion of z."""
    z = pts[:, 2]
    if bool(dev.is_zero(z).any()):
        raise ValueError("affine tables cannot hold the identity")
    zinv = dev.batch_inv_mont(z, dev.FP)
    return torch.stack([dev.mont_mul(pts[:, 0], zinv, dev.FP),
                        dev.mont_mul(pts[:, 1], zinv, dev.FP)], dim=1)


def walk_table(c: int, n_windows: int, device):
    """(W * 2^(c-1), 2, 12) affine table of [d 2^(c w)]G, row
    w * 2^(c-1) + d - 1."""
    B = 1 << (c - 1)
    bases = [g1.mul(g1.GEN, pow(2, c * w, R_MOD)) for w in range(n_windows)]
    tbl = dg1.points_to_device(bases, device)[:, None]      # (W, 1, 3, 12)
    h = 1
    while h < B:   # multiples h+1 .. 2h = multiples 1..h plus [h]P
        tbl = torch.cat([tbl, dg1.add(tbl, tbl[:, h - 1:h])], dim=1)
        h *= 2
    return normalize_affine(tbl.reshape(-1, 3, dg1.W))


def digits_to_idx(canon, c: int, n_windows: int):
    """(N, 8) canonical words -> (N, W) int32 signed 1-based walk-table
    indices sign(d) * (w 2^(c-1) + |d|), 0 for a zero digit."""
    sd = csr_device.digits_signed(canon, c, n_windows)          # (W, N)
    half = 1 << (c - 1)
    off = torch.arange(n_windows, device=sd.device)[:, None] * half
    idx = torch.where(sd == 0, 0, torch.sign(sd) * (sd.abs() + off))
    return idx.T.contiguous().to(torch.int32)


def device_srs_points(max_len: int, device=None):
    """(max_len, 2, 12) affine Montgomery table of [tau^i]G1, i <
    max_len, generated on `device` (cuda unless named)."""
    dv = resolve_device(device)
    c = csr_device.default_c(max_len)
    W = msm_csr.signed_window_count(c)
    tau = _tau()
    tbl = walk_table(c, W, dv)
    taus = dev.powers_of(dev.FR.const(tau, dv), max_len, dev.FR)
    idx = digits_to_idx(dev.from_mont(taus, dev.FR), c, W)
    rows = torch.arange(max_len, dtype=torch.int32, device=dv)
    pts = dg1.accumulate_csr(tbl, True, idx.reshape(-1), rows * W,
                             torch.full_like(rows, W))
    out = normalize_affine(pts)
    # spot-check against the host before anything consumes the table
    rng = np.random.default_rng(0)
    for i in sorted({0, max_len - 1, *map(int, rng.integers(0, max_len, 2))}):
        if dg1.affine_from_device(out[i:i + 1]) != [
                g1.mul(g1.GEN, pow(tau, i, R_MOD))]:
            raise AssertionError(f"SRS row {i} diverges from [tau^i]G")
    return out


def srs_g2():
    """([1]G2, [tau]G2) for the verifier's opening key."""
    from ..curves import g2
    return g2.GEN, g2.mul(g2.GEN, _tau())


class VerifierSRS:
    """The two G2 points the verifier's pairing check reads."""

    def __init__(self):
        self.g2_gen, self.g2_tau = srs_g2()


class PackedCommitter(DeviceCommitter):
    """DeviceCommitter over an affine table already on the device (e.g.
    from device_srs_points)."""

    def __init__(self, packed):
        self._bind(packed)
