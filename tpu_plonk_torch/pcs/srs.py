"""Structured reference string (KZG public parameters), on the host
(mirrors tpu_plonk/pcs/srs.py; the card's generator is srs_device).

`setup` mirrors dusk-plonk's `PublicParameters::setup` (SURVEY.md §3.4)
with a deterministic, seed-derived tau — INSECURE by construction, for
testing/benchmarking; production deployments must import a ceremony SRS
via `from_bytes`/`to_bytes` (dusk-bytes-style layout: 8-byte LE count,
48-byte compressed G1 powers, two 96-byte compressed G2 points).

G1 powers are generated with an incremental double-and-add over the
bits of tau^i (host, cached to disk via `cached_setup`).  The pickle
cache under .cache/ is a TRUSTED local artifact (pickle executes code on
load); external/ceremony SRS data must come through `from_bytes`, which
fully validates every point.  The port's pickles are named
`torch_srs_{size}.pkl`: the reference's `srs_{size}.pkl` in the same
directory holds the reference's classes, and unpickling it would import
the reference package.
"""

import hashlib
import os
import pickle

from ..params import R_MOD
from ..curves import g1, g2
from . import msm as hostmsm


class SRS:
    def __init__(self, powers_g1, g2_gen, g2_tau):
        self.powers_g1 = powers_g1    # [ [tau^i]G1 ] affine
        self.g2_gen = g2_gen          # [1]G2
        self.g2_tau = g2_tau          # [tau]G2

    @property
    def max_degree(self) -> int:
        return len(self.powers_g1) - 1

    def trim(self, degree: int) -> "SRS":
        assert degree <= self.max_degree
        return SRS(self.powers_g1[: degree + 1], self.g2_gen, self.g2_tau)

    def to_bytes(self) -> bytes:
        out = [len(self.powers_g1).to_bytes(8, "little")]
        out += [g1.to_bytes(p) for p in self.powers_g1]
        out += [g2.to_bytes(self.g2_gen), g2.to_bytes(self.g2_tau)]
        return b"".join(out)

    @staticmethod
    def from_bytes(data: bytes) -> "SRS":
        count = int.from_bytes(data[:8], "little")
        if len(data) != 8 + 48 * count + 192:
            raise ValueError("bad SRS length")
        off = 8
        powers = []
        for _ in range(count):
            powers.append(g1.from_bytes(data[off:off + 48]))
            off += 48
        gg = g2.from_bytes(data[off:off + 96])
        gt = g2.from_bytes(data[off + 96:off + 192])
        return SRS(powers, gg, gt)


def setup(max_degree: int, seed: bytes = b"tpu-plonk insecure srs") -> SRS:
    """Deterministic test SRS: tau = H(seed) mod r."""
    tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % R_MOD
    powers = [g1.GEN]
    tp = 1
    # incremental: [tau^{i+1}]G = tau * [tau^i]G via windowed mult on the
    # scalar (host); cost ~max_degree * 300 Jacobian ops
    jac = hostmsm.jac_from_affine(g1.GEN)
    for _ in range(max_degree):
        jac = _jac_scalar_mul(jac, tau)
        powers.append(hostmsm.jac_to_affine(jac))
        tp = tp * tau % R_MOD
    return SRS(powers, g2.GEN, g2.mul(g2.GEN, tau))


def _jac_scalar_mul(p, k: int):
    acc = hostmsm.J_INF
    while k:
        if k & 1:
            acc = hostmsm.jac_add(acc, p)
        p = hostmsm.jac_double(p)
        k >>= 1
    return acc


_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".cache")


def cached_setup(max_degree: int) -> SRS:
    """Disk-cached deterministic SRS (tests & benches reuse it across
    runs; sizes are padded up to powers of two to maximize reuse)."""
    size = 8
    while size < max_degree + 1:
        size *= 2
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = os.path.join(_CACHE_DIR, f"torch_srs_{size}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            srs = pickle.load(f)
    else:
        srs = setup(size - 1)
        # written whole, then renamed: a concurrent reader never sees a
        # partial pickle
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(srs, f)
        os.replace(tmp, path)
    return srs.trim(max_degree)
