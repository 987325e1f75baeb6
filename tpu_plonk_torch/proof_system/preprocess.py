"""Preprocessing on the device (mirrors tpu_plonk/proof_system/
preprocess.py): ProverKey / VerifierKey (copied from the reference) and
`preprocess_device`, which iNTTs the selector and sigma columns and
commits them on the device.  No disk cache: every call recomputes.

In the port's ProverKey the coefficient tables are (n, 8) Montgomery
word tensors on the device, and the host extended-coset fields are
None (the phased quotient derives what it needs from the coefficients).
"""

import dataclasses

import torch

from ..poly.domain import Domain
from ..cs.permutation import build_sigma_evals
from ..cs.composer import SELECTOR_NAMES


@dataclasses.dataclass
class ProverKey:
    n: int
    domain: Domain
    ext_domain: Domain
    selector_coeffs: dict    # name -> coeff list
    selector_ext: dict       # name -> evals over 4n coset
    sigma_coeffs: list       # 4 coeff lists
    sigma_ext: list          # 4 eval lists over 4n coset
    wire_vars: dict          # padded wire index table (a/b/c/d -> [var])
    l1_ext: list             # L1(X) over 4n coset
    zh_inv_ext: list         # 1/Z_H(X) over 4n coset (period 4)
    coset_points: list       # the 4n coset points g*w4n^i


@dataclasses.dataclass
class VerifierKey:
    n: int
    selector_commits: dict   # name -> G1
    sigma_commits: list      # 4 G1 points

    def to_bytes(self) -> bytes:
        """8-byte LE n, then 48-byte compressed commitments in fixed
        order (selectors by SELECTOR_NAMES, then sigma 1..4) — the
        dusk-bytes-style layout for key exchange/persistence."""
        from ..curves import g1
        out = [self.n.to_bytes(8, "little")]
        out += [g1.to_bytes(self.selector_commits[name])
                for name in SELECTOR_NAMES]
        out += [g1.to_bytes(c) for c in self.sigma_commits]
        return b"".join(out)

    #: largest circuit size a decoded key may claim — bounds the SRS /
    #: domain work an UNTRUSTED .vk file can trigger downstream
    MAX_LOG_N = 28

    @staticmethod
    def from_bytes(data: bytes) -> "VerifierKey":
        from ..curves import g1
        expect = 8 + 48 * (len(SELECTOR_NAMES) + 4)
        if len(data) != expect:
            raise ValueError(
                f"VerifierKey encoding must be {expect} bytes")
        n = int.from_bytes(data[:8], "little")
        if n < 1 or n & (n - 1) or n > (1 << VerifierKey.MAX_LOG_N):
            raise ValueError(
                "VerifierKey n must be a power of two within bounds")
        off = 8
        sels = {}
        for name in SELECTOR_NAMES:
            sels[name] = g1.from_bytes(data[off:off + 48])
            off += 48
        sigmas = []
        for _ in range(4):
            sigmas.append(g1.from_bytes(data[off:off + 48]))
            off += 48
        return VerifierKey(n, sels, sigmas)


def preprocess_device(composer, committer, device=None):
    """Selector and sigma columns -> coefficient tensors (one batched
    iNTT each) and their commitments.  `device` (cuda unless named) must
    be the committer's.  Returns (ProverKey, VerifierKey)."""
    from ..poly import ntt as nttmod
    from .engine_device import to_dev, check_committer

    dv = check_committer(committer, device)
    n = composer.padded_size()
    log_n = n.bit_length() - 1
    pad = n - composer.n_gates
    wire_vars = {w: composer.wires[w] + [0] * pad for w in "abcd"}

    cols = torch.stack([to_dev(composer.q[name] + [0] * pad, dv)
                        for name in SELECTOR_NAMES])
    sel = nttmod.ntt_many(cols, log_n, inverse=True)
    sel_coeffs = dict(zip(SELECTOR_NAMES, sel))
    sel_commits = {name: committer.commit(sel_coeffs[name])
                   for name in SELECTOR_NAMES}

    sigma_evals, _ = build_sigma_evals(composer, n)
    sig = nttmod.ntt_many(torch.stack([to_dev(se, dv)
                                       for se in sigma_evals]),
                          log_n, inverse=True)
    sigma_coeffs = list(sig)
    sigma_commits = [committer.commit(sc) for sc in sigma_coeffs]

    pk = ProverKey(n, Domain(n), Domain(4 * n), sel_coeffs, None,
                   sigma_coeffs, None, wire_vars, None, None, None)
    return pk, VerifierKey(n, sel_commits, sigma_commits)
