"""Preprocessing on the device (mirrors tpu_plonk/proof_system/
preprocess.py): ProverKey / VerifierKey (copied from the reference),
`preprocess_device`, which iNTTs the selector and sigma columns and
commits them on the device, and `preprocess_device_cached`, the same
behind a disk cache keyed by `circuit_fingerprint`.

In the port's ProverKey the coefficient tables are (n, 8) Montgomery
word tensors on the device, and the host extended-coset fields are
None (the phased quotient derives what it needs from the coefficients).
"""

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..params import R_MOD
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


#: where preprocess_device_cached keeps its files unless told otherwise:
#: outside any checkout, since an entry holds 15 n-row tables (~0.5 GB at
#: 2^20, ~2 GB at 2^22)
DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                                 "tpu_plonk_torch")


def circuit_fingerprint(composer) -> str:
    """Stable hash of the circuit STRUCTURE (selector columns, wire
    permutation, padded size) — the exact inputs of preprocessing.
    Public-input VALUES and witness are excluded on purpose: they don't
    affect ProverKey/VerifierKey, and including them would invalidate
    the preprocess cache on every new instance.  The same hash as the
    reference's (tpu_plonk/proof_system/preprocess.py)."""
    h = hashlib.sha256()
    h.update(b"tpu-plonk ppdev v1\0")
    h.update(composer.padded_size().to_bytes(8, "little"))
    for name in SELECTOR_NAMES:
        col = composer.q[name]
        h.update(name.encode() + b"\0" + len(col).to_bytes(8, "little"))
        h.update(b"".join((v % R_MOD).to_bytes(32, "little")
                          for v in col))
    for w in "abcd":
        h.update(np.asarray(composer.wires[w], dtype=np.int64).tobytes())
    return h.hexdigest()[:20]


def cache_path(composer, cache_dir=None) -> str:
    """The file of the composer's preprocess_device_cached entry."""
    return os.path.join(DEFAULT_CACHE_DIR if cache_dir is None
                        else cache_dir,
                        f"torch_ppdev_{circuit_fingerprint(composer)}.npz")


def _prover_key(composer, sel_coeffs: dict, sigma_coeffs: list):
    n = composer.padded_size()
    pad = n - composer.n_gates
    wire_vars = {w: composer.wires[w] + [0] * pad for w in "abcd"}
    return ProverKey(n, Domain(n), Domain(4 * n), sel_coeffs, None,
                     sigma_coeffs, None, wire_vars, None, None, None)


def preprocess_device_cached(composer, committer, cache_dir=None,
                             verbose=False, device=None):
    """preprocess_device behind a disk cache keyed by the circuit's
    fingerprint: the selector and sigma coefficient tables and their
    commitments are circuit-static, so a hit skips the 15 transforms
    and commits.  An entry, `torch_ppdev_<fingerprint>.npz` under
    `cache_dir` (default DEFAULT_CACHE_DIR), holds the coefficient
    words as they are (int32, lossless) and the VerifierKey bytes; its
    prefix keeps it apart from the reference's `ppdev_` entries, which
    hold 16-bit limbs.  A hit loads the tables onto `device` (cuda
    unless named; the committer's) and gives the tensors and key bytes
    a miss gives.  Returns (ProverKey, VerifierKey)."""
    from .engine_device import check_committer

    dv = check_committer(committer, device)
    path = cache_path(composer, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = composer.padded_size()
    if os.path.exists(path):
        if verbose:
            print(f"preprocess cache hit: {path}", flush=True)
        with np.load(path) as z:
            sel, sig, vk_bytes = z["sel"], z["sigma"], z["vk"].tobytes()
        if (sel.shape != (len(SELECTOR_NAMES), n, 8)
                or sig.shape != (4, n, 8)):
            raise ValueError(f"{path}: tables of shape {sel.shape} and "
                             f"{sig.shape} for a circuit of n = {n}")
        vk = VerifierKey.from_bytes(vk_bytes)
        sel = torch.from_numpy(sel).to(dv)
        sig = torch.from_numpy(sig).to(dv)
        return _prover_key(composer, dict(zip(SELECTOR_NAMES, sel)),
                           list(sig)), vk
    if verbose:
        print(f"preprocess cache miss: {path}", flush=True)
    pk, vk = preprocess_device(composer, committer, device)
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    np.savez(tmp, sel=torch.stack([pk.selector_coeffs[name] for name in
                                   SELECTOR_NAMES]).cpu().numpy(),
             sigma=torch.stack(pk.sigma_coeffs).cpu().numpy(),
             vk=np.frombuffer(vk.to_bytes(), dtype=np.uint8))
    # renamed whole: a concurrent reader never sees a partial entry
    os.replace(tmp, path)
    return pk, vk


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

    return (_prover_key(composer, sel_coeffs, sigma_coeffs),
            VerifierKey(n, sel_commits, sigma_commits))
