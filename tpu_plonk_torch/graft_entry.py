"""Top-level entry points of the port (the counterpart of the repository's
`__graft_entry__.py`, which serves the JAX package).

entry():              the flagship compute on one device: an NTT round
                      trip over Fr at 2^12 (the prover's core kernel).
dryrun_multichip(n):  n ranks on torch.distributed check the sharded
                      four-step NTT and the sharded commit against host
                      oracles, then prove a full tiny circuit on the mesh
                      (sharded transforms and commits) whose bytes must
                      equal the single-device prove's, and verify it.

Both run on the card unless the caller names the CPU (`device="cpu"`).
"""

import tempfile

import numpy as np
import torch

LOG_N = 12


def entry(device=None):
    """(fn, args): fn(x) = intt(ntt(x)) at 2^12 on `device` (cuda unless
    named); x is (2^12, 8) Montgomery words made from a fixed seed."""
    from .kernels import resolve_device
    from .poly import ntt as nttmod

    dv = resolve_device(device)

    def fn(x):
        return nttmod.intt(nttmod.ntt(x, LOG_N), LOG_N)

    rng = np.random.default_rng(0)
    raw = rng.integers(0, 1 << 32, size=(1 << LOG_N, 8), dtype=np.uint64)
    raw[:, 7] &= (1 << 29) - 1                       # below r
    x = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(dv)
    return fn, (x,)


def tiny_circuit():
    """An arithmetic chain padded to 64 gates (8 x 8: the four-step splits
    over up to 8 ranks)."""
    from .params import R_MOD
    from .cs import Composer

    cs = Composer()
    a = cs.add_input(37)
    b = cs.add_input(21)
    c = cs.mul(1, a, b, 5)
    cs.constrain_to_constant(c, 0, (-782) % R_MOD)
    prev = c
    while cs.n_gates < 40:
        prev = cs.mul(1, prev, prev, 3)
    return cs


def _dryrun_rank(mesh):
    """One rank of dryrun_multichip; returns the mesh proof's bytes."""
    from .params import R_MOD
    from .fields import device as dev
    from .dist import multihost
    from .dist.msm_sharded import ShardedCommitter
    from .dist.ntt_sharded import ntt_sharded
    from .pcs import kzg, srs as srs_mod
    from .pcs.commit_device import DeviceCommitter
    from .poly.domain import Domain
    from .proof_system.engine_device import DevicePK, prove_device
    from .proof_system.preprocess import preprocess_device
    from .proof_system.verifier import verify

    dv = mesh.device
    cs = tiny_circuit()
    n = cs.padded_size()
    log_n = n.bit_length() - 1
    srs = srs_mod.setup(n + 8)

    coeffs = [(i * 7 + 3) % R_MOD for i in range(n)]
    x = multihost.global_put(mesh, dev.ints_to_words(coeffs, dev.FR, dv,
                                                     mont=True))
    y = ntt_sharded(mesh, x, log_n)
    got = dev.words_to_ints(multihost.allgather(mesh, y), True, dev.FR)
    if got != Domain(n).ntt(coeffs):
        raise AssertionError("sharded NTT diverges from the host NTT")
    back = ntt_sharded(mesh, y, log_n, inverse=True)
    if dev.words_to_ints(multihost.allgather(mesh, back), True,
                         dev.FR) != coeffs:
        raise AssertionError("sharded NTT round trip failed")

    sharded = ShardedCommitter(mesh, srs, n + 8)
    scalars = [pow(5, i + 1, R_MOD) for i in range(n)]
    cm = sharded.commit(dev.ints_to_words(scalars, dev.FR, dv, mont=True))
    if cm != kzg.commit(scalars, srs):
        raise AssertionError("sharded commit diverges from the host commit")

    single = DeviceCommitter(srs, n + 8, device=dv)
    pk, vk = preprocess_device(cs, single, device=dv)
    want = prove_device(cs, pk, single, device=dv).to_bytes()
    proof = prove_device(cs, pk, sharded, dpk=DevicePK(pk), device=dv,
                         mesh=mesh)
    if proof.to_bytes() != want:
        raise AssertionError("mesh proof bytes diverge from the "
                             "single-device proof's")
    if not verify(proof, vk, cs.pi, srs):
        raise AssertionError("mesh proof rejected")
    return proof.to_bytes()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run _dryrun_rank in n_devices ranks on `device`'s type (cuda
    unless named): on nccl when every rank has a card of its own, else
    on gloo (CPU ranks, or ranks sharing cards).  Raises if a rank's
    check fails or the ranks' proofs differ."""
    from . import kernels
    from .dist import multihost

    dv = kernels.resolve_device(device)
    backend = "gloo"
    if dv.type == "cuda":
        kernels.library()                 # built once, before the ranks
        if n_devices <= torch.cuda.device_count():
            backend = "nccl"
    with tempfile.TemporaryDirectory(prefix="tpk_dryrun_") as tmp:
        proofs = multihost.launch(_dryrun_rank, n_devices, backend=backend,
                                  device=dv.type, store_dir=tmp)
    if len(set(proofs)) != 1:
        raise AssertionError("the ranks' proofs differ")
