"""Rank programs of tests/test_torch_dist.py, run by
tpu_plonk_torch.dist.multihost.launch in spawned processes (`run`).
This module imports torch and the port only (no JAX): each rank imports
it afresh.  Every program takes the rank's mesh first and returns host
data (numpy arrays, bytes, ints, points)."""

import numpy as np
import torch

from tpu_plonk_torch.params import R_MOD
from tpu_plonk_torch.cs import Composer
from tpu_plonk_torch.gadgets import AllocatedScalar, range_check
from tpu_plonk_torch.dist import multihost
from tpu_plonk_torch.dist.msm_sharded import ShardedCommitter, msm_sharded
from tpu_plonk_torch.dist.ntt_sharded import (
    ntt_sharded, coset_ntt_sharded, coset_intt_sharded)
from tpu_plonk_torch.curves import device_g1 as dg1
from tpu_plonk_torch.fields import device as dev
from tpu_plonk_torch.pcs.msm import msm_small
from tpu_plonk_torch.proof_system.engine_device import DevicePK, prove_device
from tpu_plonk_torch.proof_system.preprocess import preprocess_device_cached


def golden_circuit():
    """tests/test_golden_proof.py's circuit, on the port's composer."""
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


class HostSRS:
    def __init__(self, points):
        self.powers_g1 = points


def transforms(mesh, xs, log_n, scales):
    """Each rank's block of the sharded NTT, iNTT and phase-scaled NTT
    (one per scale) and of the coset pair, gathered whole: a dict of
    (B, n, 8) int32 arrays."""
    x = multihost.global_put(mesh, torch.from_numpy(xs), dim=1)
    out = {"ntt": ntt_sharded(mesh, x, log_n),
           "intt": ntt_sharded(mesh, x, log_n, inverse=True),
           "coset_ntt": coset_ntt_sharded(mesh, x[0], log_n)[None],
           "coset_intt": coset_intt_sharded(mesh, x[0], log_n)[None]}
    for s in scales:
        out[f"scaled_{s}"] = ntt_sharded(mesh, x, log_n, scale=s)
    return {k: multihost.allgather(mesh, v, dim=1).numpy()
            for k, v in out.items()}


def commit(mesh, points, scalars):
    """The ShardedCommitter's commitment (from the host points, and from
    a whole table through from_table) and msm_sharded's, and high_g1's
    points for the table's last three rows."""
    com = ShardedCommitter(mesh, HostSRS(points), len(points))
    coeffs = dev.ints_to_words(scalars, dev.FR, "cpu", mont=True)
    tab = ShardedCommitter.from_table(
        mesh, dg1.affine_to_device(points, "cpu"))
    return (com.commit(coeffs), tab.commit(coeffs),
            msm_sharded(mesh, points, scalars), com.high_g1(len(points) - 3))


def host_window_sums(self, coeffs_mont):
    """ShardedCommitter.local_window_sums by the host MSM of the rank's
    rows: its partial commitment as window 0 and the identity in the
    others, which the fold turns back into the partial commitment."""
    local = coeffs_mont[self.lo:self.lo + self.points.shape[0]]
    pts = dg1.affine_from_device(self.points[:local.shape[0]])
    sc = dev.words_to_ints(local, mont=True, ctx=dev.FR)
    out = dg1.identity((self.n_windows,), self.device)
    out[0] = dg1.points_to_device([msm_small(list(zip(pts, sc)))],
                                  self.device)[0]
    return out


def golden_prove(mesh, srs_points, cache_dir, seeds):
    """The golden circuit proved on the mesh, one proof per seed (None:
    unblinded), through the preprocess cache the caller filled; each
    rank's window sums by host_window_sums."""
    ShardedCommitter.local_window_sums = host_window_sums
    cs = golden_circuit()
    com = ShardedCommitter(mesh, HostSRS(srs_points), len(srs_points))
    pk, _ = preprocess_device_cached(cs, com, cache_dir, device="cpu")
    dpk = DevicePK(pk)
    return [prove_device(cs, pk, com, dpk=dpk, device="cpu", mesh=mesh,
                         blinding_seed=s).to_bytes() for s in seeds]


def limbs_of(values) -> np.ndarray:
    return dev.ints_to_words(values, dev.FR, "cpu", mont=True).numpy()


def run(mesh, jobs):
    """Run each (program name, args) of `jobs` on this rank, in order:
    {name: result}.  One launch pays the ranks' start-up once."""
    torch.set_num_threads(1)
    return {name: globals()[name](mesh, *args) for name, args in jobs}
