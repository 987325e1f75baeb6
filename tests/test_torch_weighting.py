"""The bucket weighting sum_b (b+1) B_b (pcs/msm_csr.py): the plain
version, which follows the CUDA kernel's adds in order, against the
reference's host G1 arithmetic in affine, exactly; its plan's depth and
launch bounds; and a commit through it against the reference's host
MSM.  Inputs are numpy-seeded multiples of the generator."""

import numpy as np
import pytest
import torch

from tpu_plonk.params import R_MOD
from tpu_plonk.curves import g1 as jg1
from tpu_plonk.pcs import msm as jmsm

from tpu_plonk_torch import kernels
from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.curves import device_g1 as tdg1
from tpu_plonk_torch.pcs import commit_device, csr_device, msm_csr

torch.set_num_threads(1)


def _host_points(n, seed):
    rng = np.random.default_rng(seed)
    return [jg1.mul(jg1.GEN, int(rng.integers(1, 1 << 62)))
            for _ in range(n)]


def _projective(points, seed):
    """Host affine points as device projective words with a random z,
    so the inputs are not all z = 1."""
    t = tdg1.points_to_device(points)
    rng = np.random.default_rng(seed)
    z = tdev.ints_to_words([int(rng.integers(1, 1 << 62))
                            for _ in points], tdev.FP, mont=True)
    fp = tdev.FP
    return torch.stack([tdev.mont_mul_plain(t[:, 0], z, fp),
                        tdev.mont_mul_plain(t[:, 1], z, fp),
                        tdev.mont_mul_plain(t[:, 2], z, fp)], dim=1)


@pytest.mark.parametrize("W,B", [(3, 8), (2, 64)])
def test_plain_weighting_matches_host_sum(W, B):
    pts = _host_points(W * B, 100 + B)
    pts[1] = None                      # identity buckets
    pts[B - 1] = None
    pts[B + 3] = pts[B + 2]            # two equal adjacent buckets
    buckets = _projective(pts, B).reshape(W, B, 3, tdg1.W)
    before = kernels.counts()["g1_bucket_weight"]
    got = tdg1.points_from_device(msm_csr.weighted_window_sums(buckets))
    assert kernels.counts()["g1_bucket_weight"] == before
    for w in range(W):
        want = None
        for b in range(B):
            p = pts[w * B + b]
            if p is not None:
                want = jg1.add(want, jg1.mul(p, b + 1))
        assert got[w] == want


@pytest.mark.parametrize("c,depth", [(4, 14), (11, 51), (13, 57)])
def test_weighting_plan_bounds(c, depth):
    """At the port's window widths: segments of <= 16 buckets, blocks of
    <= 32 threads, one launch or two (a second only when a window spans
    several blocks), and at most 64 dependent adds in one thread."""
    B = 1 << (c - 1)
    L, T, NB = msm_csr.weighting_plan(B)
    assert L * T * NB == B and L <= 16 and T <= 32
    got_depth, adds = msm_csr.weighting_counts(B)
    assert got_depth == depth <= 64
    assert adds >= B - 1


def test_commit_through_weighting_matches_host_msm():
    n = 64
    pts = _host_points(n, 7)
    rng = np.random.default_rng(8)
    sc = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]
    sc[3] = 0

    class _SRS:
        powers_g1 = pts
    cm = commit_device.DeviceCommitter(_SRS(), n, device="cpu")
    assert cm.c == csr_device.default_c(n) == 4
    assert cm.commit(tdev.ints_to_words(sc, tdev.FR, mont=True)) == \
        jmsm.msm(pts, sc)
