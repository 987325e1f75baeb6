"""Port commitments and SRS generation (plain versions on the CPU)
against the reference's host MSM and host SRS setup: affine points
compared exactly."""

import numpy as np
import torch
import pytest

from tpu_plonk.params import R_MOD
from tpu_plonk.curves import g1 as jg1
from tpu_plonk.pcs import msm as jmsm
from tpu_plonk.pcs import srs as jsrs

from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.curves import device_g1 as tdg1
from tpu_plonk_torch.pcs import commit_device, srs_device

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _scalars(n, seed, bits=255):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % min(R_MOD, 1 << bits)
            for _ in range(n)]


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    return [jg1.mul(jg1.GEN, int.from_bytes(rng.bytes(32), "little") % R_MOD)
            for _ in range(200)]


class _SRS:
    def __init__(self, pts):
        self.powers_g1 = pts


@pytest.mark.parametrize("n,bits,table", [(200, 255, 200), (150, 40, 200),
                                          (64, 255, 1025)])
def test_commit_matches_host_msm(points, n, bits, table):
    """Full-width and short scalars on a 200-point table (c = 4, one
    level of bucket weighting), and on a table long enough for c = 11
    (1,024 buckets), which takes the two-level weighting."""
    sc = _scalars(n, n + bits, bits)
    sc[0] = 0
    pts = list(points)
    while len(pts) < table:           # cheap filler past the first n rows
        pts.append(jg1.add(pts[-1], jg1.GEN))
    cm = commit_device.DeviceCommitter(_SRS(pts), table, device="cpu")
    assert cm.c == (4 if table <= 1024 else 11)
    got = cm.commit(tdev.ints_to_words(sc, tdev.FR, mont=True))
    assert got == jmsm.msm(points[:n], sc)


def test_commit_of_zero_is_identity(points):
    cm = commit_device.DeviceCommitter(_SRS(points), 16, device="cpu")
    assert cm.commit(tdev.ints_to_words([0] * 16, tdev.FR, mont=True)) is None


def test_srs_walk_matches_host_setup():
    n = 1 << 6
    got = srs_device.device_srs_points(n, device="cpu")
    want = jsrs.setup(n - 1)
    assert tdg1.affine_from_device(got) == want.powers_g1
    g2_gen, g2_tau = srs_device.srs_g2()
    assert (g2_gen, g2_tau) == (want.g2_gen, want.g2_tau)
    # the committer over the generated table agrees with the host MSM
    sc = _scalars(n, 99)
    cm = srs_device.PackedCommitter(got)
    assert cm.commit(tdev.ints_to_words(sc, tdev.FR, mont=True)) == \
        jmsm.msm(want.powers_g1, sc)
