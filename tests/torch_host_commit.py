"""A stand-in for the port's commit on CPU tests whose subject is not the
commit: `DeviceCommitter.commit` by the reference's host multi-scalar
multiplication (tpu_plonk.pcs.msm.msm_small, on its native backend
where that builds) over the committer's own table.  The
commitment is the same point as the plain CSR walk's, which
tests/test_torch_msm.py and test_torch_weighting.py hold against the
reference's host MSM (and chip_smoke.py, on the card, through every
prove); on the CPU it is several times faster at these sizes."""

import contextlib

import pytest

from tpu_plonk.pcs import msm as jmsm

from tpu_plonk_torch.curves import device_g1 as dg1
from tpu_plonk_torch.fields import device as dev
from tpu_plonk_torch.pcs.commit_device import DeviceCommitter


def host_commit(self, coeffs_mont):
    n = coeffs_mont.shape[0]
    if n > self.max_len:
        raise ValueError("polynomial exceeds committed SRS")
    if getattr(self, "_host_points", None) is None:
        self._host_points = dg1.affine_from_device(self.points)
    scalars = dev.words_to_ints(coeffs_mont, mont=True, ctx=dev.FR)
    return jmsm.msm_small(list(zip(self._host_points[:n], scalars)))


@contextlib.contextmanager
def host_commits():
    """Every DeviceCommitter commits by `host_commit` inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceCommitter, "commit", host_commit)
        yield
