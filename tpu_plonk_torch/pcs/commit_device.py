"""KZG commitments on the device (mirrors tpu_plonk/pcs/commit_device.py):
the SRS G1 powers live on the device as an affine table, coefficients
arrive as Montgomery words from the prover, the CSR lists are built on
the device, and only the window sums come back for the host fold."""

from ..kernels import resolve_device
from ..curves import device_g1 as dg1
from . import csr_device
from . import msm_csr


class DeviceCommitter:
    """Commit Montgomery coefficient tensors against an SRS.

    `srs` is a host SRS (`powers_g1` affine points); `max_len` points of
    it are packed onto `device` (cuda unless named).  The window width
    follows the table's length (csr_device.default_c)."""

    def __init__(self, srs, max_len: int, device=None):
        if max_len > len(srs.powers_g1):
            raise ValueError("SRS too small for committed length")
        dv = resolve_device(device)
        self._bind(dg1.affine_to_device(srs.powers_g1[:max_len], dv))

    def _bind(self, points):
        if points.dim() != 3 or points.shape[1:] != (2, dg1.W):
            raise ValueError("point table must be (N, 2, 12) affine words")
        self.points = points
        self.device = points.device
        self.max_len = points.shape[0]
        self.c = csr_device.default_c(self.max_len)
        self.chunk = csr_device.default_chunk(self.max_len, self.c)

    def commit(self, coeffs_mont):
        """(n, 8) Montgomery coefficients -> affine host point (None for
        the zero polynomial)."""
        n = coeffs_mont.shape[0]
        if n > self.max_len:
            raise ValueError("polynomial exceeds committed SRS")
        sums = csr_device.window_sums(self.points, coeffs_mont, self.c,
                                      self.chunk)
        return msm_csr.fold_windows_host(dg1.points_from_device(sums),
                                         self.c)

    def commit_many(self, coeffs_list):
        return [self.commit(cf) for cf in coeffs_list]
