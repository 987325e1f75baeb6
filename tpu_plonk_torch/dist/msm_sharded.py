"""KZG commitments over the mesh (mirrors tpu_plonk/dist/msm_sharded.py).

Each rank holds its ceil(N/D) rows of the SRS table and runs the port's
own commit pipeline (pcs/csr_device.window_sums: the CSR lists built on
its device, the two walk levels and the bucket weighting) on its slice
of the coefficients.  The per-rank (W, 3, 12) window sums are
all-gathered, and every rank combines them window by window and folds
the windows on the host, as the reference's window_sums_from_csr does
(O(D W) affine additions).  EC addition is exact and associative, so the
commitment is the single-device one, on every rank count.

All ranks use one window width c and one row length, set by the common
shard length ceil(N/D), so their windows line up.
"""

import torch

from ..params import R_MOD
from ..fields import device as dev
from ..curves import g1
from ..curves import device_g1 as dg1
from ..pcs import csr_device
from ..pcs import msm_csr
from ..pcs.commit_device import BLIND_HIGHS
from . import multihost
from .mesh import Mesh


class ShardedCommitter:
    """Commit Montgomery coefficient tensors, replicated on every rank,
    against an SRS whose G1 powers are sharded over the mesh: a drop-in
    for DeviceCommitter in `prove_device(..., mesh=)`.  Every rank must
    call `commit` together, on the same coefficients.

    `srs` is a host SRS (`powers_g1` affine points), of which each rank
    packs its rows of the first `max_len` onto its device;
    `from_table` keeps this rank's rows of a whole device table."""

    def __init__(self, mesh: Mesh, srs, max_len: int):
        if max_len > len(srs.powers_g1):
            raise ValueError("SRS too small for committed length")
        lo, hi = _rows(mesh, max_len)
        self._bind(mesh, dg1.affine_to_device(srs.powers_g1[lo:hi],
                                              mesh.device), max_len)

    @classmethod
    def from_table(cls, mesh: Mesh, table):
        """From the whole (N, 2, 12) affine table (e.g. device_srs_points
        on each rank): a copy of this rank's rows, so the rest can go."""
        if table.device != mesh.device:
            raise ValueError(f"table on {table.device}, the mesh rank on "
                             f"{mesh.device}")
        self = cls.__new__(cls)
        lo, hi = _rows(mesh, table.shape[0])
        self._bind(mesh, table[lo:hi].clone(), table.shape[0])
        return self

    def _bind(self, mesh, points, max_len):
        self.mesh = mesh
        self.points = points
        self.device = points.device
        self.max_len = max_len
        self.shard = -(-max_len // mesh.size)
        self.lo = _rows(mesh, max_len)[0]
        self.c = csr_device.default_c(self.shard)
        self.chunk = csr_device.default_chunk(self.shard, self.c)
        self.n_windows = msm_csr.signed_window_count(self.c)

    def local_window_sums(self, coeffs_mont):
        """This rank's (W, 3, 12) weighted window sums over its rows."""
        local = coeffs_mont[self.lo:self.lo + self.points.shape[0]]
        if local.shape[0] == 0:
            return dg1.identity((self.n_windows,), self.device)
        return csr_device.window_sums(self.points, local, self.c, self.chunk)

    def commit(self, coeffs_mont):
        """(n, 8) Montgomery coefficients -> affine host point (None for
        the zero polynomial), the same on every rank."""
        if coeffs_mont.shape[0] > self.max_len:
            raise ValueError("polynomial exceeds committed SRS")
        every = multihost.allgather(
            self.mesh, self.local_window_sums(coeffs_mont)[None])
        pts = dg1.points_from_device(every)
        w = self.n_windows
        windows = []
        for wi in range(w):
            acc = None
            for r in range(self.mesh.size):
                acc = g1.add(acc, pts[r * w + wi])
            windows.append(acc)
        return msm_csr.fold_windows_host(windows, self.c)

    def commit_many(self, coeffs_list):
        return [self.commit(cf) for cf in coeffs_list]

    def high_g1(self, n: int):
        """[tau^(n+k)]G1 for k < BLIND_HIGHS as host affine points, the
        same on every rank: each rank offers the rows it holds and the
        owners' are gathered (a collective: every rank calls it)."""
        if n + BLIND_HIGHS > self.max_len:
            raise ValueError(f"SRS table of {self.max_len} points is too "
                             f"short for the blinding highs of n = {n}")
        mine = torch.zeros((BLIND_HIGHS, 2, dg1.W), dtype=torch.int32,
                           device=self.device)
        for k in range(BLIND_HIGHS):
            i = n + k - self.lo
            if 0 <= i < self.points.shape[0]:
                mine[k] = self.points[i]
        every = multihost.allgather(self.mesh, mine[None])
        rows = torch.stack([every[(n + k) // self.shard, k]
                            for k in range(BLIND_HIGHS)])
        return tuple(dg1.affine_from_device(rows))


def _rows(mesh: Mesh, max_len: int):
    """This rank's rows [lo, hi) of a table of max_len points, in blocks
    of ceil(max_len / D) (the last may be shorter or empty)."""
    shard = -(-max_len // mesh.size)
    lo = min(mesh.rank * shard, max_len)
    return lo, min(lo + shard, max_len)


class _Points:
    def __init__(self, points):
        self.powers_g1 = points


def msm_sharded(mesh: Mesh, points, scalars):
    """Host-facing sharded MSM: affine host points and int scalars ->
    the affine point sum_i scalars[i] points[i], computed across the
    mesh (every rank calls it with the same arguments)."""
    com = ShardedCommitter(mesh, _Points(list(points)), len(points))
    coeffs = dev.ints_to_words([int(s) % R_MOD for s in scalars], dev.FR,
                               mesh.device, mont=True)
    return com.commit(coeffs)
