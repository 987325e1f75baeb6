"""CSR bucket lists built on the device, and the commit pipeline that
walks them (mirrors tpu_plonk/pcs/csr_device.py).

Per window, the (magnitude, signed point index) pairs are sorted by
magnitude; each bucket's run of the sorted stream is cut into rows of at
most `chunk` entries.  The layout is ragged (a row is a start and a
length in the sorted stream) rather than the reference's fixed-width
padded rows, which exist for the TPU's static shapes: a thread per row
walks exactly its entries.  Chunking bounds the walk depth when digits
pile into a few buckets (the top window always does).

Level 1 walks the rows against the affine point table; level 2 walks
each bucket's rows (row ids are contiguous per bucket) against the level
1 results; the bucket sums are then weighted per window
(msm_csr.weighted_window_sums) and folded on the host.  The sort, the
counts and the cumulative sums are torch ops; the walks and the
weighting are the G1 kernels.  Same bucket decomposition as the
reference, so the affine result is the same point.
"""

import torch

from ..fields import device as dev
from ..curves import device_g1 as dg1
from . import msm_csr

M32 = 0xFFFFFFFF


def digits_signed(canon, c: int, n_windows: int):
    """(N, 8) canonical words -> (W, N) int64 signed digits in
    [-2^(c-1)+1, 2^(c-1)], value-preserving; the carry out of the top
    window is zero for scalars < 2^255 when n_windows ==
    signed_window_count(c)."""
    N = canon.shape[0]
    x = canon.to(torch.int64) & M32
    ext = torch.cat([x, torch.zeros(N, 1, dtype=torch.int64,
                                    device=x.device)], dim=1)
    mask = (1 << c) - 1
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros(N, dtype=torch.int64, device=x.device)
    out = []
    for w in range(n_windows):
        bit = w * c
        li, sh = bit // 32, bit % 32
        v = ext[:, li] >> sh
        if sh + c > 32:
            v = v | (ext[:, li + 1] << (32 - sh))
        d = (v & mask) + carry
        carry = (d > half).to(torch.int64)
        out.append(d - carry * full)
    return torch.stack(out)


def default_c(n: int) -> int:
    """Window width by size: narrow windows keep the sequential bucket
    weighting short at small sizes; 11 / 13 are the reference's
    measured choices at 2^16 and above (csr_device.default_c)."""
    if n <= (1 << 10):
        return 4
    if n <= (1 << 16):
        return 11
    return 13


def default_chunk(n: int, c: int) -> int:
    """Row length: about the mean bucket load, at least 16."""
    load = n / (1 << (c - 1))
    return 16 if load <= 24 else 32


def csr_rows(canon, c: int, chunk: int):
    """Ragged two-level CSR of one scalar vector.

    Returns (ent, row_start, row_len, bucket_first, bucket_rows):
      ent          (W*N,) int32  signed 1-based point indices, sorted by
                                 (window, magnitude);
      row_start/len (R,)  int32  level-1 rows: slices of `ent`;
      bucket_first/rows (W*B,) int32  level-2 rows: each bucket's
                                 contiguous range of level-1 row ids."""
    N = canon.shape[0]
    W = msm_csr.signed_window_count(c)
    B = 1 << (c - 1)
    d = canon.device
    sd = digits_signed(canon, c, W)
    key = (torch.arange(W, device=d)[:, None] * (B + 1) + sd.abs()).reshape(-1)
    order = torch.argsort(key, stable=True)
    idx1 = torch.arange(1, N + 1, device=d)[None, :]
    ent = torch.where(sd < 0, -idx1, idx1).reshape(-1)[order]
    counts = torch.bincount(key, minlength=W * (B + 1))
    starts = (torch.cumsum(counts, 0) - counts).reshape(W, B + 1)[:, 1:]
    cnt = counts.reshape(W, B + 1)[:, 1:].reshape(-1)
    starts = starts.reshape(-1)
    nrows = (cnt + chunk - 1) // chunk
    first = torch.cumsum(nrows, 0) - nrows
    R = int(nrows.sum())
    bucket = torch.repeat_interleave(torch.arange(W * B, device=d), nrows,
                                     output_size=R)
    k = torch.arange(R, device=d) - first[bucket]
    row_start = starts[bucket] + k * chunk
    row_len = torch.clamp(cnt[bucket] - k * chunk, max=chunk)
    i32 = torch.int32
    return (ent.to(i32), row_start.to(i32), row_len.to(i32),
            first.to(i32), nrows.to(i32))


def window_sums(points, coeffs_mont, c: int, chunk: int):
    """Montgomery coefficients (n, 8) against the first n rows of the
    affine table `points` (P, 2, 12) -> (W, 3, 12) weighted window sums
    (projective, Montgomery)."""
    canon = dev.from_mont(coeffs_mont, dev.FR)
    ent, rs, rl, bf, br = csr_rows(canon, c, chunk)
    l1 = dg1.accumulate_csr(points, True, ent, rs, rl)
    ids = torch.arange(1, l1.shape[0] + 1, dtype=torch.int32,
                       device=l1.device)
    buckets = dg1.accumulate_csr(l1, False, ids, bf, br)
    W = msm_csr.signed_window_count(c)
    return msm_csr.weighted_window_sums(
        buckets.reshape(W, 1 << (c - 1), 3, dg1.W))
