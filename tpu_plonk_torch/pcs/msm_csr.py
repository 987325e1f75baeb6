"""MSM pieces shared by the commit and SRS paths (mirrors
tpu_plonk/pcs/msm_csr.py): the signed-window count, the two-level
bucket weighting on the G1 add kernel, and the host-side window fold.

A window's weighted sum is sum_b (b+1) * B_b over its bucket sums B_b
(slot b holds magnitude b+1).  With b = g*K + k it is
  S = K * sum_g g*A_g + sum_g T_g,  A_g = sum_k B_{g,k},
  T_g = sum_k (k+1) B_{g,k},
each level a high-to-low running-sum scan, so the depth is about
K + G + log2(K) batched adds instead of B.
"""

import torch

from ..curves import g1
from ..curves import device_g1 as dg1


def signed_window_count(c: int, bits: int = 255) -> int:
    """ceil(bits/c), +1 when c divides bits (the top unsigned window is
    then full width and can carry out)."""
    w = -(-bits // c)
    return w + 1 if bits % c == 0 else w


def weighted_window_sums(buckets, c: int):
    """(W, B, 3, 12) bucket sums -> (W, 3, 12) weighted window sums."""
    W, B = buckets.shape[:2]
    dv = buckets.device
    if B <= 16:
        run = tot = dg1.identity((W,), dv)
        for b in range(B - 1, -1, -1):
            run = dg1.add(run, buckets[:, b])
            tot = dg1.add(tot, run)
        return tot
    K = min(1 << (c // 2), B)
    G = B // K
    bk = buckets.reshape(W, G, K, 3, dg1.W)
    run = tot = dg1.identity((W, G), dv)
    for k in range(K - 1, -1, -1):
        run = dg1.add(run, bk[:, :, k])
        tot = dg1.add(tot, run)
    a_g, t_g = run, tot
    run2 = tot2 = sum_t = dg1.identity((W,), dv)
    for g in range(G - 1, -1, -1):
        run2 = dg1.add(run2, a_g[:, g])
        tot2 = dg1.add(tot2, run2)
        sum_t = dg1.add(sum_t, t_g[:, g])
    # sum_g g*A_g = tot2 - run2, times K by doublings
    neg = torch.ones(W, dtype=torch.int32, device=dv)
    gpart = dg1.add(tot2, run2, neg)
    for _ in range(K.bit_length() - 1):
        gpart = dg1.add(gpart, gpart)
    return dg1.add(gpart, sum_t)


def fold_windows_host(window_pts, c: int):
    """Horner fold of per-window affine sums on the host: O(W*c) affine
    ops on ~20 points."""
    acc = None
    for p in reversed(window_pts):
        if acc is not None:
            for _ in range(c):
                acc = g1.add(acc, acc)
        acc = g1.add(acc, p) if acc is not None else p
    return acc
