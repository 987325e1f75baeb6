"""MSM pieces shared by the commit and SRS paths (mirrors
tpu_plonk/pcs/msm_csr.py): the signed-window count, the bucket
weighting and the host-side window fold.

A window's weighted sum is sum_b (b+1) * B_b over its bucket sums B_b
(slot b holds magnitude b+1).  The reference runs it as a lax.scan of
K4 adds (`_weighted_window_sums_pl_impl`), ~330 dependent adds per
commit; here it is one CUDA entry point (csrc/g1.cu
tpk_g1_bucket_weight) built for depth.  With B = S * L buckets cut into
S segments of L, and b = s*L + j,
  sum_b (b+1) B_b = sum_s P_s,  P_s = T_s + (L*s) * A_s,
  A_s = sum_j B_{s,j},  T_s = sum_j (j+1) B_{s,j}:
one thread per segment runs a high-to-low running sum for A_s and T_s,
multiplies A_s by L*s (double-and-add on s, then log2 L doublings) and
the S terms meet in a stride-halving tree, within blocks of T threads
and then over the window's NB blocks.  `weighted_window_sums_plain`
does the same adds in the same order, so the two agree word for word.
"""

import torch

from .. import kernels as K
from ..curves import g1
from ..curves import device_g1 as dg1

_G1_WEIGHT = K.Kernel("g1_bucket_weight", "tpk_g1_bucket_weight",
                      [K.P, K.I64, K.I32, K.I32, K.I32, K.I32, K.P, K.P])

#: buckets a thread sums in its segment, and threads a block
SEGMENT = 16
BLOCK = 32


def signed_window_count(c: int, bits: int = 255) -> int:
    """ceil(bits/c), +1 when c divides bits (the top unsigned window is
    then full width and can carry out)."""
    w = -(-bits // c)
    return w + 1 if bits % c == 0 else w


def weighting_plan(B: int):
    """(L, T, NB) for B buckets a window: L buckets a segment, T threads
    a block, NB blocks a window (L * T * NB == B)."""
    if B < 1 or B & (B - 1):
        raise ValueError(f"bucket count must be a power of two, got {B}")
    L = min(SEGMENT, B)
    S = B // L
    T = min(BLOCK, S)
    NB = S // T
    if NB > BLOCK:
        raise ValueError(f"{B} buckets a window is more than the kernel's "
                         f"{SEGMENT * BLOCK * BLOCK}")
    return L, T, NB


def weighting_counts(B: int):
    """(depth, adds) of the weighting of one window of B buckets: the
    longest chain of dependent adds in one thread (the segment's scan,
    the offset of the last segment, the two trees) and the adds done."""
    L, T, NB = weighting_plan(B)
    S = B // L
    lg = L.bit_length() - 1

    def offset(s):       # doublings and adds of (L s) A_s, then + T_s
        top = s.bit_length() - 1
        return top + bin(s).count("1") - 1 + lg + 1 if s else 0

    depth = 2 * (L - 1) + offset(S - 1) + (T.bit_length() - 1) + \
        (NB.bit_length() - 1)
    adds = S * 2 * (L - 1) + sum(offset(s) for s in range(S)) + S - 1
    return depth, adds


def _tree_sum(x, dim: int):
    """Stride-halving sum over `dim` (a power of two): lane t < h adds
    lane t + h, as csrc/g1.cu block_tree_sum does."""
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        x = dg1.add_plain(x.narrow(dim, 0, h), x.narrow(dim, h, h))
        n = h
    return x.select(dim, 0)


def weighted_window_sums_plain(buckets):
    """(W, B, 3, 12) bucket sums -> (W, 3, 12) weighted window sums, in
    plain torch: the kernel's adds in the kernel's order, batched over
    the segments."""
    W, B = buckets.shape[:2]
    L, T, NB = weighting_plan(B)
    S = B // L
    seg = buckets.reshape(W, S, L, 3, dg1.W)
    run = seg[:, :, L - 1]
    tot = run
    for j in range(L - 2, -1, -1):
        run = dg1.add_plain(run, seg[:, :, j])
        tot = dg1.add_plain(tot, run)
    # (L s) A_s for s >= 1: lane s doubles from its top bit down
    s = torch.arange(S, device=buckets.device)
    top = torch.tensor([max(v.bit_length() - 1, 0) for v in range(S)],
                       device=buckets.device)
    a, acc = run, run
    for i in range(top.max().item() - 1, -1, -1):
        live = (top > i)[None, :, None, None]
        acc = torch.where(live, dg1.add_plain(acc, acc), acc)
        bit = live & ((s >> i) & 1).bool()[None, :, None, None]
        acc = torch.where(bit, dg1.add_plain(acc, a), acc)
    on = (s > 0)[None, :, None, None]
    for _ in range(L.bit_length() - 1):
        acc = torch.where(on, dg1.add_plain(acc, acc), acc)
    tot = torch.where(on, dg1.add_plain(tot, acc), tot)
    block_sums = _tree_sum(tot.reshape(W, NB, T, 3, dg1.W), 2)
    return _tree_sum(block_sums, 1)


def weighted_window_sums(buckets):
    """(W, B, 3, 12) bucket sums -> (W, 3, 12) weighted window sums
    sum_b (b+1) B_b: the CUDA kernel on a CUDA tensor (one call, at most
    two launches), the plain version on a CPU tensor."""
    if buckets.device.type != "cuda":
        return weighted_window_sums_plain(buckets)
    W, B = buckets.shape[:2]
    L, T, NB = weighting_plan(B)
    K.check_words(buckets, dg1.W, "g1_bucket_weight buckets")
    if buckets.shape[2:] != (3, dg1.W) or buckets.data_ptr() % 16:
        raise ValueError("g1_bucket_weight: buckets must be (W, B, 3, 12) "
                         "and 16-byte aligned")
    out = torch.empty((W, 3, dg1.W), dtype=torch.int32, device=buckets.device)
    if W == 0:
        return out
    partial = torch.empty((W, NB, 3, dg1.W), dtype=torch.int32,
                          device=buckets.device) if NB > 1 else None
    _G1_WEIGHT(buckets.data_ptr(), W, B, L, T, NB,
               None if partial is None else partial.data_ptr(),
               out.data_ptr())
    return out


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
