"""Batched G1 arithmetic on torch tensors (mirrors
tpu_plonk/curves/device_g1.py and the G1 kernels of
tpu_plonk/curves/pallas_g1.py).

Points are projective (X:Y:Z) Montgomery-form Fp coordinates stacked on
the second-to-last axis: int32 tensors (..., 3, 12) of 32-bit words;
the identity is (0:R:0).  Affine tables are (P, 2, 12) (x, y).

`add` is the complete Renes-Costello-Batina formula for a = 0, b3 = 12,
in the reference's arrangement (twelve products in two layers of six),
so projective outputs match the reference word for word.
`accumulate_csr` sums rows of a ragged CSR list of signed 1-based table
indices (a mixed add on an affine table: the same field values as `add`
with z = 1).  On CUDA tensors both launch csrc/g1.cu (the walk as one
kernel for affine tables and one for projective ones); on CPU tensors
they run the plain versions below.
"""

import torch

from ..params import P_MOD
from ..fields import device as dev
from .. import kernels as K

FP = dev.FP
W = FP.n_words

_G1_ADD = K.Kernel("g1_add", "tpk_g1_add",
                   [K.P, K.I64, K.P, K.I64, K.P, K.I64])
_WALK_ARGS = [K.P, K.P, K.P, K.P, K.P, K.I64]
#: the walk over an affine table (level 1 of a commit, the SRS walk) and
#: over a projective one (level 2 of a commit)
_G1_WALK = K.Kernel("g1_csr_walk", "tpk_g1_walk_affine", _WALK_ARGS)
_G1_WALK_PROJ = K.Kernel("g1_csr_walk_proj", "tpk_g1_walk_proj", _WALK_ARGS)


def identity(shape_prefix=(), device="cpu") -> torch.Tensor:
    """(..., 3, 12) copies of (0 : R : 0)."""
    out = torch.zeros(tuple(shape_prefix) + (3, W), dtype=torch.int32,
                      device=device)
    out[..., 1, :] = FP.const(1, device)[0]
    return out


def _mm(a, b):
    return dev.mont_mul_plain(a, b, FP)


def _ad(a, b):
    return dev.add_mod_plain(a, b, FP)


def _sb(a, b):
    return dev.sub_mod_plain(a, b, FP)


def add_plain(p, q):
    """p + q in plain torch: the reference's two six-wide product
    layers, with the sums stacked so a CPU add costs a few batched field
    ops."""
    shape = torch.broadcast_shapes(p.shape, q.shape)
    p = p.expand(shape)
    q = q.expand(shape)
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    st = torch.stack
    sums = _ad(st([x1, y1, x1, x2, y2, x2]), st([y1, z1, z1, y2, z2, z2]))
    p1 = _mm(st([x1, y1, z1, sums[0], sums[1], sums[2]]),
             st([x2, y2, z2, sums[3], sums[4], sums[5]]))
    t0, t1, t2 = p1[0], p1[1], p1[2]
    pairs = _ad(st([t0, t1, t0]), st([t1, t2, t2]))
    t3, t4, y3 = _sb(p1[3:6], pairs)
    # 3 t0, 12 t2 (b3 t2), 12 y3 by doublings, as the reference does
    s = st([t0, t2, y3])
    s2 = _ad(s, s)
    s34 = _ad(s2, st([t0, s2[1], s2[2]]))         # 3 t0, 4 t2, 4 y3
    s8 = _ad(s34[1:], s34[1:])
    s12 = _ad(s8, s34[1:])
    t0x3, t2b, y3b = s34[0], s12[0], s12[1]
    z3t1b = st([_ad(t1, t2b), _sb(t1, t2b)])
    z3, t1b = z3t1b[0], z3t1b[1]
    p2 = _mm(st([t3, t4, y3b, t1b, z3, t0x3]),
             st([t1b, y3b, t0x3, z3, t4, t3]))
    x3 = _sb(p2[0], p2[1])
    yz = _ad(st([p2[3], p2[4]]), st([p2[2], p2[5]]))
    return st([x3, yz[0], yz[1]], dim=-2)


def add(p, q):
    """Complete projective addition p + q."""
    if p.device.type != "cuda":
        return add_plain(p, q)
    shape = torch.broadcast_shapes(p.shape, q.shape)
    n = 1
    for d in shape[:-2]:
        n *= d
    out = torch.empty(shape, dtype=torch.int32, device=p.device)
    if n == 0:
        return out
    p_, np_ = K.operand_rows(p, shape, 2)
    q_, nq = K.operand_rows(q, shape, 2)
    K.check_words(p_, W, "g1_add p")
    K.check_words(q_, W, "g1_add q")
    _G1_ADD(p_.data_ptr(), np_, q_.data_ptr(), nq, out.data_ptr(), n)
    return out


def double(p):
    return add(p, p)


def select(mask, p, q):
    """mask ? p : q over the batch (mask: bool (...,))."""
    return torch.where(mask[..., None, None], p, q)


def accumulate_csr_plain(tbl, affine: bool, idx, row_start, row_len):
    """Row r = sum of the table points named by idx[row_start[r] :
    row_start[r] + row_len[r]] (1-based, negative = subtract, 0 = pad,
    skipped), in list order: the row's first live point is taken as it
    is (z = 1 on an affine table), each later one added; a row with none
    is the identity.  Plain torch: one batched add per list position
    over the rows that still have an entry there."""
    R = row_start.shape[0]
    acc = identity((R,), tbl.device)
    if R == 0 or idx.numel() == 0:
        return acc
    one = FP.const(1, tbl.device)
    started = torch.zeros(R, dtype=torch.bool, device=tbl.device)
    depth = int(row_len.max())
    start = row_start.to(torch.int64)
    for k in range(depth):
        rows = torch.nonzero(row_len > k).flatten()
        e = idx[start[rows] + k].to(torch.int64)
        live = e != 0
        rows, e = rows[live], e[live]
        if rows.numel() == 0:
            continue
        pts = tbl[e.abs() - 1]
        if affine:
            pts = torch.cat([pts, one.expand(pts.shape[0], 1, W)], dim=1)
        y = pts[:, 1]
        pts[:, 1] = torch.where((e < 0)[:, None], _sb(torch.zeros_like(y), y),
                                y)
        fresh = ~started[rows]
        acc[rows[fresh]] = pts[fresh]
        old = rows[~fresh]
        acc[old] = add_plain(acc[old], pts[~fresh])
        started[rows] = True
    return acc


def accumulate_csr(tbl, affine: bool, idx, row_start, row_len):
    """Per-row sums of a ragged CSR list (see accumulate_csr_plain):
    tbl (P, 2, 12) affine or (P, 3, 12) projective; idx int32 signed
    1-based indices; row_start, row_len int32 (R,).  Returns (R, 3, 12).
    Raises on a row outside idx or an index outside the table."""
    if tbl.device.type != "cuda":
        return accumulate_csr_plain(tbl, affine, idx, row_start, row_len)
    R = row_start.shape[0]
    out = torch.empty((R, 3, W), dtype=torch.int32, device=tbl.device)
    if R == 0:
        return out
    K.check_words(tbl, W, "g1_csr_walk table")
    if tbl.dim() != 3 or tbl.shape[1] != (2 if affine else 3):
        raise ValueError("g1_csr_walk: table shape does not match mode")
    if tbl.data_ptr() % 16:
        raise ValueError("g1_csr_walk: table must be 16-byte aligned")
    for t, what in ((idx, "idx"), (row_start, "row_start"),
                    (row_len, "row_len")):
        K.check_words(t, 0, f"g1_csr_walk {what}")
        if t.dim() != 1:
            raise ValueError(f"g1_csr_walk: {what} must be 1-D")
    if row_len.shape != row_start.shape:
        raise ValueError("g1_csr_walk: row_start/row_len mismatch")
    P = tbl.shape[0]
    bad = ((row_start < 0) | (row_len < 0)
           | (row_start.to(torch.int64) + row_len > idx.shape[0])).any()
    bad |= ((idx < -P) | (idx > P)).any()
    if bool(bad):
        raise IndexError("g1_csr_walk: a row runs outside idx or an index "
                         "outside the table")
    (_G1_WALK if affine else _G1_WALK_PROJ)(
        tbl.data_ptr(), idx.data_ptr(), row_start.data_ptr(),
        row_len.data_ptr(), out.data_ptr(), R)
    return out


# --- host <-> device conversion --------------------------------------------


def points_to_device(points, device="cpu") -> torch.Tensor:
    """Affine host points (list of (x, y) or None) -> (N, 3, 12)
    projective Montgomery words."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(p[0]), ys.append(p[1]), zs.append(1)
    cols = [dev.ints_to_words(v, FP, device, mont=True)
            for v in (xs, ys, zs)]
    return torch.stack(cols, dim=1)


def affine_to_device(points, device="cpu") -> torch.Tensor:
    """Affine host points (no identity) -> (N, 2, 12) Montgomery words,
    the walk's affine table layout."""
    if any(p is None for p in points):
        raise ValueError("affine tables cannot hold the identity")
    xs = dev.ints_to_words([p[0] for p in points], FP, device, mont=True)
    ys = dev.ints_to_words([p[1] for p in points], FP, device, mont=True)
    return torch.stack([xs, ys], dim=1)


def points_from_device(p) -> list:
    """(N, 3, 12) projective Montgomery words -> affine host points."""
    vals = dev.words_to_ints(p.reshape(-1, 3, W), mont=True, ctx=FP)
    out = []
    for i in range(0, len(vals), 3):
        x, y, z = vals[i:i + 3]
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, P_MOD)
            out.append((x * zi % P_MOD, y * zi % P_MOD))
    return out


def affine_from_device(tbl) -> list:
    """(N, 2, 12) affine Montgomery words -> host (x, y) points."""
    vals = dev.words_to_ints(tbl.reshape(-1, 2, W), mont=True, ctx=FP)
    return list(zip(vals[0::2], vals[1::2]))
