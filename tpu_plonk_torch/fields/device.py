"""Batched modular arithmetic on torch tensors (mirrors
tpu_plonk/fields/device.py).

Layout: int32 tensors whose last axis holds the field element as
little-endian 32-bit words (8 for Fr, 12 for Fp), in Montgomery form
with R = 2^256 (Fr) or 2^384 (Fp) wherever a function says "Montgomery".
That is the reference's (..., 16) / (..., 24) 16-bit-limb layout with
two limbs packed per word, so `limbs16_to_words` / `words_to_limbs16`
convert without arithmetic and port and reference arrays compare bit
for bit.  int32 holds the words' bit patterns (torch has no usable
uint32 arithmetic on the CPU).

On a CUDA tensor `mont_mul`, `add_mod` and `sub_mod` launch the kernels
of csrc/field_ops.cu (Fp add/sub has no kernel: it runs inside the G1
kernels).  On a CPU tensor they run the plain versions below, which
also run on CUDA tensors for comparison and compute in int64 on 16-bit
limbs so every product fits.  The scans and the batch inversion are
plain torch built on those three, as the reference builds them in XLA.
"""

import dataclasses
import functools

import numpy as np
import torch

from ..params import R_MOD, P_MOD
from .. import kernels as K

M16 = 0xFFFF
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FieldCtx:
    name: str
    modulus: int
    n_words: int

    @property
    def mont_r(self) -> int:
        return 1 << (32 * self.n_words)

    def words(self, value: int) -> np.ndarray:
        """One value as an (n_words,) int32 word array."""
        return np.frombuffer(int(value).to_bytes(4 * self.n_words, "little"),
                             dtype="<i4").copy()

    @functools.cached_property
    def q16(self) -> np.ndarray:
        return np.array([(self.modulus >> (16 * i)) & M16
                         for i in range(2 * self.n_words)], dtype=np.int64)

    def const(self, value: int, device, mont: bool = True) -> torch.Tensor:
        """A (1, n_words) constant (Montgomery form unless mont=False)."""
        v = value % self.modulus
        if mont:
            v = v * self.mont_r % self.modulus
        return torch.from_numpy(self.words(v)).to(device).reshape(1, -1)


FR = FieldCtx("fr", R_MOD, 8)
FP = FieldCtx("fp", P_MOD, 12)


# ---------------------------------------------------------------------------
# conversions (host ints, reference 16-bit limbs, words)
# ---------------------------------------------------------------------------

def ints_to_words(values, ctx: FieldCtx, device="cpu",
                  mont: bool = False) -> torch.Tensor:
    """Host ints -> (len, n_words) int32 words (canonical, or Montgomery
    with mont=True)."""
    m = ctx.modulus
    nb = 4 * ctx.n_words
    if mont:
        r = ctx.mont_r % m
        buf = b"".join((int(v) % m * r % m).to_bytes(nb, "little")
                       for v in values)
    else:
        buf = b"".join((int(v) % m).to_bytes(nb, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<i4").reshape(-1, ctx.n_words)
    return torch.from_numpy(arr.copy()).to(device)


def words_to_ints(t: torch.Tensor, mont: bool = False,
                  ctx: FieldCtx = None) -> list:
    """(..., n_words) words -> flat list of host ints (divided by R when
    mont=True)."""
    arr = t.detach().to("cpu").contiguous().numpy()
    w = arr.shape[-1]
    raw = arr.reshape(-1, w).astype("<i4").tobytes()
    nb = 4 * w
    vals = [int.from_bytes(raw[i:i + nb], "little")
            for i in range(0, len(raw), nb)]
    if mont:
        rinv = pow(ctx.mont_r, -1, ctx.modulus)
        vals = [v * rinv % ctx.modulus for v in vals]
    return vals


def limbs16_to_words(arr) -> torch.Tensor:
    """Reference layout (..., 2W) 16-bit limbs (any int dtype) ->
    (..., W) int32 words, on the CPU."""
    a = np.ascontiguousarray(np.asarray(arr).astype("<u2"))
    return torch.from_numpy(a.view("<i4").copy())


def words_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(..., W) int32 words -> the reference's (..., 2W) uint32 limbs."""
    a = np.ascontiguousarray(t.detach().to("cpu").numpy().astype("<i4"))
    return a.view("<u2").astype(np.uint32)


# ---------------------------------------------------------------------------
# kernels and their plain versions
# ---------------------------------------------------------------------------

_FR_MUL = K.Kernel("fr_mont_mul", "tpk_fr_mul",
                   [K.P, K.I64, K.P, K.I64, K.P, K.I64])
_FR_ADDSUB = K.Kernel("fr_add_sub", "tpk_fr_addsub",
                      [K.P, K.I64, K.P, K.I64, K.P, K.I64, K.I32])
_FP_MUL = K.Kernel("fp_mont_mul", "tpk_fp_mul",
                   [K.P, K.I64, K.P, K.I64, K.P, K.I64])


def _launch_binary(kernel, a, b, w, *extra):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // w
    if n == 0:
        return out
    a_, na = K.operand_rows(a, shape, 1)
    b_, nb = K.operand_rows(b, shape, 1)
    K.check_words(a_, w, kernel.name)
    K.check_words(b_, w, kernel.name)
    kernel(a_.data_ptr(), na, b_.data_ptr(), nb, out.data_ptr(), n, *extra)
    return out


def _to16(x: torch.Tensor) -> torch.Tensor:
    x64 = x.to(torch.int64) & M32
    return torch.stack((x64 & M16, x64 >> 16), dim=-1).flatten(-2)


def _from64(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _from16(l16: torch.Tensor) -> torch.Tensor:
    return _from64(l16[..., 0::2] | (l16[..., 1::2] << 16))


@functools.lru_cache(maxsize=None)
def _consts(ctx: FieldCtx, device: str):
    """Per-field constants on `device`: q as 16-bit limbs (L,), the
    16-bit column of each (32-bit word, 16-bit limb) product pair, and
    the float64 Toeplitz matrices of -q^-1 mod R (L, L) and q (L, 2L)
    that turn the two constant products of the reduction into exact
    matmuls (16-bit x 16-bit terms, at most L = 24 per column, stay far
    below 2^53)."""
    W = ctx.n_words
    L = 2 * W
    col = (2 * torch.arange(W)[:, None] + torch.arange(L)[None, :]).reshape(-1)
    ninv = (-pow(ctx.modulus, -1, ctx.mont_r)) % ctx.mont_r
    ninv16 = [(ninv >> (16 * k)) & M16 for k in range(L)]
    nmat = torch.zeros(L, L, dtype=torch.float64)
    qmat = torch.zeros(L, 2 * L, dtype=torch.float64)
    for i in range(L):
        for k in range(i, L):
            nmat[i, k] = ninv16[k - i]
        for k in range(L):
            qmat[i, i + k] = int(ctx.q16[k])
    return (torch.tensor(ctx.q16.tolist(), dtype=torch.int64, device=device),
            col.to(device), nmat.to(device), qmat.to(device))


def _carry16(t: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Propagate, in place, the carries of int64 column sums of either
    sign until every column but the last lies in [0, 2^16); the last
    keeps the rest (negative when the value is).  Each pass moves every
    column's high part one column up, so a column of c bits settles in
    about c/16 passes; `passes` of them run before the first test."""
    while True:
        for _ in range(passes):
            c = t[..., :-1] >> 16
            t[..., :-1] &= M16
            t[..., 1:] += c
        if not bool((t[..., :-1] >> 16).any()):
            return t
        passes = 1


def mont_mul_plain(a, b, ctx: FieldCtx):
    """a * b * R^-1 mod q in plain torch on any device: separated
    Montgomery reduction in int64,
      T = a b;  m = (T mod R)(-q^-1) mod R;  u = (T + m q) / R;
    then one conditional subtract (u < 2q).  a b is a 32-bit-word by
    16-bit-limb product (terms < 2^48, column sums < 2^52); the two
    constant products are float64 matmuls on 16-bit limbs, exact."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    W = ctx.n_words
    L = 2 * W
    q16, col, nmat, qmat = _consts(ctx, str(a.device))
    A = (a.expand(shape).reshape(-1, W).to(torch.int64) & M32)
    B = _to16(b.expand(shape)).reshape(-1, L)
    n = A.shape[0]
    t = torch.zeros(n, 2 * L + 1, dtype=torch.int64, device=a.device)
    t.index_add_(1, col, (A[:, :, None] * B[:, None, :]).reshape(n, W * L))
    t = _carry16(t, 4)
    m = (t[:, :L].to(torch.float64) @ nmat).to(torch.int64)
    m = _carry16(torch.cat([m, m.new_zeros(n, 1)], dim=1), 3)[:, :L]
    mq = (m.to(torch.float64) @ qmat).to(torch.int64)
    mq = _carry16(torch.cat([mq, mq.new_zeros(n, 1)], dim=1), 3)
    # the low halves of T and m q sum to exactly 0 or R: R unless T's low
    # half is 0 (then m = 0).  Adding that carry directly avoids a
    # carry ripple through all L low columns.
    u = t[:, L:] + mq[:, L:]
    u[:, 0] += (t[:, :L] != 0).any(dim=1).to(torch.int64)
    u = _carry16(u)
    d = _carry16(u - torch.cat([q16, q16.new_zeros(1)])[None])
    out = torch.where((d[:, -1] < 0)[:, None], u, d)[:, :L]
    return _from16(out).reshape(shape)


def _addsub_plain(a, b, ctx: FieldCtx, subtract: bool):
    """a + b or a - b mod q: both candidates (x and x - q for a sum,
    x and x + q for a difference) carried in one stacked pass, then the
    one in [0, q) kept."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    L = 2 * ctx.n_words
    q16 = _consts(ctx, str(a.device))[0]
    q = torch.cat([q16, q16.new_zeros(1)])
    A = _to16(a.expand(shape)).reshape(-1, L)
    B = _to16(b.expand(shape)).reshape(-1, L)
    x = torch.cat([A - B if subtract else A + B,
                   A.new_zeros(A.shape[0], 1)], dim=1)
    both = _carry16(torch.stack([x, x + q if subtract else x - q]))
    plain, moved = both[0], both[1]
    if subtract:
        out = torch.where((plain[:, -1] < 0)[:, None], moved, plain)
    else:
        out = torch.where((moved[:, -1] < 0)[:, None], plain, moved)
    return _from16(out[:, :L]).reshape(shape)


def add_mod_plain(a, b, ctx: FieldCtx):
    return _addsub_plain(a, b, ctx, False)


def sub_mod_plain(a, b, ctx: FieldCtx):
    return _addsub_plain(a, b, ctx, True)


def mont_mul(a, b, ctx: FieldCtx):
    """Montgomery product a*b*R^-1 mod q, canonical in and out."""
    if a.device.type == "cuda" or b.device.type == "cuda":
        kern = _FR_MUL if ctx is FR else _FP_MUL
        return _launch_binary(kern, a, b, ctx.n_words)
    return mont_mul_plain(a, b, ctx)


def add_mod(a, b, ctx: FieldCtx):
    if ctx is FR and (a.device.type == "cuda" or b.device.type == "cuda"):
        return _launch_binary(_FR_ADDSUB, a, b, ctx.n_words, 0)
    if a.device.type == "cuda":
        raise ValueError("add_mod: no Fp add kernel; Fp add/sub runs "
                         "inside the G1 kernels")
    return _addsub_plain(a, b, ctx, False)


def sub_mod(a, b, ctx: FieldCtx):
    if ctx is FR and (a.device.type == "cuda" or b.device.type == "cuda"):
        return _launch_binary(_FR_ADDSUB, a, b, ctx.n_words, 1)
    if a.device.type == "cuda":
        raise ValueError("sub_mod: no Fp sub kernel; Fp add/sub runs "
                         "inside the G1 kernels")
    return _addsub_plain(a, b, ctx, True)


def neg_mod(a, ctx: FieldCtx):
    zero = torch.zeros(1, ctx.n_words, dtype=torch.int32, device=a.device)
    return sub_mod(zero, a, ctx)


def is_zero(a):
    return (a == 0).all(dim=-1)


def to_mont(a, ctx: FieldCtx):
    r2 = ctx.const(ctx.mont_r % ctx.modulus, a.device)   # R^2 / R = R
    return mont_mul(a, r2, ctx)


def from_mont(a, ctx: FieldCtx):
    return mont_mul(a, ctx.const(1, a.device, mont=False), ctx)


# ---------------------------------------------------------------------------
# exponentiation, scans, batch inversion
# ---------------------------------------------------------------------------

def mont_pow(a_mont, exponent: int, ctx: FieldCtx):
    """a^e (Montgomery in and out), LSB-first square-and-multiply."""
    acc = ctx.const(1, a_mont.device).expand(a_mont.shape).contiguous()
    base = a_mont
    e = exponent
    while e:
        if e & 1:
            acc = mont_mul(acc, base, ctx)
        e >>= 1
        if e:
            base = mont_mul(base, base, ctx)
    return acc


def mont_inv(a_mont, ctx: FieldCtx):
    """Fermat inversion a^(q-2); zero maps to zero."""
    return mont_pow(a_mont, ctx.modulus - 2, ctx)


def scan(x, combine, reverse: bool = False):
    """Inclusive scan along axis 0 (Hillis-Steele: log2(n) levels, each
    one batched `combine` of the shifted array)."""
    if reverse:
        x = x.flip(0)
    n = x.shape[0]
    d = 1
    while d < n:
        x = torch.cat([x[:d], combine(x[d:], x[:-d])], dim=0)
        d *= 2
    return x.flip(0) if reverse else x


def prefix_mul_mont(a, ctx: FieldCtx, reverse: bool = False):
    """Inclusive prefix products along axis 0 (Montgomery)."""
    return scan(a, lambda x, y: mont_mul(x, y, ctx), reverse)


def batch_inv_mont(a_mont, ctx: FieldCtx):
    """Inverses along axis 0 (zeros -> zero): prefix and suffix
    products, one Fermat inversion of the total, then
    a_i^-1 = prefix_(i-1) * suffix_(i+1) * total^-1."""
    zero_mask = is_zero(a_mont)
    one = ctx.const(1, a_mont.device)
    a_fixed = torch.where(zero_mask[..., None], one, a_mont)
    prefix = prefix_mul_mont(a_fixed, ctx)
    suffix = prefix_mul_mont(a_fixed, ctx, reverse=True)
    total_inv = mont_inv(prefix[-1:], ctx)
    lead = one.expand((1,) + a_mont.shape[1:])
    fwd = torch.cat([lead, prefix[:-1]], dim=0)
    bwd = torch.cat([suffix[1:], lead], dim=0)
    out = mont_mul(mont_mul(fwd, bwd, ctx), total_inv, ctx)
    return torch.where(zero_mask[..., None], torch.zeros_like(out), out)


def powers_of(scalar_mont, n: int, ctx: FieldCtx):
    """[1, s, s^2, ..., s^(n-1)] (Montgomery) as an (n, W) tensor, by a
    prefix-product scan of [1, s, s, ...]."""
    base = scalar_mont.reshape(1, -1).expand(n, ctx.n_words).clone()
    base[0] = ctx.const(1, scalar_mont.device)[0]
    return prefix_mul_mont(base, ctx)
