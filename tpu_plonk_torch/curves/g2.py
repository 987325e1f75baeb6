"""Host-side G2 (BLS12-381 twist, y^2 = x^3 + 4(u+1) over Fp2).

Only the verifier needs G2 (SRS has [1]G2, [tau]G2; the batched KZG check
does 2 pairings — SURVEY.md §3.3), so a simple affine implementation
on Python ints is the right cost/complexity point.
"""

from ..params import P_MOD, G2_GEN_X, G2_GEN_Y, R_MOD
from ..fields import fp

GEN = (G2_GEN_X, G2_GEN_Y)
INF = None
B2 = fp.f2_mul_by_nonresidue((4, 0))  # 4(u+1)

# psi = untwist o Frobenius o twist endomorphism constants:
# psi(x, y) = (PSI_X * frob(x), PSI_Y * frob(y)) with
# PSI_X = (u+1)^-((p-1)/3), PSI_Y = (u+1)^-((p-1)/2).  A curve point is
# in the prime-order subgroup iff psi(P) == [z]P (z = -BLS_T); this is
# the zkcrypto G2 `is_torsion_free` check.  Re-derived in tests.
BLS_T = 0xD201000000010000
PSI_X = (0, int(
    "4002409555221667392624310435006688643935503118305586438271171395842"
    "971157480381377015405980053539358417135540939437"))
PSI_Y = (int(
    "2973677408986561043442465346520108879172042883009249989176415018091"
    "420807192182638567116318576472649347015917690530"), int(
    "1028732146235106349975324479215795277384839936929757896155643118032"
    "610843298655225875571310552543014690878354869257"))


def is_on_curve(p):
    if p is None:
        return True
    x, y = p
    lhs = fp.f2_sqr(y)
    rhs = fp.f2_add(fp.f2_mul(fp.f2_sqr(x), x), B2)
    return lhs == rhs


def neg(p):
    if p is None:
        return None
    return (p[0], fp.f2_neg(p[1]))


def add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fp.f2_add(y1, y2) == fp.F2_ZERO:
            return None
        lam = fp.f2_mul(fp.f2_scale(fp.f2_sqr(x1), 3), fp.f2_inv(fp.f2_scale(y1, 2)))
    else:
        lam = fp.f2_mul(fp.f2_sub(y2, y1), fp.f2_inv(fp.f2_sub(x2, x1)))
    x3 = fp.f2_sub(fp.f2_sub(fp.f2_sqr(lam), x1), x2)
    y3 = fp.f2_sub(fp.f2_mul(lam, fp.f2_sub(x1, x3)), y1)
    return (x3, y3)


def mul(p, k: int):
    k %= R_MOD
    r = None
    while k:
        if k & 1:
            r = add(r, p)
        p = add(p, p)
        k >>= 1
    return r


def to_bytes(p) -> bytes:
    """96-byte compressed encoding: BE x.c1 || x.c0, zkcrypto flag bits."""
    if p is None:
        b = bytearray(96)
        b[0] = 0b1100_0000
        return bytes(b)
    (x, y) = p
    b = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    b[0] |= 0b1000_0000
    # lexicographic sign of y: compare c1 first, then c0 (zkcrypto order)
    neg_y = fp.f2_neg(y)
    if (y[1], y[0]) > (neg_y[1], neg_y[0]):
        b[0] |= 0b0010_0000
    return bytes(b)


def _frob(a):
    return (a[0], (-a[1]) % P_MOD)


def is_torsion_free(p) -> bool:
    """Prime-subgroup membership via psi(P) == [z]P == -[BLS_T]P."""
    if p is None:
        return True
    psi_p = (fp.f2_mul(_frob(p[0]), PSI_X), fp.f2_mul(_frob(p[1]), PSI_Y))
    return psi_p == neg(mul_abs(p, BLS_T))


def mul_abs(p, k: int):
    """[k]P for a plain non-negative integer k (no mod-r reduction —
    subgroup checks must multiply by the raw parameter)."""
    r = None
    while k:
        if k & 1:
            r = add(r, p)
        p = add(p, p)
        k >>= 1
    return r


def from_bytes(b: bytes, check_subgroup: bool = True):
    """Strict compressed decoding (same validations as g1.from_bytes:
    length, flags, canonical c0/c1 < p, zero infinity payload, on-curve,
    prime-subgroup by default)."""
    if len(b) != 96:
        raise ValueError("G2 encoding must be 96 bytes")
    flags = b[0]
    if not flags & 0b1000_0000:
        raise ValueError("only compressed G2 encodings supported")
    if flags & 0b0100_0000:
        if (flags & 0b0011_1111) or any(b[1:]):
            raise ValueError("nonzero payload bits in G2 infinity encoding")
        return None
    c1 = int.from_bytes(bytes([flags & 0b0001_1111]) + b[1:48], "big")
    c0 = int.from_bytes(b[48:96], "big")
    if c0 >= P_MOD or c1 >= P_MOD:
        raise ValueError("non-canonical G2 x coordinate")
    x = (c0, c1)
    rhs = fp.f2_add(fp.f2_mul(fp.f2_sqr(x), x), B2)
    y = _f2_sqrt(rhs)
    if y is None:
        raise ValueError("x not on curve (G2)")
    neg_y = fp.f2_neg(y)
    y_sign = int((y[1], y[0]) > (neg_y[1], neg_y[0]))
    if y_sign != ((flags >> 5) & 1):
        y = neg_y
    p = (x, y)
    if check_subgroup and not is_torsion_free(p):
        raise ValueError("G2 point not in prime-order subgroup")
    return p


def _f2_sqrt(a):
    """Square root in Fp2 (p % 4 == 3): candidate a^((p^2+7)/16) route is
    unneeded; use the simple complex method."""
    if a == fp.F2_ZERO:
        return fp.F2_ZERO
    a0, a1 = a
    if a1 == 0:
        r = fp.sqrt(a0)
        if r is not None:
            return (r, 0)
        # sqrt of non-residue c: sqrt(c) = sqrt(-c)*u since u^2=-1
        r = fp.sqrt((-a0) % P_MOD)
        return None if r is None else (0, r)
    # norm = a0^2 + a1^2; alpha = sqrt(norm); x0 = sqrt((a0+alpha)/2)
    norm = (a0 * a0 + a1 * a1) % P_MOD
    alpha = fp.sqrt(norm)
    if alpha is None:
        return None
    inv2 = pow(2, -1, P_MOD)
    delta = (a0 + alpha) * inv2 % P_MOD
    x0 = fp.sqrt(delta)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % P_MOD
        x0 = fp.sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0, -1, P_MOD) % P_MOD
    return (x0, x1)
