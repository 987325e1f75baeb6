"""Host-side G1 (BLS12-381, y^2 = x^3 + 4 over Fp).

Affine points are `(x, y)` int tuples; the point at infinity is `None`.
Serialization follows the zkcrypto/dusk 48-byte compressed convention
(big-endian x, flag bits in the top byte) so that SRS / verifier keys /
proofs can round-trip against dusk-bytes layouts (SURVEY.md §2.9).

The bulk MSM lives in pcs/msm.py (host Pippenger) and pcs/msm_csr.py
(TPU limb kernels); this module is the scalar/one-off path.
"""

from ..params import P_MOD, G1_GEN_X, G1_GEN_Y, R_MOD
from ..fields import fp

GEN = (G1_GEN_X, G1_GEN_Y)
INF = None

# GLV endomorphism phi(x, y) = (BETA*x, y): BETA is the cube root of
# unity in Fp paired with eigenvalue lambda = z^2 - 1 mod r (z = -BLS_T,
# the BLS12-381 parameter).  A point P of the curve group is in the
# prime-order subgroup iff phi(P) == -[z^2]P (Scott, eprint 2021/1130;
# the zkcrypto `is_torsion_free` check).  Both constants are public
# curve parameters, re-derived in tests/test_curves.py.
BLS_T = 0xD201000000010000
BETA_ENDO = int(
    "0x5f19672fdf76ce51ba69c6076a0f77eaddb3a93be6f89688de17d81362"
    "0a00022e01fffffffefffe", 16)


def is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 4) % P_MOD == 0


def neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P_MOD)


def add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P_MOD == 0:
            return None
        # doubling
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P_MOD) % P_MOD
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P_MOD) % P_MOD
    x3 = (lam * lam - x1 - x2) % P_MOD
    y3 = (lam * (x1 - x3) - y1) % P_MOD
    return (x3, y3)


def double(p):
    return add(p, p)


def mul(p, k: int):
    """[k]P, affine in/out.  Runs the inversion-free Jacobian ladder
    internally (the affine `add` pays one Fp inversion per step, which
    made the verifier's ~20-scalar-mul reconstruction its hottest
    block); one inversion total to normalize back to affine."""
    if p is None:
        return None
    k %= R_MOD
    if k == 0:
        return None
    x, y, z = _jmul(p, k)
    if z == 0:
        return None
    zi = pow(z, -1, P_MOD)
    zi2 = zi * zi % P_MOD
    return (x * zi2 % P_MOD, y * zi2 * zi % P_MOD)


def to_bytes(p) -> bytes:
    """48-byte compressed encoding: BE x, top bits = [compressed, infinity,
    y-is-lexicographically-largest]."""
    if p is None:
        b = bytearray(48)
        b[0] = 0b1100_0000
        return bytes(b)
    x, y = p
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= 0b1000_0000
    if fp.sgn0(y):
        b[0] |= 0b0010_0000
    return bytes(b)


# --- minimal Jacobian ladder (validation only; bulk MSM lives in pcs/) ----

def _jdbl(p):
    x, y, z = p
    if y == 0:
        return (0, 1, 0)
    a = x * x % P_MOD
    b = y * y % P_MOD
    c = b * b % P_MOD
    d = 2 * ((x + b) * (x + b) - a - c) % P_MOD
    e = 3 * a % P_MOD
    x3 = (e * e - 2 * d) % P_MOD
    return (x3, (e * (d - x3) - 8 * c) % P_MOD, 2 * y * z % P_MOD)


def _jmul(p, k: int):
    """[k] * affine p in Jacobian coords (inversion-free ladder)."""
    acc = (0, 1, 0)
    cur = (p[0], p[1], 1)
    while k:
        if k & 1:
            acc = _jadd(acc, cur)
        cur = _jdbl(cur)
        k >>= 1
    return acc


def _jadd(p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1s = z1 * z1 % P_MOD
    z2s = z2 * z2 % P_MOD
    u1 = x1 * z2s % P_MOD
    u2 = x2 * z1s % P_MOD
    s1 = y1 * z2s * z2 % P_MOD
    s2 = y2 * z1s * z1 % P_MOD
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jdbl(p)
    h = (u2 - u1) % P_MOD
    r = (s2 - s1) % P_MOD
    h2 = h * h % P_MOD
    h3 = h2 * h % P_MOD
    v = u1 * h2 % P_MOD
    x3 = (r * r - h3 - 2 * v) % P_MOD
    return (x3, (r * (v - x3) - s1 * h3) % P_MOD, h * z1 * z2 % P_MOD)


def _jeq(p, q):
    """Jacobian equality (cross-multiplied)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0 or z2 == 0:
        return z1 == z2
    z1s = z1 * z1 % P_MOD
    z2s = z2 * z2 % P_MOD
    return (x1 * z2s - x2 * z1s) % P_MOD == 0 and \
        (y1 * z2s * z2 - y2 * z1s * z1) % P_MOD == 0


def is_torsion_free(p) -> bool:
    """Prime-subgroup membership: phi(P) == -[z^2]P (see BETA_ENDO).
    ~130 Jacobian ops — cheap enough to run on every deserialized point."""
    if p is None:
        return True
    endo = (p[0] * BETA_ENDO % P_MOD, p[1], 1)
    t2p = _jmul((p[0], (-p[1]) % P_MOD), BLS_T * BLS_T)
    return _jeq(endo, t2p)


def from_bytes(b: bytes, check_subgroup: bool = True):
    """Strict zkcrypto/dusk-bytes compressed decoding: rejects bad
    length, uncompressed flag, non-canonical x (>= p), nonzero payload
    bits under the infinity flag, off-curve x, and (by default) points
    outside the r-torsion subgroup.  Proofs / keys / SRS are untrusted
    inputs; `check_subgroup=False` is for callers that batch-validate."""
    if len(b) != 48:
        raise ValueError("G1 encoding must be 48 bytes")
    flags = b[0]
    if not flags & 0b1000_0000:
        raise ValueError("only compressed G1 encodings supported")
    if flags & 0b0100_0000:
        if (flags & 0b0011_1111) or any(b[1:]):
            raise ValueError("nonzero payload bits in G1 infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0b0001_1111]) + b[1:], "big")
    if x >= P_MOD:
        raise ValueError("non-canonical G1 x coordinate")
    y = fp.sqrt((x * x * x + 4) % P_MOD)
    if y is None:
        raise ValueError("x not on curve")
    if fp.sgn0(y) != ((flags >> 5) & 1):
        y = (-y) % P_MOD
    p = (x, y)
    if check_subgroup and not is_torsion_free(p):
        raise ValueError("G1 point not in prime-order subgroup")
    return p
