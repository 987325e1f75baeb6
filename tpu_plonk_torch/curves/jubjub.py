"""Host-side JubJub: twisted Edwards curve -x^2 + y^2 = 1 + d x^2 y^2
over Fr (the circuit field), as used by the reference's Pedersen /
ownership gadgets (src/zk/gadgets.rs:21, src/zk/circuits.rs:64).

Edwards addition is *complete* on the prime-order subgroup — no special
cases — which is also why the in-circuit ECC widgets (cs/composer.py)
can encode it as a single algebraic gate per step.
"""

from ..params import (
    R_MOD, JUBJUB_D, JUBJUB_ORDER,
    JUBJUB_GENERATOR_X, JUBJUB_GENERATOR_Y,
    JUBJUB_GENERATOR_NUMS_X, JUBJUB_GENERATOR_NUMS_Y,
)

D = JUBJUB_D
IDENTITY = (0, 1)
GENERATOR = (JUBJUB_GENERATOR_X, JUBJUB_GENERATOR_Y)
GENERATOR_NUMS = (JUBJUB_GENERATOR_NUMS_X, JUBJUB_GENERATOR_NUMS_Y)


def is_on_curve(p) -> bool:
    x, y = p
    x2 = x * x % R_MOD
    y2 = y * y % R_MOD
    return (y2 - x2 - 1 - D * x2 % R_MOD * y2) % R_MOD == 0


def add(p, q):
    """Complete twisted Edwards addition (a = -1)."""
    x1, y1 = p
    x2, y2 = q
    x1y2 = x1 * y2 % R_MOD
    y1x2 = y1 * x2 % R_MOD
    y1y2 = y1 * y2 % R_MOD
    x1x2 = x1 * x2 % R_MOD
    dxy = D * x1y2 % R_MOD * y1x2 % R_MOD
    x3 = (x1y2 + y1x2) * pow(1 + dxy, -1, R_MOD) % R_MOD
    y3 = (y1y2 + x1x2) * pow(1 - dxy, -1, R_MOD) % R_MOD
    return (x3, y3)


def double(p):
    return add(p, p)


def neg(p):
    return ((-p[0]) % R_MOD, p[1])


def mul(p, k: int):
    k %= JUBJUB_ORDER
    r = IDENTITY
    while k:
        if k & 1:
            r = add(r, p)
        p = add(p, p)
        k >>= 1
    return r


def in_subgroup(p) -> bool:
    """Prime-order subgroup membership: [order]P == identity, computed
    WITHOUT mul()'s scalar reduction (which would make the check
    trivially true — k % order == 0)."""
    if not is_on_curve(p):
        return False
    r = IDENTITY
    k = JUBJUB_ORDER
    while k:
        if k & 1:
            r = add(r, p)
        p = add(p, p)
        k >>= 1
    return r == IDENTITY


def to_bytes(p) -> bytes:
    """32-byte LE y with the sign of x in the top bit (dusk layout)."""
    x, y = p
    b = bytearray(y.to_bytes(32, "little"))
    b[31] |= (x & 1) << 7
    return bytes(b)


def from_bytes(b: bytes):
    assert len(b) == 32
    sign = b[31] >> 7
    y = int.from_bytes(bytes(b[:31]) + bytes([b[31] & 0x7F]), "little")
    if y >= R_MOD:
        raise ValueError("non-canonical y")
    # -x^2 + y^2 = 1 + d x^2 y^2  =>  x^2 = (y^2 - 1) / (d y^2 + 1)
    y2 = y * y % R_MOD
    x2 = (y2 - 1) * pow(D * y2 + 1, -1, R_MOD) % R_MOD
    from ..fields import fr
    x = fr.sqrt(x2)
    if x is None:
        raise ValueError("not on curve")
    if x & 1 != sign:
        x = (-x) % R_MOD
    return (x, y)
