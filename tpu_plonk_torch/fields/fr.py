"""Host-side arithmetic in Fr (the BLS12-381 scalar field == circuit field).

Plain-Python-int implementation: exact, branch-light, fast enough for
witness generation, transcripts, and the verifier.  Bulk/device math
lives in fields/device.py (batched limb kernels).

Parity: semantics of `dusk_bls12_381::BlsScalar` as exercised by the
reference (SURVEY.md §2.4): add/sub/mul/neg/invert/pow, `reduce`-then-
compare ordering, `divn`, `pow_of_2`, and 32-byte little-endian canonical
serialization (reference src/zk/gadgets.rs:230).
"""

from ..params import R_MOD

MOD = R_MOD


def add(a: int, b: int) -> int:
    return (a + b) % MOD


def sub(a: int, b: int) -> int:
    return (a - b) % MOD


def mul(a: int, b: int) -> int:
    return (a * b) % MOD


def neg(a: int) -> int:
    return (-a) % MOD


def inv(a: int) -> int:
    if a % MOD == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, -1, MOD)


def inv_or_zero(a: int) -> int:
    """dusk `invert().unwrap_or(zero)` semantics (reference gadgets.rs:66)."""
    a %= MOD
    return 0 if a == 0 else pow(a, -1, MOD)


def fpow(a: int, e: int) -> int:
    return pow(a, e, MOD)


def batch_inv(xs):
    """Montgomery batch inversion; zeros map to zero (masked out)."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * (x if x % MOD else 1) % MOD
    acc = pow(prefix[n], -1, MOD)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i] % MOD
        if x:
            out[i] = acc * prefix[i] % MOD
            acc = acc * x % MOD
    return out


def to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian (dusk-bytes layout)."""
    return (a % MOD).to_bytes(32, "little")


def from_bytes(b: bytes) -> int:
    """Strict canonical deserialization: rejects non-reduced values."""
    v = int.from_bytes(b, "little")
    if v >= MOD:
        raise ValueError("non-canonical Fr encoding")
    return v


def from_bytes_wide(b: bytes) -> int:
    """64-byte little-endian reduction (merlin `challenge_scalar` path)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % MOD


def sqrt(a: int):
    """Tonelli-Shanks square root (Fr has 2-adicity 32); None if QNR."""
    from ..params import ROOT_OF_UNITY, T_ODD, TWO_ADICITY
    a %= MOD
    if a == 0:
        return 0
    if pow(a, (MOD - 1) // 2, MOD) != 1:
        return None
    # r = a^((t+1)/2), t-part fixed up by powers of the 2^32 root of unity
    c = ROOT_OF_UNITY
    r = pow(a, (T_ODD + 1) // 2, MOD)
    t = pow(a, T_ODD, MOD)
    m = TWO_ADICITY
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % MOD
            i += 1
        b = pow(c, 1 << (m - i - 1), MOD)
        r = r * b % MOD
        c = b * b % MOD
        t = t * c % MOD
        m = i
    return r


def reduce(a: int) -> int:
    """Canonical form (dusk `BlsScalar::reduce`, used at reference
    gadgets.rs:241)."""
    return a % MOD


def divn(a: int, k: int) -> int:
    """Right-shift of the canonical form by k bits (dusk
    `BlsScalar::divn`, reference gadgets.rs:245)."""
    return (a % MOD) >> k


def pow_of_2(k: int) -> int:
    """2^k as a field element (dusk `BlsScalar::pow_of_2`,
    reference gadgets.rs:254)."""
    return pow(2, k, MOD)


def bits_count(a: int) -> int:
    """Minimal bit length, matching reference gadgets.rs:240-248
    (bits_count(0) == bits_count(1) == 1)."""
    a %= MOD
    return max(a.bit_length(), 1)


def num_bits_closest_power_of_two(a: int) -> int:
    """Bit length of the closest power of two >= 2^bits_count(a)
    (reference gadgets.rs:252-256)."""
    return bits_count(1 << bits_count(a))


def scalar_to_bits(a: int):
    """LE bit decomposition of the canonical form, 256 entries
    (reference gadgets.rs:228-237)."""
    a %= MOD
    return [(a >> i) & 1 for i in range(256)]
