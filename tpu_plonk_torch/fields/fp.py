"""Host-side arithmetic in Fp (BLS12-381 base field) and its tower
Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (u+1)), Fp12 = Fp6[w]/(w^2 - v).

Used by the host G1/G2 group law, serialization, and the pairing-based
verifier (SURVEY.md §3.3 — verifier is O(1), host CPU is the right place).
Fp2/Fp6/Fp12 elements are tuples of ints / tuples, kept allocation-light.
"""

from ..params import P_MOD

MOD = P_MOD


def add(a, b):
    return (a + b) % MOD


def sub(a, b):
    return (a - b) % MOD


def mul(a, b):
    return (a * b) % MOD


def neg(a):
    return (-a) % MOD


def inv(a):
    if a % MOD == 0:
        raise ZeroDivisionError("inverse of zero in Fp")
    return pow(a, -1, MOD)


def sqrt(a):
    """Square root in Fp (p % 4 == 3 so a^((p+1)/4)); None if non-residue."""
    a %= MOD
    r = pow(a, (MOD + 1) // 4, MOD)
    return r if r * r % MOD == a else None


def sgn0(a):
    """Lexicographic 'sign' used by compressed-point flag bits: is the
    element strictly greater than its negation, i.e. a > p - a."""
    a %= MOD
    return int(a > MOD - a)


# --- Fp2 --------------------------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)


def f2_add(a, b):
    return ((a[0] + b[0]) % MOD, (a[1] + b[1]) % MOD)


def f2_sub(a, b):
    return ((a[0] - b[0]) % MOD, (a[1] - b[1]) % MOD)


def f2_neg(a):
    return ((-a[0]) % MOD, (-a[1]) % MOD)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) with u^2 = -1 (Karatsuba)
    t0 = a[0] * b[0] % MOD
    t1 = a[1] * b[1] % MOD
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % MOD
    return ((t0 - t1) % MOD, (t2 - t0 - t1) % MOD)


def f2_sqr(a):
    # (a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t = a[0] * a[1] % MOD
    return ((a[0] + a[1]) * (a[0] - a[1]) % MOD, 2 * t % MOD)


def f2_scale(a, k):
    return (a[0] * k % MOD, a[1] * k % MOD)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, MOD)
    return (a[0] * d % MOD, (-a[1]) * d % MOD)


def f2_conj(a):
    return (a[0], (-a[1]) % MOD)


def f2_mul_by_nonresidue(a):
    # * (u + 1)
    return ((a[0] - a[1]) % MOD, (a[0] + a[1]) % MOD)


def f2_frobenius(a):
    return f2_conj(a)


# --- Fp6 (triples of Fp2) ---------------------------------------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_by_nonresidue(
        f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
                f2_mul_by_nonresidue(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_by_nonresidue(a):
    # * v : (a0, a1, a2) -> (a2 * (u+1), a0, a1)
    return (f2_mul_by_nonresidue(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_by_nonresidue(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_by_nonresidue(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0),
                      f2_mul_by_nonresidue(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


# --- Fp12 (pairs of Fp6) ----------------------------------------------------

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_nonresidue(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sqr(a):
    # complex squaring: (a0 + a1 w)^2 with w^2 = v:
    #   c0 = (a0 + a1)(a0 + v a1) - t - v t,  c1 = 2t,  t = a0 a1
    a0, a1 = a
    t = f6_mul(a0, a1)
    vt = f6_mul_by_nonresidue(t)
    c0 = f6_sub(f6_sub(
        f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_by_nonresidue(a1))),
        t), vt)
    return (c0, f6_add(t, t))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_sqr(a0), f6_mul_by_nonresidue(f6_sqr(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


# Frobenius coefficients for Fp2 components: (u+1)^((p-1)/k) powers.
_FROB_C1 = [
    pow((1, 1)[0], 0)  # placeholder replaced below
]


def _f2_pow(a, e):
    r = F2_ONE
    while e:
        if e & 1:
            r = f2_mul(r, a)
        a = f2_sqr(a)
        e >>= 1
    return r


#: gamma_{1,i} = (u+1)^(i*(p-1)/6) for i in 0..5 (Fp12 Frobenius constants)
FROB_GAMMA1 = [_f2_pow((1, 1), i * (MOD - 1) // 6) for i in range(6)]


def f12_frobenius(a):
    """x -> x^p on Fp12."""
    (a0, a1) = a
    c0 = tuple(f2_mul(f2_conj(a0[i]), FROB_GAMMA1[2 * i]) for i in range(3))
    c1 = tuple(f2_mul(f2_conj(a1[i]), FROB_GAMMA1[2 * i + 1]) for i in range(3))
    return (c0, c1)


def f12_pow(a, e):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, a)
        a = f12_sqr(a)
        e >>= 1
    return r


# --- cyclotomic-subgroup fast ops (verifier final exponentiation) -----------
#
# After the easy part of the final exponentiation, f lies in the
# cyclotomic subgroup (f^(p^4-p^2+1) == 1), where (a) inversion is
# conjugation and (b) squaring admits the Granger–Scott Fp4-based
# shortcut.  Viewing Fp12 = Fp4[w] with Fp4 = Fp2[s]/(s^2 - xi), s=w^3:
# the six Fp2 coefficients regroup as g0=(z0,z1), g1=(z2,z3),
# g2=(z4,z5) with z0=c0[0], z1=c1[1], z2=c1[0], z3=c0[2], z4=c0[1],
# z5=c1[2].  Correctness is asserted against f12_sqr on cyclotomic
# elements in tests/test_pairing.py.


def _fp4_sqr(a, b):
    """(a + b*s)^2 in Fp4 = Fp2[s]/(s^2 - xi)."""
    t0 = f2_sqr(a)
    t1 = f2_sqr(b)
    c0 = f2_add(f2_mul_by_nonresidue(t1), t0)
    c1 = f2_sub(f2_sub(f2_sqr(f2_add(a, b)), t0), t1)
    return c0, c1


def f12_cyclo_sqr(f):
    """Granger–Scott squaring; valid ONLY for cyclotomic-subgroup f."""
    (c00, c01, c02), (c10, c11, c12) = f
    z0, z4, z3 = c00, c01, c02
    z2, z1, z5 = c10, c11, c12

    def three_minus_two(t, z):
        # 3t - 2z
        return f2_sub(f2_add(f2_add(t, t), t), f2_add(z, z))

    def three_plus_two(t, z):
        return f2_add(f2_add(f2_add(t, t), t), f2_add(z, z))

    t0, t1 = _fp4_sqr(z0, z1)
    z0 = three_minus_two(t0, z0)
    z1 = three_plus_two(t1, z1)
    t0, t1 = _fp4_sqr(z2, z3)
    t2, t3 = _fp4_sqr(z4, z5)
    z4 = three_minus_two(t0, z4)
    z5 = three_plus_two(t1, z5)
    z2 = three_plus_two(f2_mul_by_nonresidue(t3), z2)
    z3 = three_minus_two(t2, z3)
    return ((z0, z4, z3), (z2, z1, z5))


def f12_cyclo_pow(a, e: int):
    """a^e for cyclotomic a, e >= 0: NAF digits so the -1 steps reuse
    the free conjugation-inverse; squarings are Granger–Scott."""
    if e == 0:
        return F12_ONE
    naf = []
    while e:
        if e & 1:
            d = 2 - (e & 3)
            e -= d
        else:
            d = 0
        naf.append(d)
        e >>= 1
    a_conj = f12_conj(a)
    r = F12_ONE
    for d in reversed(naf):
        r = f12_cyclo_sqr(r)
        if d == 1:
            r = f12_mul(r, a)
        elif d == -1:
            r = f12_mul(r, a_conj)
    return r
