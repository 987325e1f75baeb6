"""Schnorr signatures over JubJub — native sign/verify plus an
in-circuit verification gadget (the capability dusk-schnorr 0.7.1
declares in the reference's Cargo.toml:22 but never imports;
SURVEY.md §2.9 marks it an intended stretch component).

Scheme (Poseidon challenge):
  keypair:  pk = sk * G                     (sk in JubJub scalar field)
  sign:     r  = H(sk, m) mod order  (deterministic nonce)
            R  = r * G
            c  = H(R.x, R.y, pk.x, pk.y, m) mod order
            s  = r + c * sk mod order
  verify:   s * G == R + c * pk

The gadget verifies the group equation fully in-circuit: the challenge
is the in-circuit Poseidon sponge of (R, pk, m), canonically
bit-decomposed (composer.canonical_bit_decompose proves the bits are
the unique integer lift < r), and fed to a boolean-bit variable-base
ladder.  No reduction gadget is needed: pk lies in the prime-order
subgroup (cofactor-8 outliers are rejected by native verify/keygen),
where [c]pk == [c mod order]pk for the full 255-bit canonical c — so
the circuit scalar-mul agrees with the native `c % JUBJUB_ORDER`
arithmetic exactly (VERDICT round-1 task 9).
"""

from ..params import R_MOD, JUBJUB_ORDER
from ..curves import jubjub
from ..cs import Composer, PointVar
from . import poseidon


def keygen(sk: int):
    sk %= JUBJUB_ORDER
    return sk, jubjub.mul(jubjub.GENERATOR, sk)


def _challenge(R, pk, message: int) -> int:
    return poseidon.sponge_hash(
        [R[0], R[1], pk[0], pk[1], message % R_MOD]) % JUBJUB_ORDER


def sign(sk: int, message: int):
    sk %= JUBJUB_ORDER
    r = poseidon.sponge_hash([sk, message % R_MOD]) % JUBJUB_ORDER
    if r == 0:
        r = 1
    R = jubjub.mul(jubjub.GENERATOR, r)
    pk = jubjub.mul(jubjub.GENERATOR, sk)
    c = _challenge(R, pk, message)
    s = (r + c * sk) % JUBJUB_ORDER
    return (R, s)


def verify(pk, message: int, signature) -> bool:
    R, s = signature
    # prime-order membership, not just on-curve: a low-order component
    # in pk or R would break the unique-dlog binding the scheme (and
    # the gadget's no-reduction argument) relies on
    if not (jubjub.in_subgroup(R) and jubjub.in_subgroup(pk)):
        return False
    c = _challenge(R, pk, message)
    lhs = jubjub.mul(jubjub.GENERATOR, s)
    rhs = jubjub.add(R, jubjub.mul(pk, c))
    return lhs == rhs


def verify_gadget(cs: Composer, pk: PointVar, signature, message: int):
    """In-circuit verification: s*G == R + H(R, pk, m)*pk with the
    challenge hashed, canonically decomposed, and scalar-multiplied
    entirely inside the circuit.  `pk` must be a prime-order-subgroup
    point (see module docstring)."""
    R, s = signature
    r_var = PointVar(cs.add_input(R[0]), cs.add_input(R[1]), R)
    s_var = cs.add_input(s)
    m_var = cs.add_input(message % R_MOD)
    cs.constrain_to_constant(m_var, 0, (-(message % R_MOD)) % R_MOD)

    c_var = poseidon.sponge_gadget(
        cs, [r_var.x, r_var.y, pk.x, pk.y, m_var])
    c_bits = cs.canonical_bit_decompose(c_var)

    lhs = cs.fixed_base_scalar_mul(s_var, jubjub.GENERATOR)
    c_pk = cs.variable_base_scalar_mul_bits(c_bits, pk)
    rhs = cs.point_addition_gate(r_var, c_pk)
    cs.assert_equal_point(lhs, rhs)
    return lhs


# ---------------------------------------------------------------------------
# Double-key variant (dusk-schnorr's `SignatureDouble` analog: one
# nonce/response proves knowledge of sk under BOTH fixed bases G and
# G_NUMS — used for keys published as (sk*G, sk*G_NUMS) pairs).
# ---------------------------------------------------------------------------


def keygen_double(sk: int):
    sk %= JUBJUB_ORDER
    return (sk, jubjub.mul(jubjub.GENERATOR, sk),
            jubjub.mul(jubjub.GENERATOR_NUMS, sk))


def _challenge_double(R, Rp, pk, pk2, message: int) -> int:
    return poseidon.sponge_hash(
        [R[0], R[1], Rp[0], Rp[1], pk[0], pk[1], pk2[0], pk2[1],
         message % R_MOD]) % JUBJUB_ORDER


def sign_double(sk: int, message: int):
    """Single response over both bases:
      R = r*G, R' = r*G_NUMS, c = H(R, R', pk, pk', m),
      s = r + c*sk;  signature = (R, R', s)."""
    sk %= JUBJUB_ORDER
    r = poseidon.sponge_hash([sk, message % R_MOD, 2]) % JUBJUB_ORDER
    if r == 0:
        r = 1
    R = jubjub.mul(jubjub.GENERATOR, r)
    Rp = jubjub.mul(jubjub.GENERATOR_NUMS, r)
    pk = jubjub.mul(jubjub.GENERATOR, sk)
    pk2 = jubjub.mul(jubjub.GENERATOR_NUMS, sk)
    c = _challenge_double(R, Rp, pk, pk2, message)
    s = (r + c * sk) % JUBJUB_ORDER
    return (R, Rp, s)


def verify_double(pk, pk2, message: int, signature) -> bool:
    """s*G == R + c*pk  AND  s*G_NUMS == R' + c*pk2: the shared s ties
    the discrete logs of pk (base G) and pk2 (base G_NUMS) together."""
    R, Rp, s = signature
    # subgroup checks are soundness-critical here: a low-order offset
    # on pk2/R' would let a signer pass verification with pk2 whose
    # dlog does NOT match pk's (the equality the scheme asserts)
    if not all(jubjub.in_subgroup(p) for p in (R, Rp, pk, pk2)):
        return False
    c = _challenge_double(R, Rp, pk, pk2, message)
    if jubjub.mul(jubjub.GENERATOR, s) != jubjub.add(
            R, jubjub.mul(pk, c)):
        return False
    return jubjub.mul(jubjub.GENERATOR_NUMS, s) == jubjub.add(
        Rp, jubjub.mul(pk2, c))


def verify_double_gadget(cs: Composer, pk: PointVar, pk2: PointVar,
                         signature, message: int):
    """In-circuit double-key verification: one challenge decomposition
    shared by both group equations (the expensive parts are the two
    fixed-base and two variable-base ladders)."""
    R, Rp, s = signature
    r_var = PointVar(cs.add_input(R[0]), cs.add_input(R[1]), R)
    rp_var = PointVar(cs.add_input(Rp[0]), cs.add_input(Rp[1]), Rp)
    s_var = cs.add_input(s)
    m_var = cs.add_input(message % R_MOD)
    cs.constrain_to_constant(m_var, 0, (-(message % R_MOD)) % R_MOD)

    c_var = poseidon.sponge_gadget(
        cs, [r_var.x, r_var.y, rp_var.x, rp_var.y,
             pk.x, pk.y, pk2.x, pk2.y, m_var])
    c_bits = cs.canonical_bit_decompose(c_var)

    lhs = cs.fixed_base_scalar_mul(s_var, jubjub.GENERATOR)
    rhs = cs.point_addition_gate(
        r_var, cs.variable_base_scalar_mul_bits(c_bits, pk))
    cs.assert_equal_point(lhs, rhs)

    lhs2 = cs.fixed_base_scalar_mul(s_var, jubjub.GENERATOR_NUMS)
    rhs2 = cs.point_addition_gate(
        rp_var, cs.variable_base_scalar_mul_bits(c_bits, pk2))
    cs.assert_equal_point(lhs2, rhs2)
    return lhs, lhs2
