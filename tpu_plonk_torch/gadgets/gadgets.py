"""The gadget library — behavioral parity with the reference's
src/zk/gadgets.rs and src/zk/allocated_scalar.rs (SURVEY.md §2.2),
gate-for-gate where noted.

Quirks reproduced deliberately (they shape gate counts / proof shape):
  - scalar_decomposition_gadget allocates ALL 256 bit witnesses and
    then constrains only the first num_bits (gadgets.rs:195-201);
  - maybe_equal is a non-constraining indicator (gadgets.rs:45-48);
  - min_bound/max_bound compute x-min / max-1-x with an add gate whose
    q_r = 0 reuses the witness var as a dummy wire (gadgets.rs:129,163).
"""

from ..params import R_MOD
from ..fields import fr
from ..curves import jubjub
from ..cs import Composer, PointVar


class AllocatedScalar:
    """Witness variable + its concrete value (allocated_scalar.rs:26-39)."""

    __slots__ = ("var", "scalar")

    def __init__(self, var: int, scalar: int):
        self.var = var
        self.scalar = scalar % R_MOD

    @staticmethod
    def allocate(composer: Composer, scalar: int) -> "AllocatedScalar":
        var = composer.add_input(scalar)
        return AllocatedScalar(var, scalar)


def commitment_gadget(composer: Composer, value: int, blinder: int) -> PointVar:
    """In-circuit Pedersen commitment: value*G + blinder*G_NUMS
    (gadgets.rs:28-41)."""
    p1 = composer.fixed_base_scalar_mul(value, jubjub.GENERATOR)
    p2 = composer.fixed_base_scalar_mul(blinder, jubjub.GENERATOR_NUMS)
    return composer.point_addition_gate(p1, p2)


def maybe_equal(composer: Composer, a: AllocatedScalar,
                b: AllocatedScalar) -> int:
    """1 if a == b else 0, non-constraining (gadgets.rs:49-84)."""
    # u = a - b
    u = composer.add((1, a.var), (R_MOD - 1, b.var), 0)
    # z = u^{-1} or 0, prover-supplied free witness
    u_scalar = (a.scalar - b.scalar) % R_MOD
    z = composer.add_input(fr.inv_or_zero(u_scalar))
    # y = 1 - u z
    y = composer.mul(R_MOD - 1, z, u, 1)
    # y u = 0
    composer.mul_gate(y, u, u, 1, 0, 0)
    return y


def range_proof(composer: Composer, value: AllocatedScalar,
                num_bits: int) -> int:
    """Indicator that value fits in num_bits bits (gadgets.rs:88-91)."""
    is_equal, _bits = scalar_decomposition_gadget(composer, num_bits, value)
    return is_equal


def range_check(composer: Composer, min_range: int, max_range: int,
                witness: AllocatedScalar) -> int:
    """1 iff min_range <= witness < max_range (gadgets.rs:94-110)."""
    y1, num_bits_pow_2 = max_bound(composer, max_range, witness)
    y2 = min_bound(composer, min_range, witness, num_bits_pow_2)
    return composer.mul(1, y1, y2, 0)


def min_bound(composer: Composer, min_range: int,
              witness: AllocatedScalar, num_bits: int) -> int:
    """Indicator witness >= min_range via range_proof(x - min)
    (gadgets.rs:120-143)."""
    x_min_a_var = composer.add((1, witness.var), (0, witness.var),
                               (-min_range) % R_MOD)
    x_min_a = AllocatedScalar(x_min_a_var,
                              (witness.scalar - min_range) % R_MOD)
    return range_proof(composer, x_min_a, num_bits)


def max_bound(composer: Composer, max_range: int,
              witness: AllocatedScalar):
    """Indicator witness < max_range via range_proof(max-1-x); returns
    (indicator, num_bits used) (gadgets.rs:149-180)."""
    max_range = (max_range - 1) % R_MOD
    num_bits_pow_2 = fr.num_bits_closest_power_of_two(max_range)
    b_minus_x_var = composer.add((R_MOD - 1, witness.var),
                                 (0, witness.var), max_range)
    b_minus_x = AllocatedScalar(b_minus_x_var,
                                (max_range - witness.scalar) % R_MOD)
    return (range_proof(composer, b_minus_x, num_bits_pow_2),
            num_bits_pow_2)


def scalar_decomposition_gadget(composer: Composer, num_bits: int,
                                witness: AllocatedScalar):
    """Bit-decompose and accumulate; returns (is_equal indicator,
    bit variables) (gadgets.rs:186-225)."""
    scalar_bits = fr.scalar_to_bits(witness.scalar)
    # allocate all 256 bits (reference quirk), keep first num_bits
    all_bit_vars = [composer.add_input(bit) for bit in scalar_bits]
    bit_vars = all_bit_vars[:num_bits]

    accumulator = AllocatedScalar(
        composer.add_witness_to_circuit_description(0), 0)
    for power, bit_var in enumerate(bit_vars):
        composer.boolean_gate(bit_var)
        two_pow = pow(2, power, R_MOD)
        acc_var = composer.add((two_pow, bit_var), (1, accumulator.var), 0)
        accumulator = AllocatedScalar(
            acc_var,
            (accumulator.scalar + two_pow * scalar_bits[power]) % R_MOD)
    is_equal = maybe_equal(composer, accumulator, witness)
    return is_equal, bit_vars
