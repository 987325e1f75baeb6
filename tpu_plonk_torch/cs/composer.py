"""StandardComposer: the 4-wire / 11-selector TurboPlonk constraint
system (the in-memory gate-table builder every gadget drives).

Capability parity with dusk-plonk 0.8's `StandardComposer` as exercised
and inventoried by the reference (SURVEY.md §2.7): witness allocation,
arithmetic gate builders, boolean/range/logic widgets, and the JubJub
ECC widgets (fixed-base scalar-mul ladder, variable-base point
addition).  The composer is deliberately host-side Python building flat
tables (SURVEY.md §2.7 "TPU plan") — device work starts at
preprocessing.

Wire columns: a (left), b (right), c (output), d (fourth).
Selectors:   q_m q_l q_r q_o q_4 q_c  q_arith q_range q_logic
             q_fixed q_vgadd
Gate equation and widget constraints are specified in
docs/PROTOCOL.md; prover and verifier both evaluate them through
proof_system/constraints.py so they cannot drift apart.
"""

from ..params import R_MOD, JUBJUB_D
from ..fields import fr
from ..curves import jubjub

SELECTOR_NAMES = (
    "q_m", "q_l", "q_r", "q_o", "q_4", "q_c",
    "q_arith", "q_range", "q_logic", "q_fixed", "q_vgadd",
)

WIRE_NAMES = ("a", "b", "c", "d")


class PointVar:
    """An in-circuit JubJub point: a pair of witness variables plus the
    concrete witness coordinates (the `Point` of dusk's ecc module)."""

    __slots__ = ("x", "y", "point")

    def __init__(self, x_var: int, y_var: int, point):
        self.x = x_var
        self.y = y_var
        self.point = point


class Composer:
    def __init__(self):
        self.witness = []                      # var index -> int value
        self.q = {name: [] for name in SELECTOR_NAMES}
        self.wires = {w: [] for w in WIRE_NAMES}
        self.pi = {}                           # gate index -> int
        # variable -> constant value for circuit-description constants
        self.constants = {}

        # Pinned constants every widget relies on (reference
        # allocated_scalar.rs / gadgets.rs "XXX: Expose composer.zero()").
        # zero_var is bootstrapped by hand because poly_gate itself
        # defaults the 4th wire to it.
        self.zero_var = self.add_input(0)
        self.constants[self.zero_var] = 0
        self.constrain_to_constant(self.zero_var, 0)
        self.one_var = self.add_witness_to_circuit_description(1)
        # Dummy constraint so no selector polynomial is identically zero
        # (mirrors dusk's add_dummy_constraints role).
        a = self.add_input(6)
        b = self.add_input(7)
        c = self.add_input((-80 * pow(4, -1, R_MOD)) % R_MOD)
        d = self.one_var
        self._gate({"q_m": 1, "q_l": 2, "q_r": 3, "q_o": 4, "q_4": 1,
                    "q_c": 4, "q_arith": 1}, a, b, c, d)

    # ------------------------------------------------------------------
    # core
    # ------------------------------------------------------------------

    @property
    def n_gates(self) -> int:
        return len(self.wires["a"])

    def value(self, var: int) -> int:
        return self.witness[var]

    def add_input(self, value: int) -> int:
        """Allocate a witness variable (dusk `add_input`,
        reference allocated_scalar.rs:36)."""
        self.witness.append(value % R_MOD)
        return len(self.witness) - 1

    def _gate(self, selectors: dict, a: int, b: int, c: int, d: int,
              pi: int = None) -> int:
        """Append one gate row; returns its index."""
        idx = self.n_gates
        for name in SELECTOR_NAMES:
            self.q[name].append(selectors.get(name, 0) % R_MOD)
        self.wires["a"].append(a)
        self.wires["b"].append(b)
        self.wires["c"].append(c)
        self.wires["d"].append(d)
        if pi is not None and pi % R_MOD != 0:
            self.pi[idx] = pi % R_MOD
        return idx

    # ------------------------------------------------------------------
    # arithmetic gates (dusk builder surface, SURVEY.md §2.7)
    # ------------------------------------------------------------------

    def poly_gate(self, a, b, c, q_m, q_l, q_r, q_o, q_c, pi=None,
                  d=None, q_4=0):
        """Raw arithmetic gate:
        q_m*a*b + q_l*a + q_r*b + q_o*c + q_4*d + q_c + pi = 0."""
        self._gate({"q_m": q_m, "q_l": q_l, "q_r": q_r, "q_o": q_o,
                    "q_4": q_4, "q_c": q_c, "q_arith": 1},
                   a, b, c, self.zero_var if d is None else d, pi)

    def add(self, q_l_a, q_r_b, q_c, pi=None) -> int:
        """c = q_l*a + q_r*b + q_c + pi  (dusk `add`, gadgets.rs:60)."""
        (q_l, a) = q_l_a
        (q_r, b) = q_r_b
        p = 0 if pi is None else pi
        c_val = (q_l * self.witness[a] + q_r * self.witness[b] + q_c + p) % R_MOD
        c = self.add_input(c_val)
        self.poly_gate(a, b, c, 0, q_l, q_r, R_MOD - 1, q_c, pi)
        return c

    def big_add(self, q_l_a, q_r_b, q_4_d, q_c, pi=None) -> int:
        (q_l, a) = q_l_a
        (q_r, b) = q_r_b
        (q_4, d) = q_4_d
        p = 0 if pi is None else pi
        c_val = (q_l * self.witness[a] + q_r * self.witness[b]
                 + q_4 * self.witness[d] + q_c + p) % R_MOD
        c = self.add_input(c_val)
        self.poly_gate(a, b, c, 0, q_l, q_r, R_MOD - 1, q_c, pi,
                       d=d, q_4=q_4)
        return c

    def mul(self, q_m, a, b, q_c, pi=None) -> int:
        """c = q_m*a*b + q_c + pi  (dusk `mul`, gadgets.rs:70)."""
        p = 0 if pi is None else pi
        c_val = (q_m * self.witness[a] * self.witness[b] + q_c + p) % R_MOD
        c = self.add_input(c_val)
        self.poly_gate(a, b, c, q_m, 0, 0, R_MOD - 1, q_c, pi)
        return c

    def big_mul(self, q_m, a, b, q_4_d, q_c, pi=None) -> int:
        (q_4, d) = q_4_d
        p = 0 if pi is None else pi
        c_val = (q_m * self.witness[a] * self.witness[b]
                 + q_4 * self.witness[d] + q_c + p) % R_MOD
        c = self.add_input(c_val)
        self.poly_gate(a, b, c, q_m, 0, 0, R_MOD - 1, q_c, pi, d=d, q_4=q_4)
        return c

    def mul_gate(self, a, b, c, q_m, q_o, q_c, pi=None):
        """Enforce q_m*a*b + q_o*c + q_c + pi = 0 (dusk `mul_gate`,
        reference gadgets.rs:81)."""
        self.poly_gate(a, b, c, q_m, 0, 0, q_o, q_c, pi)

    def add_gate(self, a, b, c, q_l, q_r, q_o, q_c, pi=None):
        self.poly_gate(a, b, c, 0, q_l, q_r, q_o, q_c, pi)

    def boolean_gate(self, a: int):
        """a*a - a = 0 (reference gadgets.rs:211)."""
        self.poly_gate(a, a, a, 1, 0, 0, R_MOD - 1, 0)

    def constrain_to_constant(self, a: int, constant: int, pi=None):
        """a - constant + pi = 0 (reference circuits.rs:71)."""
        self.poly_gate(a, a, a, 0, 1, 0, 0, (-constant) % R_MOD, pi)

    def assert_equal(self, a: int, b: int):
        self.poly_gate(a, b, a, 0, 1, R_MOD - 1, 0, 0)

    def add_witness_to_circuit_description(self, value: int) -> int:
        """Constant-valued variable pinned by a gate (reference
        gadgets.rs:206)."""
        var = self.add_input(value)
        self.constrain_to_constant(var, value)
        self.constants[var] = value % R_MOD
        return var

    # ------------------------------------------------------------------
    # range widget (q_range): base-4 accumulators across d,c,b,a,d_next
    # ------------------------------------------------------------------

    def range_gate(self, var: int, num_bits: int):
        """Constrain value(var) to [0, 2^num_bits) via 2-bit quads, 8
        bits (4 quads) per row.  docs/PROTOCOL.md §range."""
        assert num_bits > 0 and num_bits % 8 == 0, \
            "range_gate needs num_bits to be a positive multiple of 8"
        value = self.witness[var]
        assert value < (1 << num_bits), "range_gate witness out of range"
        n_quads = num_bits // 2
        # MSB-first quads
        quads = [(value >> (2 * (n_quads - 1 - i))) & 3 for i in range(n_quads)]
        # accumulators: acc_0 = 0; acc_{t+1} = 4*acc_t + quad_t
        accs = [0]
        for q4 in quads:
            accs.append(accs[-1] * 4 + q4)
        acc_vars = [self.zero_var] + [self.add_input(v) for v in accs[1:]]
        # rows: (d,c,b,a) = (acc_0,acc_1,acc_2,acc_3), next d = acc_4 ...
        n_rows = n_quads // 4
        for r in range(n_rows):
            self._gate({"q_range": 1},
                       a=acc_vars[4 * r + 3], b=acc_vars[4 * r + 2],
                       c=acc_vars[4 * r + 1], d=acc_vars[4 * r])
        # carrier row: d holds the final accumulator == var (via copy)
        self._gate({}, a=self.zero_var, b=self.zero_var,
                   c=self.zero_var, d=acc_vars[-1])
        self.assert_equal(acc_vars[-1], var)
        return var

    # ------------------------------------------------------------------
    # logic widget (q_logic): 2-bit quads, accumulators in a/b/d, quad
    # product in the CURRENT row's c; q_c selects XOR (1) vs AND (0).
    # num_bits/2 widget rows + 1 carrier (the dusk gate-count shape).
    # ------------------------------------------------------------------

    def _logic_gate(self, a_var: int, b_var: int, num_bits: int,
                    is_xor: bool) -> int:
        assert num_bits > 0 and num_bits % 2 == 0, \
            "logic gates work on 2-bit quads: num_bits must be even"
        n_quads = num_bits // 2
        av, bv = self.witness[a_var], self.witness[b_var]
        assert av < (1 << num_bits) and bv < (1 << num_bits), \
            "logic gate inputs out of range"
        op = (lambda x, y: x ^ y) if is_xor else (lambda x, y: x & y)
        a_accs, b_accs, d_accs, prods = [0], [0], [0], []
        for i in range(n_quads):
            sh = 2 * (n_quads - 1 - i)
            qa, qb = (av >> sh) & 3, (bv >> sh) & 3
            a_accs.append(a_accs[-1] * 4 + qa)
            b_accs.append(b_accs[-1] * 4 + qb)
            d_accs.append(d_accs[-1] * 4 + op(qa, qb))
            prods.append(qa * qb)
        a_vars = [self.zero_var] + [self.add_input(v) for v in a_accs[1:]]
        b_vars = [self.zero_var] + [self.add_input(v) for v in b_accs[1:]]
        d_vars = [self.zero_var] + [self.add_input(v) for v in d_accs[1:]]
        w_vars = [self.add_input(v) for v in prods]
        for i in range(n_quads):
            # row i: accumulators BEFORE quad i; c = quad product w_i
            self._gate({"q_logic": 1, "q_c": 1 if is_xor else 0},
                       a=a_vars[i], b=b_vars[i], c=w_vars[i], d=d_vars[i])
        # carrier row holding the final accumulators
        self._gate({}, a=a_vars[-1], b=b_vars[-1], c=self.zero_var,
                   d=d_vars[-1])
        self.assert_equal(a_vars[-1], a_var)
        self.assert_equal(b_vars[-1], b_var)
        return d_vars[-1]

    def xor_gate(self, a: int, b: int, num_bits: int) -> int:
        return self._logic_gate(a, b, num_bits, True)

    def and_gate(self, a: int, b: int, num_bits: int) -> int:
        return self._logic_gate(a, b, num_bits, False)

    # ------------------------------------------------------------------
    # ECC widgets over JubJub (q_fixed, q_vgadd) — docs/PROTOCOL.md §ecc
    # ------------------------------------------------------------------

    def fixed_base_scalar_mul(self, scalar_var: int, generator) -> PointVar:
        """In-circuit scalar * fixed generator via a 256-row signed-bit
        ladder (digits in {-1,0,1}; MSB-first acc' = 2*acc + k).
        Capability of dusk's `fixed_base_scalar_mul`
        (reference circuits.rs:64, gadgets.rs:34,37)."""
        scalar = self.witness[scalar_var]
        digits = _naf_digits(scalar, 256)  # MSB-first, len 256

        # Precomputed window bases B_r = 2^(255-r) * G
        bases = [None] * 256
        p = generator
        for r in range(255, -1, -1):
            bases[r] = p
            p = jubjub.double(p)

        acc = jubjub.IDENTITY
        sacc = 0
        acc_x_vars = [self.zero_var]
        acc_y_vars = [self.one_var]
        sacc_vars = [self.zero_var]
        points = [acc]
        for r in range(256):
            k = digits[r]
            t = (jubjub.IDENTITY if k == 0 else
                 bases[r] if k == 1 else jubjub.neg(bases[r]))
            acc = jubjub.add(acc, t)
            sacc = 2 * sacc + k
            points.append(acc)
            acc_x_vars.append(self.add_input(acc[0]))
            acc_y_vars.append(self.add_input(acc[1]))
            if r == 255:
                # final scalar accumulator IS the input variable (copy
                # constraint ties the ladder to the witness scalar)
                assert sacc % R_MOD == scalar % R_MOD
                sacc_vars.append(scalar_var)
            else:
                sacc_vars.append(self.add_input(sacc))
        for r in range(256):
            bx, by = bases[r]
            # xy_alpha wire: k * x_B * y_B (keeps the Edwards term at
            # wire-degree 4 with one selector — see constraints.fixed_scalar)
            xy_alpha = self.add_input(digits[r] * bx % R_MOD * by % R_MOD)
            self._gate({"q_fixed": 1, "q_l": bx, "q_r": by,
                        "q_c": bx * by % R_MOD},
                       a=acc_x_vars[r], b=acc_y_vars[r],
                       c=xy_alpha, d=sacc_vars[r])
        # carrier row with the final accumulator
        self._gate({}, a=acc_x_vars[256], b=acc_y_vars[256],
                   c=self.zero_var, d=sacc_vars[256])
        return PointVar(acc_x_vars[256], acc_y_vars[256], points[256])

    def point_addition_gate(self, p1: PointVar, p2: PointVar) -> PointVar:
        """Complete Edwards addition in one q_vgadd gate + carrier row
        (reference gadgets.rs:40)."""
        p3 = jubjub.add(p1.point, p2.point)
        x3 = self.add_input(p3[0])
        y3 = self.add_input(p3[1])
        aux = self.add_input(p1.point[0] * p1.point[1] % R_MOD)  # x1*y1
        self._gate({"q_vgadd": 1}, a=p1.x, b=p1.y, c=p2.x, d=p2.y)
        self._gate({}, a=x3, b=y3, c=self.zero_var, d=aux)
        return PointVar(x3, y3, p3)

    def variable_base_scalar_mul(self, scalar_var: int,
                                 point: PointVar) -> PointVar:
        """Double-and-add over 256 signed digits; each step is one
        doubling and one conditional addition built from mul/arith
        gates + q_vgadd point additions (dusk capability surface)."""
        scalar = self.witness[scalar_var]
        digits = _naf_digits(scalar, 256)
        acc = PointVar(self.zero_var, self.one_var, jubjub.IDENTITY)
        sacc_var = self.zero_var
        sacc = 0
        for r, k in enumerate(digits):
            acc = self.point_addition_gate(acc, acc)  # double
            # select t = k * P with k in {-1,0,1}: x_t = k*x_P,
            # y_t = k^2*(y_P - 1) + 1
            k_var = self.add_input(k)
            # enforce k in {-1,0,1}: k^3 - k = 0 -> (k*k)*k - k = 0
            k2 = self.mul(1, k_var, k_var, 0)
            self.poly_gate(k2, k_var, k_var, 1, 0, 0, R_MOD - 1, 0)
            x_t = self.mul(1, k_var, point.x, 0)
            y_t = self.big_mul(1, k2, point.y, (R_MOD - 1, k2), 1)
            tp = (jubjub.IDENTITY if k == 0 else
                  point.point if k == 1 else jubjub.neg(point.point))
            acc = self.point_addition_gate(
                acc, PointVar(x_t, y_t, tp))
            sacc = 2 * sacc + k
            sacc_var = self.add((2, sacc_var), (1, k_var), 0)
        assert sacc % R_MOD == scalar % R_MOD
        self.assert_equal(sacc_var, scalar_var)
        return acc

    def canonical_bit_decompose(self, var: int, num_bits: int = 255):
        """Decompose `var` into `num_bits` boolean witness bits whose
        integer value is PROVABLY the canonical representative (< r):
        bit accumulator ties the bits to `var` mod r, and an MSB-first
        equal-prefix comparison chain against the modulus bits enforces
        sum(b_i 2^i) < r as an integer, so the decomposition is unique.
        Returns bit variables LSB-first.  (The range/ladder widgets
        alone only fix the value mod r — two integer lifts of the same
        field element would otherwise both satisfy them; VERDICT
        round-1 task 9.)"""
        assert num_bits >= R_MOD.bit_length(), \
            "canonical decomposition needs the full modulus width"
        value = self.witness[var]
        bits = [(value >> i) & 1 for i in range(num_bits)]
        bit_vars = [self.add_input(b) for b in bits]
        for b in bit_vars:
            self.boolean_gate(b)
        acc_var = self.zero_var
        for i in range(num_bits - 1, -1, -1):
            acc_var = self.add((2, acc_var), (1, bit_vars[i]), 0)
        self.assert_equal(acc_var, var)
        # canonicity: while the bit prefix equals the modulus prefix,
        # a 1-bit where the modulus has 0 is forbidden; full equality
        # (value == r, impossible for a reduced witness) is forbidden
        # at the end.
        eq_var = self.one_var
        for i in range(num_bits - 1, -1, -1):
            r_bit = (R_MOD >> i) & 1
            if r_bit:
                eq_var = self.mul(1, eq_var, bit_vars[i], 0)
            else:
                self.mul_gate(eq_var, bit_vars[i], self.zero_var, 1, 0, 0)
        self.constrain_to_constant(eq_var, 0)
        return bit_vars

    def variable_base_scalar_mul_bits(self, bit_vars, point: PointVar
                                      ) -> PointVar:
        """[c] * point where c is given as boolean bit variables
        (LSB-first, already boolean-constrained — e.g. the output of
        canonical_bit_decompose).  MSB-first double-and-add; the
        conditional addend is (b*x_P, b*(y_P-1)+1), i.e. P or the
        Edwards identity."""
        acc = PointVar(self.zero_var, self.one_var, jubjub.IDENTITY)
        for i in range(len(bit_vars) - 1, -1, -1):
            b = bit_vars[i]
            acc = self.point_addition_gate(acc, acc)
            x_t = self.mul(1, b, point.x, 0)
            y_t = self.big_mul(1, b, point.y, (R_MOD - 1, b), 1)
            tp = point.point if self.witness[b] else jubjub.IDENTITY
            acc = self.point_addition_gate(acc, PointVar(x_t, y_t, tp))
        return acc

    def assert_equal_public_point(self, point: PointVar, affine):
        """Pin a circuit point to a public point via public inputs
        (reference circuits.rs:65)."""
        self.constrain_to_constant(point.x, 0, (-affine[0]) % R_MOD)
        self.constrain_to_constant(point.y, 0, (-affine[1]) % R_MOD)

    def assert_equal_point(self, p1: PointVar, p2: PointVar):
        self.assert_equal(p1.x, p2.x)
        self.assert_equal(p1.y, p2.y)

    # ------------------------------------------------------------------
    # finalization
    # ------------------------------------------------------------------

    def padded_size(self) -> int:
        n = max(self.n_gates + 1, 2)
        size = 1
        while size < n:
            size <<= 1
        return size

    def check_satisfied(self) -> bool:
        """Host-side debug check of every gate constraint (including
        widget semantics).  Used by tests; the prover does not need it."""
        from ..proof_system.constraints import check_gates_host
        return check_gates_host(self)


def _naf_digits(scalar: int, width: int):
    """Non-adjacent-form digits in {-1,0,1}, returned MSB-first with
    fixed length `width`, for scalar interpreted mod r (must fit
    width-1 signed bits — JubJub scalars (<2^252) always do)."""
    s = scalar % R_MOD
    assert s < (1 << (width - 2)), \
        "fixed/variable-base scalar must fit the ladder width"
    digits = []
    while s:
        if s & 1:
            d = 2 - (s & 3)  # 1 if s%4==1 else -1
            s -= d
        else:
            d = 0
        digits.append(d)
        s >>= 1
    digits += [0] * (width - len(digits))
    return digits[::-1]
