"""The gate-constraint algebra — single source of truth shared by the
quotient round (pointwise over the 4n coset), the linearization
polynomial, the verifier's reconstruction, and the composer's debug
checker.  Formulas are specified in docs/PROTOCOL.md.

Every function here operates on plain ints mod r so it can be used both
host-side and as the reference for the vectorized device versions.

Notation: w = (a, b, c, d) wire values at the row / at zeta;
wn = same at the next row / at zeta*omega.
"""

from ..params import R_MOD, JUBJUB_D

M = R_MOD


def delta(x: int) -> int:
    """x(x-1)(x-2)(x-3): vanishes iff x is a 2-bit quad."""
    return x * (x - 1) % M * ((x - 2) * (x - 3) % M) % M


def arith_coeffs(w):
    """Scalar coefficients of the committed arithmetic selectors:
    A = q_m*ab + q_l*a + q_r*b + q_4*d + q_o*c + q_c."""
    a, b, c, d = w
    return {
        "q_m": a * b % M, "q_l": a, "q_r": b, "q_4": d, "q_o": c, "q_c": 1,
    }


def arith_value(w, q):
    co = arith_coeffs(w)
    return sum(co[k] * q[k] for k in co) % M


def range_scalar(w, wn, kappa: int) -> int:
    """R = D(c-4d) + k*D(b-4c) + k^2*D(a-4b) + k^3*D(d'-4a)."""
    a, b, c, d = w
    dn = wn[3]
    k2 = kappa * kappa % M
    return (delta(c - 4 * d)
            + kappa * delta(b - 4 * c)
            + k2 * delta(a - 4 * b)
            + k2 * kappa % M * delta(dn - 4 * a)) % M


# 2-bit-quad logic interpolation constants: AND(qa, qb) restricted to
# {0..3}^2 equals the bivariate polynomial
#   A = (83/6) w - (27/2) w (qa+qb) + 3 w (qa^2+qb^2)
#     + (27/2) w^2 - 3 w^2 (qa+qb) + (2/3) w^3          with w = qa*qb,
# derived by exact interpolation over the 16 points and rewriting mixed
# monomials qa^i qb^j through w to cap the wire degree at 3 (quotient
# budget).  XOR follows from the bitwise identity XOR = qa + qb - 2*AND.
# Verified exhaustively in tests/test_composer.py.
_C83_6 = 83 * pow(6, -1, M) % M
_C27_2 = 27 * pow(2, -1, M) % M
_C2_3 = 2 * pow(3, -1, M) % M


def _and_poly(qa: int, qb: int, w: int) -> int:
    """AND of two 2-bit quads given w = qa*qb (soundness of w is
    enforced separately by the l4 term)."""
    s = (qa + qb) % M
    sq = (qa * qa + qb * qb) % M
    w2 = w * w % M
    return (_C83_6 * w - _C27_2 * w % M * s + 3 * w * sq % M
            + _C27_2 * w2 - 3 * w2 * s % M + _C2_3 * w2 % M * w) % M


def logic_scalar(w, wn, q_c: int, kappa: int) -> int:
    """L over 2-bit quads (the dusk-shaped logic widget; VERDICT r1
    task 5): qa = a'-4a, qb = b'-4b, qd = d'-4d are the operand/result
    quads, wire c (CURRENT row) holds the quad product w = qa*qb.
    q_c=1 selects XOR, q_c=0 AND:
      l1..l3: delta(quads);  l4: product wire consistency;
      l5: qd = q_c (qa+qb) + (1-3 q_c) AND(qa,qb,w)
          [since q_c XOR + (1-q_c) AND = q_c (qa+qb) + (1-3 q_c) AND].
    Keeping the product on the current row (not c') is what lets the
    prover drop the c@zeta*omega opening (dusk opens only a,b,d there).
    """
    a, b, c, d = w
    an, bn, _cn, dn = wn
    qa, qb, qd, wprod = an - 4 * a, bn - 4 * b, dn - 4 * d, c
    l1 = delta(qa)
    l2 = delta(qb)
    l3 = delta(qd)
    l4 = (wprod - qa * qb) % M
    andv = _and_poly(qa % M, qb % M, wprod % M)
    l5 = (qd - q_c * (qa + qb) - (1 - 3 * q_c) * andv) % M
    k = kappa
    out = l1
    for term in (l2, l3, l4, l5):
        out = (out + k * term) % M
        k = k * kappa % M
    return out


def fixed_scalar(w, wn, q_l: int, q_r: int, q_c: int, kappa: int) -> int:
    """Fixed-base ECC ladder row: digit k = d'-2d in {-1,0,1}; window
    base (x_B, y_B) = (q_l, q_r), xy_B = q_c; wire c holds
    xy_alpha = k*x_B*y_B (= x_t*y_t given k^3=k), which keeps the
    Edwards term at wire-degree 4 with a single selector (quotient
    degree budget 4n); Edwards conditional add acc' = acc + k*B."""
    a, b, c, d = w
    an, bn, _cn, dn = wn
    k = (dn - 2 * d) % M
    x_t = k * q_l % M
    y_t = (k * k % M * ((q_r - 1) % M) + 1) % M
    f1 = k * ((k - 1) % M) % M * ((k + 1) % M) % M
    f2 = (c - k * q_c) % M                      # xy_alpha consistency
    dabc = JUBJUB_D * a % M * b % M * c % M
    f3 = (an + an * dabc - a * y_t - b * x_t) % M
    f4 = (bn - bn * dabc - b * y_t - a * x_t) % M
    k2 = kappa * kappa % M
    return (f1 + kappa * f2 + k2 * f3 + k2 * kappa % M * f4) % M


def vgadd_scalar(w, wn, kappa: int) -> int:
    """Variable-base Edwards addition: inputs (x1,y1,x2,y2) = (a,b,c,d),
    outputs (x3,y3) = (a',b'), aux d' = x1*y1."""
    x1, y1, x2, y2 = w
    x3, y3, _cn, aux = wn
    v1 = (aux - x1 * y1) % M
    dp = JUBJUB_D * aux % M * x2 % M * y2 % M
    v2 = (x3 + x3 * dp - x1 * y2 - y1 * x2) % M
    v3 = (y3 - y3 * dp - y1 * y2 - x1 * x2) % M
    return (v1 + kappa * v2 + kappa * kappa % M * v3) % M


def gate_value(w, wn, q, pi: int, ch) -> int:
    """Full gate constraint at one row/point.  `q` maps selector name ->
    value at this row/point; `ch` holds the widget separation challenges
    (ch['range'], ch['logic'], ch['fixed'], ch['vgadd'])."""
    g = q["q_arith"] * arith_value(w, q) + pi
    g += ch["range"] * q["q_range"] % M * range_scalar(w, wn, ch["range"])
    g += ch["logic"] * q["q_logic"] % M * \
        logic_scalar(w, wn, q["q_c"], ch["logic"])
    g += ch["fixed"] * q["q_fixed"] % M * \
        fixed_scalar(w, wn, q["q_l"], q["q_r"], q["q_c"], ch["fixed"])
    g += ch["vgadd"] * q["q_vgadd"] % M * vgadd_scalar(w, wn, ch["vgadd"])
    return g % M


def check_gates_host(composer) -> bool:
    """Debug: evaluate every gate constraint on the raw (unpadded+1)
    table with unit separation challenges; returns True iff all zero.
    Uses challenges=1 which cannot mask nonzero terms for honest
    widget-local debugging (terms are checked individually too)."""
    n = composer.n_gates
    wit = composer.witness

    def wires_at(i):
        if i >= n:
            return (0, 0, 0, 0)
        return tuple(wit[composer.wires[col][i]] for col in "abcd")

    for i in range(n):
        w = wires_at(i)
        wn = wires_at(i + 1)
        q = {name: composer.q[name][i] for name in composer.q}
        pi = composer.pi.get(i, 0)
        # check each enabled widget separately so one widget cannot
        # cancel another
        if q["q_arith"] and (q["q_arith"] * arith_value(w, q) + pi) % M:
            return False
        if not q["q_arith"] and pi % M:
            return False
        if q["q_range"] and range_scalar(w, wn, 1) != 0:
            return False
        if q["q_logic"] and logic_scalar(w, wn, q["q_c"], 1) != 0:
            return False
        if q["q_fixed"] and \
                fixed_scalar(w, wn, q["q_l"], q["q_r"], q["q_c"], 1) != 0:
            return False
        if q["q_vgadd"] and vgadd_scalar(w, wn, 1) != 0:
            return False
    return True
