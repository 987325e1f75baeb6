"""KZG10 commit / open / batch-verify (host path; the TPU MSM drops in
behind `commit` — SURVEY.md §2.6).

Aggregate openings follow the dusk-plonk 0.8 shape (SURVEY.md §2.8):
one witness polynomial per opening point, polynomials folded with
powers of a transcript challenge; the verifier folds commitments the
same way and batch-checks the two openings with a final challenge `u`
and 2 pairings.
"""

from ..params import R_MOD
from ..fields import fr
from ..curves import g1, g2, pairing
from ..poly import poly
from . import msm as hostmsm


def commit(coeffs, srs):
    """KZG commitment: MSM of coefficients against SRS G1 powers."""
    coeffs = poly.trim(coeffs)
    if not coeffs:
        return None  # zero polynomial -> identity
    assert len(coeffs) <= len(srs.powers_g1), "polynomial exceeds SRS degree"
    return hostmsm.msm(srs.powers_g1[: len(coeffs)], coeffs)


def open_single(coeffs, point: int, srs):
    """Witness for p(point): commit((p(X) - p(point)) / (X - point))."""
    value = poly.evaluate(coeffs, point)
    quotient = poly.ruffini(poly.sub(coeffs, [value]), point)
    return commit(quotient, srs), value


def aggregate_polys(polys, challenge: int):
    """Fold polynomials with powers of the aggregation challenge."""
    acc = []
    ch = 1
    for p in polys:
        acc = poly.add(acc, poly.scale(p, ch))
        ch = ch * challenge % R_MOD
    return acc


def aggregate_commitments(commitments, challenge: int):
    pairs = []
    ch = 1
    for c in commitments:
        pairs.append((c, ch))
        ch = ch * challenge % R_MOD
    return hostmsm.msm_small(pairs)


def aggregate_values(values, challenge: int) -> int:
    acc, ch = 0, 1
    for v in values:
        acc = (acc + v * ch) % R_MOD
        ch = ch * challenge % R_MOD
    return acc


def open_aggregate(polys, point: int, challenge: int, srs):
    """Single witness commitment proving all polys at `point`, folded by
    powers of `challenge`."""
    agg = aggregate_polys(polys, challenge)
    w, _ = open_single(agg, point, srs)
    return w


def batch_check(points, witnesses, agg_commitments, agg_values, u: int,
                srs, defer=False):
    """Verify k aggregated openings (point_i, W_i, C_i, v_i) with one
    2-pairing check, folding the openings by powers of u:

      e(sum u^i W_i, [tau]G2) == e(sum u^i (C_i - v_i G1 + point_i W_i), G2)

    With defer=True, returns the two folded G1 points (lhs, rhs)
    instead of running the pairings — the cross-proof batch verifier
    (proof_system/verifier.verify_batch) random-linear-combines many
    such pairs into ONE 2-pairing check (legal because both G2 sides,
    [tau]G2 and G2, are fixed across proofs)."""
    # One flat Straus MSM each side:
    #   lhs = sum u^i W_i
    #   rhs = sum u^i C_i + (-sum u^i v_i) G + sum (u^i point_i) W_i
    lhs_pairs = []
    rhs_pairs = []
    g_scalar = 0
    upow = 1
    for pt, w, c, v in zip(points, witnesses, agg_commitments, agg_values):
        lhs_pairs.append((w, upow))
        rhs_pairs.append((c, upow))
        rhs_pairs.append((w, upow * pt % R_MOD))
        g_scalar = (g_scalar - upow * v) % R_MOD
        upow = upow * u % R_MOD
    rhs_pairs.append((g1.GEN, g_scalar))
    lhs_aff = hostmsm.msm_small(lhs_pairs)
    rhs_aff = hostmsm.msm_small(rhs_pairs)
    if defer:
        return lhs_aff, rhs_aff
    return final_pairing_check(lhs_aff, rhs_aff, srs)


def final_pairing_check(lhs_aff, rhs_aff, srs) -> bool:
    """The shared KZG tail: e(lhs, [tau]G2) * e(-rhs, G2) == 1 — the
    single place that knows the 2-pairing layout and the identity
    conventions (used by batch_check and the cross-proof batch
    verifier)."""
    return pairing.pairing_check([
        (lhs_aff, srs.g2_tau),
        (g1.neg(rhs_aff) if rhs_aff else None, srs.g2_gen),
    ])
