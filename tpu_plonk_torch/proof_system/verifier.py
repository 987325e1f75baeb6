"""PLONK verifier (host CPU, O(1) in circuit size; SURVEY.md §3.3):
transcript replay -> challenges; linearization commitment
reconstruction (~20-point MSM); batched KZG check with 2 pairings.
"""

from ..params import R_MOD
from ..poly.domain import Domain
from ..transcript import Transcript
from ..transcript import labels as L
from ..pcs import kzg, msm as hostmsm
from .proof import Proof
from .prover import (
    linearization_coefficients, eval_pi, compute_t_eval, append_evals,
)


def verify(proof: Proof, vk, public_inputs: dict, srs,
           label: bytes = L.PROTOCOL, defer_pairing: bool = False):
    n = vk.n
    dom = Domain(n)
    comm = proof.commitments
    ev = proof.evals

    # --- transcript replay ---
    t = Transcript(label)
    t.circuit_domain_sep(n)
    for lbl, name in ((L.W_L, "w_l"), (L.W_R, "w_r"),
                      (L.W_O, "w_o"), (L.W_4, "w_4")):
        t.append_commitment(lbl, comm[name])
    beta = t.challenge_scalar(L.BETA)
    t.append_scalar(L.BETA, beta)
    gamma = t.challenge_scalar(L.GAMMA)
    t.append_commitment(L.Z, comm["z"])
    alpha = t.challenge_scalar(L.ALPHA)
    ch = {
        "range": t.challenge_scalar(L.RANGE_SEP),
        "logic": t.challenge_scalar(L.LOGIC_SEP),
        "fixed": t.challenge_scalar(L.FIXED_SEP),
        "vgadd": t.challenge_scalar(L.VGADD_SEP),
    }
    t_labels = (L.T_1, L.T_2, L.T_3, L.T_4, L.T_5) if proof.blinded \
        else (L.T_1, L.T_2, L.T_3, L.T_4)
    for k, lbl in enumerate(t_labels):
        t.append_commitment(lbl, comm[f"t_{k + 1}"])
    zeta = t.challenge_scalar(L.ZETA)

    pi_at_zeta = eval_pi(dict(public_inputs), dom, zeta)
    t_eval = compute_t_eval(ev, pi_at_zeta, zeta, beta, gamma, alpha, dom)
    append_evals(t, ev, t_eval)
    v = t.challenge_scalar(L.AGGREGATE_WITNESS)
    t.append_commitment(L.W_Z, comm["w_z"])
    t.append_commitment(L.W_Z_W, comm["w_zw"])
    u = t.challenge_scalar(L.BATCH)

    # --- reconstruct the linearization commitment ---
    co = linearization_coefficients(ev, zeta, beta, gamma, alpha, ch, dom)
    parts = []
    for name in ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c",
                 "q_range", "q_logic", "q_fixed", "q_vgadd"):
        parts.append((vk.selector_commits[name], co[name]))
    parts.append((comm["z"], co["z"]))
    parts.append((vk.sigma_commits[3], co["sigma4"]))
    r_comm = _msm_pairs(parts)

    # flattened quotient commitment (5 chunks for the blinded variant)
    zn = pow(zeta, n, R_MOD)
    t_comm = _msm_pairs([
        (comm[f"t_{k + 1}"], pow(zn, k, R_MOD))
        for k in range(len(t_labels))])

    # --- fold the two aggregate openings ---
    zeta_comms = [t_comm, r_comm, comm["w_l"], comm["w_r"], comm["w_o"],
                  comm["w_4"], vk.sigma_commits[0], vk.sigma_commits[1],
                  vk.sigma_commits[2], vk.selector_commits["q_arith"],
                  vk.selector_commits["q_c"], vk.selector_commits["q_l"],
                  vk.selector_commits["q_r"]]
    zeta_vals = [t_eval, ev["r"], ev["a"], ev["b"], ev["c"], ev["d"],
                 ev["sigma1"], ev["sigma2"], ev["sigma3"],
                 ev["q_arith"], ev["q_c"], ev["q_l"], ev["q_r"]]
    zw_comms = [comm["z"], comm["w_l"], comm["w_r"], comm["w_4"]]
    zw_vals = [ev["z_shifted"], ev["a_next"], ev["b_next"],
               ev["d_next"]]

    agg_c1 = kzg.aggregate_commitments(zeta_comms, v)
    agg_v1 = kzg.aggregate_values(zeta_vals, v)
    agg_c2 = kzg.aggregate_commitments(zw_comms, v)
    agg_v2 = kzg.aggregate_values(zw_vals, v)

    zw = zeta * dom.omega % R_MOD
    return kzg.batch_check(
        [zeta, zw], [comm["w_z"], comm["w_zw"]],
        [agg_c1, agg_c2], [agg_v1, agg_v2], u, srs,
        defer=defer_pairing)


def verify_batch(items, srs, label: bytes = L.PROTOCOL,
                 salt: bytes = None) -> bool:
    """Verify many proofs with ONE 2-pairing check (serving-path
    throughput: the per-proof Miller loop + final exponentiation — the
    dominant verify cost — is amortized across the batch).

    Each proof reduces (via verify(defer_pairing=True): full transcript
    replay, linearization MSM, opening fold) to a pair of G1 points
    (L_p, R_p) whose check is e(L_p, [tau]G2) == e(R_p, G2).  Both G2
    sides are proof-independent, so a random linear combination
      e(sum r_p L_p, [tau]G2) * e(-sum r_p R_p, G2) == 1
    verifies all proofs at once; by Schwartz-Zippel an invalid proof
    survives with probability ~1/r over the verifier-chosen weights.
    Weights are derived by hashing a fresh session salt with every
    proof's bytes, so no prover can anticipate them.

    items: iterable of (proof, vk, public_inputs).  Returns True iff
    every proof verifies.  NOT a replacement for identifying WHICH
    proof failed — rerun verify() per proof for that."""
    import hashlib
    import secrets

    items = list(items)
    if not items:
        return True
    if salt is None:
        salt = secrets.token_bytes(32)
    deferred = []
    h = hashlib.sha3_256(salt)
    for proof, vk, pi in items:
        deferred.append(verify(proof, vk, pi, srs, label,
                               defer_pairing=True))
        h.update(proof.to_bytes())
        for k in sorted(pi):
            h.update(int(k).to_bytes(8, "little"))
            h.update((int(pi[k]) % R_MOD).to_bytes(32, "little"))
    seed = h.digest()
    lhs_pairs, rhs_pairs = [], []
    for i, (lhs, rhs) in enumerate(deferred):
        r_i = 1 if i == 0 else int.from_bytes(
            hashlib.sha3_256(seed + i.to_bytes(8, "little")).digest(),
            "little") % R_MOD
        if lhs is not None:
            lhs_pairs.append((lhs, r_i))
        if rhs is not None:
            rhs_pairs.append((rhs, r_i))
    lhs_aff = hostmsm.msm_small(lhs_pairs) if lhs_pairs else None
    rhs_aff = hostmsm.msm_small(rhs_pairs) if rhs_pairs else None
    return kzg.final_pairing_check(lhs_aff, rhs_aff, srs)


def _msm_pairs(pairs):
    return hostmsm.msm_small(pairs)
