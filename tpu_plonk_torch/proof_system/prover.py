"""The prover helpers that the verifier shares (copied from the
reference host prover): linearization coefficients, L1 and PI
evaluation, t(zeta), and the evaluation append order."""

from ..params import R_MOD, K1, K2, K3
from ..fields import fr
from ..transcript import Transcript
from ..transcript import labels as L
from . import constraints as C

KS = (1, K1, K2, K3)


# ---------------------------------------------------------------------------
# shared helpers (verifier uses the same code paths)
# ---------------------------------------------------------------------------


def perm_products(ev, zeta, beta, gamma):
    """(prod_id over 4 cols, prod_sigma over first 3 cols)."""
    w = (ev["a"], ev["b"], ev["c"], ev["d"])
    prod_id = 1
    for j in range(4):
        prod_id = prod_id * ((w[j] + beta * KS[j] * zeta + gamma) % R_MOD) \
            % R_MOD
    prod_sig3 = 1
    for j, nm in enumerate(("sigma1", "sigma2", "sigma3")):
        prod_sig3 = prod_sig3 * ((w[j] + beta * ev[nm] + gamma) % R_MOD) \
            % R_MOD
    return prod_id, prod_sig3


def linearization_coefficients(ev, zeta, beta, gamma, alpha, ch, dom):
    """Scalar coefficient per committed polynomial in r(X); shared by
    the prover (applied to coeff vectors) and the verifier (applied to
    commitments)."""
    w = (ev["a"], ev["b"], ev["c"], ev["d"])
    # no widget reads c at the next row (the logic product wire moved to
    # the current row), so c' is neither opened nor needed here
    wn = (ev["a_next"], ev["b_next"], 0, ev["d_next"])
    qa = ev["q_arith"]
    co = {}
    for name, scalar in C.arith_coeffs(w).items():
        co[name] = qa * scalar % R_MOD
    co["q_range"] = ch["range"] * C.range_scalar(w, wn, ch["range"]) % R_MOD
    co["q_logic"] = ch["logic"] * \
        C.logic_scalar(w, wn, ev["q_c"], ch["logic"]) % R_MOD
    co["q_fixed"] = ch["fixed"] * C.fixed_scalar(
        w, wn, ev["q_l"], ev["q_r"], ev["q_c"], ch["fixed"]) % R_MOD
    co["q_vgadd"] = ch["vgadd"] * C.vgadd_scalar(w, wn, ch["vgadd"]) % R_MOD

    prod_id, prod_sig3 = perm_products(ev, zeta, beta, gamma)
    l1_zeta = l1_eval(dom, zeta)
    co["z"] = (alpha * prod_id + alpha * alpha % R_MOD * l1_zeta) % R_MOD
    co["sigma4"] = (- alpha * prod_sig3 % R_MOD * beta % R_MOD
                    * ev["z_shifted"]) % R_MOD
    return co


def l1_eval(dom, x: int) -> int:
    """L1(x) = (x^n - 1) / (n (x - 1))."""
    zh = dom.vanishing_eval(x)
    if zh == 0:
        return 1 if x == 1 else 0
    return zh * dom.n_inv % R_MOD * pow((x - 1) % R_MOD, -1, R_MOD) % R_MOD


def eval_pi(pi_map: dict, dom, zeta: int) -> int:
    """PI(zeta) = sum pi_i L_i(zeta) (sparse)."""
    if not pi_map:
        return 0
    zh = dom.vanishing_eval(zeta)
    omegas = dom.elements()
    idxs = sorted(pi_map)
    denoms = fr.batch_inv([(zeta - omegas[i]) % R_MOD for i in idxs])
    acc = 0
    for k, i in enumerate(idxs):
        li = zh * dom.n_inv % R_MOD * omegas[i] % R_MOD * denoms[k] % R_MOD
        acc = (acc + pi_map[i] * li) % R_MOD
    return acc


def compute_t_eval(ev, pi_at_zeta, zeta, beta, gamma, alpha, dom) -> int:
    """t(zeta) from the opened evaluations (verifier-recomputable):
    t = (r + PI - alpha*prod_sig3*(d+gamma)*z_w - alpha^2 L1(zeta)) / Z_H."""
    _, prod_sig3 = perm_products(ev, zeta, beta, gamma)
    num = (ev["r"] + pi_at_zeta
           - alpha * prod_sig3 % R_MOD * ((ev["d"] + gamma) % R_MOD)
           % R_MOD * ev["z_shifted"]
           - alpha * alpha % R_MOD * l1_eval(dom, zeta)) % R_MOD
    return num * pow(dom.vanishing_eval(zeta), -1, R_MOD) % R_MOD


def append_evals(t: Transcript, ev: dict, t_eval: int) -> None:
    """Fixed evaluation append order (mirrored by the verifier)."""
    t.append_scalar(L.A_EVAL, ev["a"])
    t.append_scalar(L.B_EVAL, ev["b"])
    t.append_scalar(L.C_EVAL, ev["c"])
    t.append_scalar(L.D_EVAL, ev["d"])
    t.append_scalar(L.A_NEXT_EVAL, ev["a_next"])
    t.append_scalar(L.B_NEXT_EVAL, ev["b_next"])
    t.append_scalar(L.D_NEXT_EVAL, ev["d_next"])
    t.append_scalar(L.LEFT_SIG_EVAL, ev["sigma1"])
    t.append_scalar(L.RIGHT_SIG_EVAL, ev["sigma2"])
    t.append_scalar(L.OUT_SIG_EVAL, ev["sigma3"])
    t.append_scalar(L.Q_ARITH_EVAL, ev["q_arith"])
    t.append_scalar(L.Q_C_EVAL, ev["q_c"])
    t.append_scalar(L.Q_L_EVAL, ev["q_l"])
    t.append_scalar(L.Q_R_EVAL, ev["q_r"])
    t.append_scalar(L.PERM_EVAL, ev["z_shifted"])
    t.append_scalar(L.T_EVAL, t_eval)
    t.append_scalar(L.R_EVAL, ev["r"])
