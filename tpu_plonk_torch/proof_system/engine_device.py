"""Device prover engine (mirrors tpu_plonk/proof_system/engine_device.py,
single device, unblinded): the polynomial rounds on torch tensors, the
transcript, proof assembly and the linearization scalars on the host.
Proofs are byte-identical to the reference's host prover.

Device values are (..., 8) int32 Montgomery words (fields/device.py).
Every `mm`/`ad`/`sb` is the Fr multiply / add-sub kernel on the card,
every transform the NTT kernel, every commit the MSM kernels; on CPU
tensors the same code runs the plain versions.

The quotient round is phased as in the reference: the 4n extended coset
splits into 4 interleaved size-n cosets s_i*H (s_i = g*w_4n^i), each
evaluated with size-n transforms, and the per-phase coefficients
recombine into t(X)'s four chunks by a 4x4 inverse Vandermonde in
u_i = s_i^n.  No 4n-sized array exists.
"""

import contextlib
import time

import torch

from ..params import R_MOD, K1, K2, K3, JUBJUB_D
from ..fields import device as dev
from ..kernels import resolve_device
from ..poly import ntt as nttmod
from ..poly.domain import Domain
from ..cs.composer import SELECTOR_NAMES
from ..transcript import Transcript
from ..transcript import labels as L
from . import prover as host
from .constraints import _C83_6, _C27_2, _C2_3
from .proof import Proof

FR = dev.FR
KS = (1, K1, K2, K3)


# ---------------------------------------------------------------------------
# host <-> device scalars
# ---------------------------------------------------------------------------

def to_dev(values, device):
    """Host ints -> (len, 8) Montgomery words on `device`; tensors pass
    through."""
    if isinstance(values, torch.Tensor):
        return values
    return dev.ints_to_words(values, FR, "cpu", mont=True).to(device)


def to_dev_scalar(v: int, device):
    return FR.const(v, device)


def from_dev(t) -> list:
    """(..., 8) Montgomery words -> list of host ints."""
    return dev.words_to_ints(t, mont=True, ctx=FR)


def mm(a, b):
    return dev.mont_mul(a, b, FR)


def ad(a, b):
    return dev.add_mod(a, b, FR)


def sb(a, b):
    return dev.sub_mod(a, b, FR)


def cst(v: int, like):
    """Montgomery constant (1, 8) on like's device."""
    return FR.const(v, like.device)


def cmul(v: int, x):
    return mm(cst(v, x), x)


def csub(x, v: int):
    return sb(x, cst(v, x))


# ---------------------------------------------------------------------------
# widget algebra (mirrors proof_system/constraints.py)
# ---------------------------------------------------------------------------

def delta_dev(x):
    """x(x-1)(x-2)(x-3)."""
    return mm(mm(x, csub(x, 1)), mm(csub(x, 2), csub(x, 3)))


def arith_value_dev(w, q):
    a, b, c, d = w
    out = mm(q["q_m"], mm(a, b))
    out = ad(out, mm(q["q_l"], a))
    out = ad(out, mm(q["q_r"], b))
    out = ad(out, mm(q["q_4"], d))
    out = ad(out, mm(q["q_o"], c))
    return ad(out, q["q_c"])


def range_scalar_dev(w, wn, kappa):
    a, b, c, d = w
    dn = wn[3]
    k2 = mm(kappa, kappa)
    k3 = mm(k2, kappa)
    out = delta_dev(sb(c, cmul(4, d)))
    out = ad(out, mm(kappa, delta_dev(sb(b, cmul(4, c)))))
    out = ad(out, mm(k2, delta_dev(sb(a, cmul(4, b)))))
    return ad(out, mm(k3, delta_dev(sb(dn, cmul(4, a)))))


def logic_scalar_dev(w, wn, q_c, kappa):
    """2-bit quads, product wire on the current row's c (see
    constraints.logic_scalar)."""
    a, b, c, d = w
    an, bn, _cn, dn = wn
    qa = sb(an, cmul(4, a))
    qb = sb(bn, cmul(4, b))
    qd = sb(dn, cmul(4, d))
    wp = c
    l1 = delta_dev(qa)
    l2 = delta_dev(qb)
    l3 = delta_dev(qd)
    l4 = sb(wp, mm(qa, qb))
    s = ad(qa, qb)
    sq = ad(mm(qa, qa), mm(qb, qb))
    w2 = mm(wp, wp)
    andv = sb(ad(ad(cmul(_C83_6, wp), cmul(3, mm(wp, sq))),
                 ad(cmul(_C27_2, w2), cmul(_C2_3, mm(w2, wp)))),
              ad(mm(cmul(_C27_2, wp), s), cmul(3, mm(w2, s))))
    l5 = sb(qd, ad(mm(q_c, s), mm(sb(cst(1, q_c), cmul(3, q_c)), andv)))
    out = l1
    kp = kappa
    for term in (l2, l3, l4, l5):
        out = ad(out, mm(kp, term))
        kp = mm(kp, kappa)
    return out


def fixed_scalar_dev(w, wn, q_l, q_r, q_c, kappa):
    a, b, c, d = w
    an, bn, _cn, dn = wn
    k = sb(dn, cmul(2, d))
    x_t = mm(k, q_l)
    y_t = ad(mm(mm(k, k), csub(q_r, 1)), cst(1, k))
    f1 = mm(mm(k, csub(k, 1)), ad(k, cst(1, k)))
    f2 = sb(c, mm(k, q_c))
    dabc = mm(cmul(JUBJUB_D, a), mm(b, c))
    f3 = sb(ad(an, mm(an, dabc)), ad(mm(a, y_t), mm(b, x_t)))
    f4 = sb(sb(bn, mm(bn, dabc)), ad(mm(b, y_t), mm(a, x_t)))
    k2 = mm(kappa, kappa)
    out = ad(f1, mm(kappa, f2))
    out = ad(out, mm(k2, f3))
    return ad(out, mm(mm(k2, kappa), f4))


def vgadd_scalar_dev(w, wn, kappa):
    x1, y1, x2, y2 = w
    x3, y3, _cn, aux = wn
    v1 = sb(aux, mm(x1, y1))
    dp = mm(cmul(JUBJUB_D, aux), mm(x2, y2))
    v2 = sb(ad(x3, mm(x3, dp)), ad(mm(x1, y2), mm(y1, x2)))
    v3 = sb(sb(y3, mm(y3, dp)), ad(mm(y1, y2), mm(x1, x2)))
    return ad(v1, ad(mm(kappa, v2), mm(mm(kappa, kappa), v3)))


def gate_value_dev(w, wn, q, pi, ch):
    g = ad(mm(q["q_arith"], arith_value_dev(w, q)), pi)
    g = ad(g, mm(mm(ch["range"], q["q_range"]),
                 range_scalar_dev(w, wn, ch["range"])))
    g = ad(g, mm(mm(ch["logic"], q["q_logic"]),
                 logic_scalar_dev(w, wn, q["q_c"], ch["logic"])))
    g = ad(g, mm(mm(ch["fixed"], q["q_fixed"]),
                 fixed_scalar_dev(w, wn, q["q_l"], q["q_r"], q["q_c"],
                                  ch["fixed"])))
    g = ad(g, mm(mm(ch["vgadd"], q["q_vgadd"]),
                 vgadd_scalar_dev(w, wn, ch["vgadd"])))
    return g


def quotient_phase_dev(wire_ph, z_ph, pi_ph, sel_ph, sigma_ph, xpts,
                       alpha, ch, zh_inv_c, l1_vec):
    """t evaluations over one interleaved size-n coset s_i*H.  The next
    row is roll(-1) within the phase (index j+4 on the 4n coset is one
    step further in j on the same phase)."""
    w = tuple(wire_ph[c] for c in "abcd")
    wn = tuple(torch.roll(wire_ph[c], -1, dims=0) for c in "abcd")
    gate = gate_value_dev(w, wn, sel_ph, pi_ph, ch)
    beta, gamma = ch["beta"], ch["gamma"]
    num = den = None
    for j in range(4):
        nt = ad(ad(w[j], mm(beta, cmul(KS[j], xpts))), gamma)
        dt = ad(ad(w[j], mm(beta, sigma_ph[j])), gamma)
        num = nt if num is None else mm(num, nt)
        den = dt if den is None else mm(den, dt)
    perm = sb(mm(num, z_ph), mm(den, torch.roll(z_ph, -1, dims=0)))
    l1_term = mm(l1_vec, csub(z_ph, 1))
    total = ad(gate, ad(mm(alpha, perm), mm(mm(alpha, alpha), l1_term)))
    return mm(total, zh_inv_c)


# ---------------------------------------------------------------------------
# polynomial utilities
# ---------------------------------------------------------------------------

def powers_of(scalar_mont, n: int):
    """[1, s, ..., s^(n-1)] as (n, 8) Montgomery words."""
    return dev.powers_of(scalar_mont, n, FR)


def batch_inv(x):
    return dev.batch_inv_mont(x, FR)


def ev_many(polys, pows):
    """Evaluate k polynomials (each (n, 8)) at the point whose power
    ladder is `pows`: one batched multiply, then a halving tree sum."""
    x = mm(torch.stack(polys), pows[:polys[0].shape[0]])
    x = x.transpose(0, 1).contiguous()          # (n, k, 8)
    m = x.shape[0]
    while m > 1:
        half = m // 2
        s = ad(x[:half], x[half:2 * half])
        if m % 2:
            s = torch.cat([s, x[2 * half:]], dim=0)
        x, m = s, s.shape[0]
    return list(x[0].unsqueeze(1))              # k x (1, 8)


def lincomb(consts_i, polys):
    """sum_i consts_i[i] * polys[i] (host int constants)."""
    acc = None
    for v, p in zip(consts_i, polys):
        term = mm(p, cst(v, p))
        acc = term if acc is None else ad(acc, term)
    return acc


def lincomb_many(const_rows, polys):
    return [lincomb(row, polys) for row in const_rows]


def ruffini_dev(coeffs, z_mont, z_inv_mont, value_mont):
    """(p(X) - p(z)) / (X - z): b_i = z^-i * sum_{j>=i} a_j z^j, via
    power ladders and a reverse add scan.  Returns n-1 coefficients."""
    n = coeffs.shape[0]
    p = torch.cat([sb(coeffs[:1], value_mont), coeffs[1:]], dim=0)
    cj = mm(p, powers_of(z_mont, n))
    suffix = dev.scan(cj, ad, reverse=True)
    return mm(suffix, powers_of(z_inv_mont, n))[1:]


def _invnxn_mod(mat):
    """Inverse of an n x n integer matrix mod r (Gauss-Jordan)."""
    k = len(mat)
    a = [[mat[i][j] % R_MOD for j in range(k)] + [1 if i == j else 0
         for j in range(k)] for i in range(k)]
    for col in range(k):
        piv = next(r for r in range(col, k) if a[r][col] % R_MOD)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], -1, R_MOD)
        a[col] = [x * inv % R_MOD for x in a[col]]
        for r in range(k):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(x - f * y) % R_MOD
                        for x, y in zip(a[r], a[col])]
    return [row[k:] for row in a]


# ---------------------------------------------------------------------------
# device prover
# ---------------------------------------------------------------------------

class DevicePK:
    """Device-resident tables derived from a ProverKey (built once): the
    coefficient tables, sigma evaluations over H, the phase constants of
    the quotient round and, after the first prove, the selector/sigma
    phase transforms (circuit-static)."""

    def __init__(self, pk):
        self.pk = pk
        n = pk.n
        self.log_n = n.bit_length() - 1
        self.sel_coeffs = pk.selector_coeffs
        self.sigma_coeffs = pk.sigma_coeffs
        self.device = self.sigma_coeffs[0].device
        dv = self.device
        self.domain_elems = powers_of(to_dev_scalar(pk.domain.omega, dv), n)
        self.wire_idx = {w: torch.tensor(pk.wire_vars[w], dtype=torch.int64,
                                         device=dv) for w in "abcd"}
        self.sigma_H = list(nttmod.ntt_many(torch.stack(self.sigma_coeffs),
                                            self.log_n))
        g = pk.domain.coset_gen
        w4n = Domain(4 * n).omega
        self.phase_s = [g * pow(w4n, i, R_MOD) % R_MOD for i in range(4)]
        self.phase_u = [pow(s, n, R_MOD) for s in self.phase_s]
        self.vinv = _invnxn_mod(
            [[pow(u, m, R_MOD) for m in range(4)] for u in self.phase_u])
        self.zh_inv_phase = [pow(u - 1, -1, R_MOD) for u in self.phase_u]
        # L1(x) = (u_i - 1) * n_inv / (x - 1) on phase coset i
        self.l1c_phase = [(u - 1) * pk.domain.n_inv % R_MOD
                          for u in self.phase_u]
        self._phase_pows = {}
        self._phase_xl1 = {}
        self.phase_static = None

    def phase_pows_inv(self, i: int):
        """powers_of(s_i^-1), which undo phase i's coset scale; cached."""
        if i not in self._phase_pows:
            self._phase_pows[i] = powers_of(
                to_dev_scalar(pow(self.phase_s[i], -1, R_MOD), self.device),
                1 << self.log_n)
        return self._phase_pows[i]

    def phase_xpts_l1(self, i: int):
        """(points of phase coset i, L1 over them), cached."""
        if i not in self._phase_xl1:
            xpts = mm(cst(self.phase_s[i], self.domain_elems),
                      self.domain_elems)
            l1 = mm(cst(self.l1c_phase[i], xpts), batch_inv(csub(xpts, 1)))
            self._phase_xl1[i] = (xpts, l1)
        return self._phase_xl1[i]

    def static_phases(self):
        """Selector and sigma evaluations on the 4 phase cosets, built on
        first use (15 transforms per phase)."""
        if self.phase_static is None:
            polys = torch.stack([self.sel_coeffs[k] for k in SELECTOR_NAMES]
                                + list(self.sigma_coeffs))
            ns = len(SELECTOR_NAMES)
            self.phase_static = []
            for i in range(4):
                out = list(nttmod.ntt_many(polys, self.log_n,
                                           scale=self.phase_s[i]))
                self.phase_static.append(
                    (dict(zip(SELECTOR_NAMES, out[:ns])), out[ns:]))
        return self.phase_static


def wire_values_dev(dpk: DevicePK, witness_mont):
    return {w: witness_mont[dpk.wire_idx[w]] for w in "abcd"}


def grand_product_dev(wires, sigma_H, domain_elems, beta, gamma):
    """z evaluations over H and the closing product (Montgomery)."""
    num = den = None
    for j, w in enumerate("abcd"):
        wv = wires[w]
        nt = ad(ad(wv, mm(beta, cmul(KS[j], domain_elems))), gamma)
        dt = ad(ad(wv, mm(beta, sigma_H[j])), gamma)
        num = nt if num is None else mm(num, nt)
        den = dt if den is None else mm(den, dt)
    prefix = dev.prefix_mul_mont(mm(num, batch_inv(den)), FR)
    z = torch.cat([cst(1, prefix), prefix[:-1]], dim=0)
    return z, prefix[-1:]


def _aggregate_open(poly_value_pairs, v_i: int, point_i: int):
    """Fold (poly, value) pairs with powers of v, subtract the folded
    value, divide by (X - point): the opening quotient's coefficients."""
    k = len(poly_value_pairs)
    vps = [pow(v_i, j, R_MOD) for j in range(k)]
    agg = lincomb(vps, [c for c, _ in poly_value_pairs])
    agg_val = sum(vp * value for vp, (_, value)
                  in zip(vps, poly_value_pairs)) % R_MOD
    z_inv = pow(point_i, -1, R_MOD)
    d = agg.device
    return ruffini_dev(agg, to_dev_scalar(point_i, d),
                       to_dev_scalar(z_inv, d), to_dev_scalar(agg_val, d))


def check_committer(committer, device):
    """The device an entry point runs on (cuda unless named), which must
    be where the committer's SRS table lives."""
    dv = resolve_device(device)
    if committer.device.type != dv.type:
        raise ValueError(f"committer lives on {committer.device}, "
                         f"the call asked for {dv}")
    return committer.device


@contextlib.contextmanager
def _timed(out, name: str, device):
    """Wall seconds of a round into out[name], synchronised with the
    card so the round's launches are inside it."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if out is not None:
        out[name] = time.perf_counter() - t0


def prove_device(composer, pk, committer, label=None, dpk: DevicePK = None,
                 timings: dict = None, device=None):
    """Unblinded single-device prover; mirrors the reference host prover
    round for round and produces byte-identical proofs.  `device` must
    match the committer's (cuda unless named); `timings`, if given,
    receives each round's seconds."""
    dv = check_committer(committer, device)
    if label is None:
        label = L.PROTOCOL
    if dpk is None:
        dpk = DevicePK(pk)
    n = pk.n
    log_n = dpk.log_n
    dom = pk.domain
    commit_many = committer.commit_many

    t = Transcript(label)
    t.circuit_domain_sep(n)

    # ---------------- round 1: wires ----------------
    with _timed(timings, "r1_wires", dv):
        witness_mont = to_dev(composer.witness, dv)
        wires_H = wire_values_dev(dpk, witness_mont)
        wire_coeffs = dict(zip("abcd", nttmod.ntt_many(
            torch.stack([wires_H[w] for w in "abcd"]), log_n, inverse=True)))
        comm = {}
        wire_comms = commit_many([wire_coeffs[w] for w in "abcd"])
        for (lbl, name), cm in zip(
                ((L.W_L, "w_l"), (L.W_R, "w_r"),
                 (L.W_O, "w_o"), (L.W_4, "w_4")), wire_comms):
            comm[name] = cm
            t.append_commitment(lbl, cm)
    beta_i = t.challenge_scalar(L.BETA)
    t.append_scalar(L.BETA, beta_i)
    gamma_i = t.challenge_scalar(L.GAMMA)
    beta = to_dev_scalar(beta_i, dv)
    gamma = to_dev_scalar(gamma_i, dv)

    # ---------------- round 2: grand product ----------------
    with _timed(timings, "r2_grand_product", dv):
        z_H, _ = grand_product_dev(wires_H, dpk.sigma_H, dpk.domain_elems,
                                   beta, gamma)
        z_coeffs = nttmod.intt(z_H, log_n)
        comm["z"] = committer.commit(z_coeffs)
    t.append_commitment(L.Z, comm["z"])
    alpha_i = t.challenge_scalar(L.ALPHA)
    ch_i = {
        "range": t.challenge_scalar(L.RANGE_SEP),
        "logic": t.challenge_scalar(L.LOGIC_SEP),
        "fixed": t.challenge_scalar(L.FIXED_SEP),
        "vgadd": t.challenge_scalar(L.VGADD_SEP),
    }
    alpha = to_dev_scalar(alpha_i, dv)
    ch = {k: to_dev_scalar(v, dv) for k, v in ch_i.items()}
    ch["beta"] = beta
    ch["gamma"] = gamma

    # ---------------- round 3: quotient (4 interleaved phases) -------
    with _timed(timings, "r3_quotient", dv):
        pi_vec = [0] * n
        for gi, val in composer.pi.items():
            pi_vec[gi] = val
        pi_coeffs = nttmod.intt(to_dev(pi_vec, dv), log_n)
        dyn = torch.stack([wire_coeffs[w] for w in "abcd"]
                          + [z_coeffs, pi_coeffs])
        static = dpk.static_phases()
        t_phase = []
        for i in range(4):
            out = nttmod.ntt_many(dyn, log_n, scale=dpk.phase_s[i])
            wire_ph = dict(zip("abcd", out[:4]))
            sel_ph, sigma_ph = static[i]
            xpts, l1_vec = dpk.phase_xpts_l1(i)
            t_phase.append(quotient_phase_dev(
                wire_ph, out[4], out[5], sel_ph, sigma_ph, xpts, alpha, ch,
                to_dev_scalar(dpk.zh_inv_phase[i], dv), l1_vec))
        t_inv = nttmod.ntt_many(torch.stack(t_phase), log_n, inverse=True)
        inv_pows = torch.stack([dpk.phase_pows_inv(i) for i in range(4)])
        c_phase = list(mm(t_inv, inv_pows))
        # t_{4m+k} from the phase coefficient streams: inverse
        # Vandermonde in u_i = s_i^n
        chunks = lincomb_many([dpk.vinv[m] for m in range(4)], c_phase)
        chunk_comms = commit_many(chunks)
        for k, lbl in enumerate((L.T_1, L.T_2, L.T_3, L.T_4)):
            comm[f"t_{k + 1}"] = chunk_comms[k]
            t.append_commitment(lbl, chunk_comms[k])
    zeta_i = t.challenge_scalar(L.ZETA)
    zw_i = zeta_i * dom.omega % R_MOD
    zeta = to_dev_scalar(zeta_i, dv)
    zw = to_dev_scalar(zw_i, dv)

    # ---------------- round 4: evaluations + linearization ----------
    with _timed(timings, "r4_evals", dv):
        zeta_pows = powers_of(zeta, n)
        zw_pows = powers_of(zw, n)
        zeta_names = ("a", "b", "c", "d", "sigma1", "sigma2", "sigma3",
                      "q_arith", "q_c", "q_l", "q_r")
        zeta_polys = [wire_coeffs[w] for w in "abcd"] \
            + list(dpk.sigma_coeffs[:3]) \
            + [dpk.sel_coeffs[nm] for nm in ("q_arith", "q_c",
                                             "q_l", "q_r")]
        zw_names = ("a_next", "b_next", "d_next", "z_shifted")
        zw_polys = [wire_coeffs[w] for w in "abd"] + [z_coeffs]
        ev = dict(zip(zeta_names, ev_many(zeta_polys, zeta_pows)))
        ev.update(zip(zw_names, ev_many(zw_polys, zw_pows)))
        names = list(ev)
        ev_i = dict(zip(names, from_dev(torch.cat([ev[k] for k in names]))))

        co = host.linearization_coefficients(
            ev_i, zeta_i, beta_i, gamma_i, alpha_i, ch_i, dom)
        lin_names = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c",
                     "q_range", "q_logic", "q_fixed", "q_vgadd")
        r_coeffs = lincomb(
            [co[nm] for nm in lin_names] + [co["z"], co["sigma4"]],
            [dpk.sel_coeffs[nm] for nm in lin_names]
            + [z_coeffs, dpk.sigma_coeffs[3]])
        ev_i["r"] = from_dev(ev_many([r_coeffs], zeta_pows)[0])[0]
        pi_at_zeta = host.eval_pi(composer.pi, dom, zeta_i)
        t_eval = host.compute_t_eval(ev_i, pi_at_zeta, zeta_i, beta_i,
                                     gamma_i, alpha_i, dom)
    host.append_evals(t, ev_i, t_eval)
    v_i = t.challenge_scalar(L.AGGREGATE_WITNESS)

    # ---------------- round 5: aggregate openings ----------------
    with _timed(timings, "r5_openings", dv):
        zn = pow(zeta_i, n, R_MOD)
        t_flat = lincomb([pow(zn, k, R_MOD) for k in range(4)], chunks)
        agg_zeta = [
            (t_flat, t_eval), (r_coeffs, ev_i["r"]),
            (wire_coeffs["a"], ev_i["a"]), (wire_coeffs["b"], ev_i["b"]),
            (wire_coeffs["c"], ev_i["c"]), (wire_coeffs["d"], ev_i["d"]),
            (dpk.sigma_coeffs[0], ev_i["sigma1"]),
            (dpk.sigma_coeffs[1], ev_i["sigma2"]),
            (dpk.sigma_coeffs[2], ev_i["sigma3"]),
            (dpk.sel_coeffs["q_arith"], ev_i["q_arith"]),
            (dpk.sel_coeffs["q_c"], ev_i["q_c"]),
            (dpk.sel_coeffs["q_l"], ev_i["q_l"]),
            (dpk.sel_coeffs["q_r"], ev_i["q_r"]),
        ]
        agg_zw = [
            (z_coeffs, ev_i["z_shifted"]),
            (wire_coeffs["a"], ev_i["a_next"]),
            (wire_coeffs["b"], ev_i["b_next"]),
            (wire_coeffs["d"], ev_i["d_next"]),
        ]
        comm["w_z"], comm["w_zw"] = commit_many(
            [_aggregate_open(agg_zeta, v_i, zeta_i),
             _aggregate_open(agg_zw, v_i, zw_i)])
    t.append_commitment(L.W_Z, comm["w_z"])
    t.append_commitment(L.W_Z_W, comm["w_zw"])

    evals = {k: ev_i[k] for k in
             ("a", "b", "c", "d", "a_next", "b_next", "d_next",
              "sigma1", "sigma2", "sigma3",
              "q_arith", "q_c", "q_l", "q_r", "z_shifted", "r")}
    return Proof(comm, evals)
