"""Device prover engine (mirrors tpu_plonk/proof_system/engine_device.py:
one device or a mesh of ranks, unblinded or blinded, with optional round
checkpoints): the polynomial rounds on torch tensors, the transcript,
proof assembly and the linearization scalars on the host.  Proofs are
byte-identical to the reference's host prover.

Device values are (..., 8) int32 Montgomery words (fields/device.py).
Every `mm`/`ad`/`sb` is the Fr multiply / add-sub kernel on the card,
every transform the NTT kernel, every commit the MSM kernels, every
quotient phase the quotient kernel; on CPU tensors the same code runs
the plain versions.

The quotient round is phased as in the reference: the Pn extended coset
(P = 4, or 8 for a blinded prove) splits into P interleaved size-n
cosets s_i*H (s_i = g*w_Pn^i), each evaluated with size-n transforms,
and the per-phase coefficients recombine into t(X)'s chunks by a PxP
inverse Vandermonde in u_i = s_i^n.  No vector longer than n exists.
"""

import contextlib
import time

import torch

from ..params import R_MOD, K1, K2, K3
from ..fields import device as dev
from ..kernels import resolve_device
from ..poly import ntt as nttmod
from ..poly.domain import Domain
from ..cs.composer import SELECTOR_NAMES
from ..curves import g1
from ..dist import ntt_sharded
from ..pcs import msm as hostmsm
from ..transcript import Transcript
from ..transcript import labels as L
from ..utils import checkpoint
from . import prover as host
from . import quotient
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


def quotient_phase_dev(wire_ph, z_ph, pi_ph, sel_ph, sigma_ph, xpts,
                       alpha, ch, zh_inv_c, l1_vec):
    """t evaluations over one interleaved size-n coset s_i*H: the quotient
    kernel on CUDA tensors (the only route there), its plain version on
    CPU tensors (proof_system/quotient.py)."""
    body = quotient.quotient_phase_kernel if xpts.device.type == "cuda" \
        else quotient.quotient_phase_plain
    return body(wire_ph, z_ph, pi_ph, sel_ph, sigma_ph, xpts, alpha, ch,
                zh_inv_c, l1_vec)


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

class PhaseSet:
    """One quotient variant: the P interleaved size-n cosets s_i*H of the
    Pn extended coset (s_i = g*w_Pn^i), with s_i, u_i = s_i^n, the PxP
    inverse Vandermonde in u_i, Z_H^-1 = (u_i - 1)^-1 and the L1
    constant (u_i - 1) / n (L1(x) = that / (x - 1) on coset i), and the
    device tables derived from them, each built on first use."""

    def __init__(self, pk, n_phases: int):
        n = pk.n
        g = pk.domain.coset_gen
        w = Domain(n_phases * n).omega
        self.n_phases = n_phases
        self.s = [g * pow(w, i, R_MOD) % R_MOD for i in range(n_phases)]
        self.u = [pow(si, n, R_MOD) for si in self.s]
        self.vinv = _invnxn_mod([[pow(ui, m, R_MOD)
                                  for m in range(n_phases)]
                                 for ui in self.u])
        self.zh_inv = [pow(ui - 1, -1, R_MOD) for ui in self.u]
        self.l1c = [(ui - 1) * pk.domain.n_inv % R_MOD for ui in self.u]
        self.pows_inv = {}      # i -> powers_of(s_i^-1)
        self.xpts_l1 = None     # per phase: (coset points, L1 over them)
        self.static = None      # per phase: (selector dict, sigma list)


class DevicePK:
    """Device-resident tables derived from a ProverKey (built once): the
    coefficient tables, sigma evaluations over H, and per quotient
    variant (4 phases unblinded, 8 blinded: disjoint coset families) a
    PhaseSet whose selector/sigma phase transforms are circuit-static
    and cached after the first prove of that variant."""

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
        self._phase_sets = {}
        # [tau^(n+k)]G1 for blinded commits, filled by _resolve_high_g1
        self._high_g1 = None

    def phases(self, n_phases: int) -> PhaseSet:
        """The PhaseSet of the n_phases-phase variant, built on first use."""
        if n_phases not in self._phase_sets:
            self._phase_sets[n_phases] = PhaseSet(self.pk, n_phases)
        return self._phase_sets[n_phases]

    def phase_pows_inv(self, i: int, n_phases: int):
        """powers_of(s_i^-1), which undo phase i's coset scale; cached."""
        ph = self.phases(n_phases)
        if i not in ph.pows_inv:
            ph.pows_inv[i] = powers_of(
                to_dev_scalar(pow(ph.s[i], -1, R_MOD), self.device),
                1 << self.log_n)
        return ph.pows_inv[i]

    def phase_xpts_l1(self, i: int, n_phases: int):
        """(points of phase coset i, L1 over them), built for all phases
        of the variant at once (one batch inversion) and cached."""
        ph = self.phases(n_phases)
        if ph.xpts_l1 is None:
            n = 1 << self.log_n
            dv = self.device
            xpts = mm(to_dev(ph.s, dv)[:, None].expand(n_phases, n,
                                                       FR.n_words),
                      self.domain_elems)
            inv = batch_inv(csub(xpts, 1).reshape(-1, FR.n_words))
            l1 = mm(to_dev(ph.l1c, dv)[:, None].expand(n_phases, n,
                                                       FR.n_words),
                    inv.reshape(n_phases, n, FR.n_words))
            ph.xpts_l1 = list(zip(xpts, l1))
        return ph.xpts_l1[i]

    def static_phases(self, n_phases: int):
        """Selector and sigma evaluations on the phase cosets, built on
        first use (15 transforms per phase) and cached per variant."""
        ph = self.phases(n_phases)
        if ph.static is None:
            polys = torch.stack([self.sel_coeffs[k] for k in SELECTOR_NAMES]
                                + list(self.sigma_coeffs))
            ns = len(SELECTOR_NAMES)
            ph.static = []
            for s in ph.s:
                out = list(nttmod.ntt_many(polys, self.log_n, scale=s))
                ph.static.append((dict(zip(SELECTOR_NAMES, out[:ns])),
                                  out[ns:]))
        return ph.static


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


def _aggregate_open_blinded(triples, v_i: int, point_i: int, n: int):
    """_aggregate_open for blinded polynomials: each triple is (low
    coeffs on the device, value, host highs at X^(n+k)).  The division
    splits linearly: (p_low - p_low(z))/(X - z) is the usual Ruffini;
    (p_high - p_high(z))/(X - z) has the closed form b_(n+1) = h2,
    b_n = h1 + z h2, b_(n-1) = h0 + z b_n and b_k = z^(n-1-k) b_(n-1)
    for k <= n-1 (one scaled power ladder of z^-1).  Returns the (n, 8)
    low quotient and its highs (b_n, b_(n+1))."""
    vps = [pow(v_i, j, R_MOD) for j in range(len(triples))]
    agg = lincomb(vps, [c for c, _, _ in triples])
    agg_val = 0
    hi = [0, 0, 0]
    for vp, (_, value, highs) in zip(vps, triples):
        agg_val = (agg_val + vp * value) % R_MOD
        for k, h in enumerate(highs):
            hi[k] = (hi[k] + vp * h) % R_MOD
    z = point_i
    z_inv = pow(z, -1, R_MOD)
    zpn = pow(z, n, R_MOD)
    v_high = (hi[0] * zpn + hi[1] * zpn * z + hi[2] * zpn * z * z) % R_MOD
    d = agg.device
    q_low = ruffini_dev(agg, to_dev_scalar(z, d), to_dev_scalar(z_inv, d),
                        to_dev_scalar((agg_val - v_high) % R_MOD, d))
    b_np1 = hi[2]
    b_n = (hi[1] + z * hi[2]) % R_MOD
    b_nm1 = (hi[0] + z * b_n) % R_MOD
    q = torch.cat([q_low, torch.zeros_like(q_low[:1])], dim=0)
    scale = b_nm1 * pow(z, n - 1, R_MOD) % R_MOD
    if scale:
        q = ad(q, mm(cst(scale, q),
                     powers_of(to_dev_scalar(z_inv, d), n)))
    return q, (b_n, b_np1)


def _blind_commit(cm, highs, high_pts):
    """cm + sum_k highs[k] [tau^(n+k)]G1: the commitment of a blinded
    polynomial from its device-sized low part (KZG is linear), with a
    few host scalar multiplications."""
    pairs = [(high_pts[k], h) for k, h in enumerate(highs) if h]
    if not pairs:
        return cm
    return g1.add(cm, hostmsm.msm_small(pairs))


def _resolve_high_g1(dpk: DevicePK, committer, n: int):
    """The points [tau^(n+k)]G1 a blinded prove needs, read off the
    committer's SRS table (DeviceCommitter.high_g1) and cached on the
    DevicePK.  Raises ValueError when the committer cannot supply them."""
    if dpk._high_g1 is None:
        if not hasattr(committer, "high_g1"):
            raise ValueError("blinded prove needs [tau^(n+k)]G1 from the "
                             "committer's SRS table: use a DeviceCommitter")
        dpk._high_g1 = committer.high_g1(n)
    return dpk._high_g1


def _hi(highs, x: int, n: int) -> int:
    """sum_k highs[k] x^(n+k): a blinded polynomial's high part at x."""
    xp = pow(x, n, R_MOD)
    acc = 0
    for h in highs:
        acc = (acc + h * xp) % R_MOD
        xp = xp * x % R_MOD
    return acc


def check_committer(committer, device):
    """The device an entry point runs on (cuda unless named, the current
    CUDA device), which must be the one, index included, where the
    committer's SRS table lives."""
    dv = resolve_device(device)
    if committer.device != dv:
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
                 timings: dict = None, device=None,
                 blinding_seed: bytes = None, mesh=None, ckpt=None):
    """Device prover; mirrors the reference host prover round for round
    and produces byte-identical proofs.  `device` must match the
    committer's (cuda unless named); `timings`, if given, receives each
    round's seconds.

    `blinding_seed` switches on the zero-knowledge variant (1088-byte
    proofs, byte-identical to the reference host prover's for the same
    seed).  Device arrays stay n-sized: the <= 3 high blinding
    coefficients of each polynomial are host scalars, entering as
    commitment corrections (_blind_commit), as rank-1 corrections on the
    quotient's phase cosets (x^(n+k) = u_i x^k there) and as host
    evaluation corrections.  deg t = 4n + 6 needs the 8n coset: eight
    phases, an 8x8 inverse Vandermonde and five chunks.

    With `mesh` (dist/mesh.py; every rank of it calls prove_device
    together, on the same inputs), every wire, z, PI and quotient
    transform runs as the sharded four-step (dist/ntt_sharded.py), each
    rank transforming its row block, and `committer` must be a
    ShardedCommitter over the same mesh; the other rounds, the transcript
    and the DevicePK tables stay replicated on each rank, as in the
    reference's multi-controller path.  The proof is the single-device
    one, on every rank.

    With `ckpt` (utils/checkpoint.RoundCheckpoint), each round's outputs
    are saved as host data once computed, and a prove that finds them
    saved loads them instead of computing the round again: a prove that
    failed resumes at its last round boundary, with the same bytes (the
    transcript replays from the saved commitments).  On a mesh, give
    each rank a file of its own."""
    dv = check_committer(committer, device)
    if mesh is not None and getattr(committer, "mesh", None) != mesh:
        raise ValueError("a mesh prove commits through a ShardedCommitter "
                         "over the same mesh")
    if label is None:
        label = L.PROTOCOL
    if dpk is None:
        dpk = DevicePK(pk)
    elif dpk.device != dv:
        raise ValueError(f"dpk lives on {dpk.device}, the committer on {dv}")
    n = pk.n
    log_n = dpk.log_n
    dom = pk.domain
    commit_many = committer.commit_many
    blinds = host._blinders(blinding_seed, 11) \
        if blinding_seed is not None else None
    high_pts = _resolve_high_g1(dpk, committer, n) \
        if blinds is not None else None
    # host-tracked high coefficients: p = p_low + sum_k h_k X^(n+k)
    wire_high = {w: () for w in "abcd"}
    z_high = ()
    if blinds is not None:
        # (b0 X + b1) Z_H per wire: -b0, -b1 at rows 0, 1; the highs
        # b0, b1 at X^n, X^(n+1) stay on the host.  z: three.
        for j, w in enumerate("abcd"):
            wire_high[w] = tuple(blinds[2 * j:2 * j + 2])
        z_high = tuple(blinds[8:11])

    def transform(xs, inverse=False, scale=1):
        """(B, n, 8) on every rank -> their (i)NTTs (ntt_many semantics):
        one batched kernel call, or on a mesh the sharded four-step."""
        if mesh is None:
            return nttmod.ntt_many(xs, log_n, inverse, scale)
        return ntt_sharded.ntt_replicated(mesh, xs, log_n, inverse, scale)

    def memo(key, fn):
        """fn() (a round's outputs), or with a checkpoint the outputs it
        saved, back on the device."""
        if ckpt is None:
            return fn()
        return checkpoint.to_device(
            ckpt.memo(key, lambda: checkpoint.to_host(fn())), dv)

    t = Transcript(label)
    t.circuit_domain_sep(n)

    # ---------------- round 1: wires ----------------
    with _timed(timings, "r1_wires", dv):
        witness_mont = to_dev(composer.witness, dv)
        wires_H = wire_values_dev(dpk, witness_mont)

        def round1():
            wire_all = transform(torch.stack([wires_H[w] for w in "abcd"]),
                                 inverse=True)
            if blinds is not None:
                wire_all[:, :2] = sb(wire_all[:, :2],
                                     to_dev(blinds[:8], dv).reshape(4, 2, -1))
            cms = commit_many(list(wire_all))
            if blinds is not None:
                cms = [_blind_commit(cm, wire_high[w], high_pts)
                       for w, cm in zip("abcd", cms)]
            return wire_all, cms

        wire_all, wire_comms = memo("r1", round1)
        wire_coeffs = dict(zip("abcd", wire_all))
        comm = {}
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
        def round2():
            z_H, _ = grand_product_dev(wires_H, dpk.sigma_H,
                                       dpk.domain_elems, beta, gamma)
            z_coeffs = transform(z_H[None], inverse=True)[0]
            if blinds is not None:
                z_coeffs[:3] = sb(z_coeffs[:3], to_dev(z_high, dv))
            cm = committer.commit(z_coeffs)
            if blinds is not None:
                cm = _blind_commit(cm, z_high, high_pts)
            return z_coeffs, cm

        z_coeffs, comm["z"] = memo("r2", round2)
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

    # ---------------- round 3: quotient (interleaved phases) ---------
    n_phases, n_chunks = (4, 4) if blinds is None else (8, 5)
    with _timed(timings, "r3_quotient", dv):
        def round3():
            ph = dpk.phases(n_phases)
            pi_vec = [0] * n
            for gi, val in composer.pi.items():
                pi_vec[gi] = val
            pi_coeffs = transform(to_dev(pi_vec, dv)[None], inverse=True)[0]
            dyn = torch.stack([wire_coeffs[w] for w in "abcd"]
                              + [z_coeffs, pi_coeffs])
            static = dpk.static_phases(n_phases)
            t_phase = []
            for i in range(n_phases):
                out = transform(dyn, scale=ph.s[i])
                wire_ph = dict(zip("abcd", out[:4]))
                z_ph = out[4]
                sel_ph, sigma_ph = static[i]
                xpts, l1_vec = dpk.phase_xpts_l1(i, n_phases)
                if blinds is not None:
                    # x^(n+k) = u_i x^k on coset i: each high part is a
                    # constant-coefficient polynomial in x there
                    u = ph.u[i]
                    for w in "abcd":
                        b0, b1 = wire_high[w]
                        wire_ph[w] = ad(wire_ph[w], ad(
                            cst(u * b0 % R_MOD, xpts),
                            mm(cst(u * b1 % R_MOD, xpts), xpts)))
                    zc = ad(cst(u * z_high[0] % R_MOD, xpts),
                            mm(cst(u * z_high[1] % R_MOD, xpts), xpts))
                    zc = ad(zc, mm(cst(u * z_high[2] % R_MOD, xpts),
                                   mm(xpts, xpts)))
                    z_ph = ad(z_ph, zc)
                t_phase.append(quotient_phase_dev(
                    wire_ph, z_ph, out[5], sel_ph, sigma_ph, xpts, alpha,
                    ch, to_dev_scalar(ph.zh_inv[i], dv), l1_vec))
            t_inv = transform(torch.stack(t_phase), inverse=True)
            inv_pows = torch.stack([dpk.phase_pows_inv(i, n_phases)
                                    for i in range(n_phases)])
            c_phase = list(mm(t_inv, inv_pows))
            # t_{mn+k} from the phase coefficient streams: inverse
            # Vandermonde in u_i = s_i^n (blinded: only chunks 0..4 are
            # nonzero, deg t = 4n + 6)
            chunks = lincomb_many(ph.vinv[:n_chunks], c_phase)
            return chunks, commit_many(chunks)

        chunks, chunk_comms = memo("r3", round3)
        t_labels = (L.T_1, L.T_2, L.T_3, L.T_4, L.T_5)[:n_chunks]
        for k, lbl in enumerate(t_labels):
            comm[f"t_{k + 1}"] = chunk_comms[k]
            t.append_commitment(lbl, chunk_comms[k])
    zeta_i = t.challenge_scalar(L.ZETA)
    zw_i = zeta_i * dom.omega % R_MOD
    zeta = to_dev_scalar(zeta_i, dv)
    zw = to_dev_scalar(zw_i, dv)

    # ---------------- round 4: evaluations + linearization ----------
    with _timed(timings, "r4_evals", dv):
        def round4():
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
            ev_i = dict(zip(names, from_dev(torch.cat([ev[k]
                                                       for k in names]))))
            if blinds is not None:
                for w in "abcd":
                    ev_i[w] = (ev_i[w] + _hi(wire_high[w], zeta_i, n)) \
                        % R_MOD
                    if w != "c":
                        ev_i[w + "_next"] = (ev_i[w + "_next"] + _hi(
                            wire_high[w], zw_i, n)) % R_MOD
                ev_i["z_shifted"] = (ev_i["z_shifted"]
                                     + _hi(z_high, zw_i, n)) % R_MOD

            co = host.linearization_coefficients(
                ev_i, zeta_i, beta_i, gamma_i, alpha_i, ch_i, dom)
            lin_names = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c",
                         "q_range", "q_logic", "q_fixed", "q_vgadd")
            r_coeffs = lincomb(
                [co[nm] for nm in lin_names] + [co["z"], co["sigma4"]],
                [dpk.sel_coeffs[nm] for nm in lin_names]
                + [z_coeffs, dpk.sigma_coeffs[3]])
            ev_i["r"] = from_dev(ev_many([r_coeffs], zeta_pows)[0])[0]
            # r inherits z's high coefficients, scaled by co["z"]
            r_high = tuple(co["z"] * h % R_MOD for h in z_high)
            ev_i["r"] = (ev_i["r"] + _hi(r_high, zeta_i, n)) % R_MOD
            pi_at_zeta = host.eval_pi(composer.pi, dom, zeta_i)
            t_eval = host.compute_t_eval(ev_i, pi_at_zeta, zeta_i, beta_i,
                                         gamma_i, alpha_i, dom)
            return ev_i, r_coeffs, r_high, t_eval

        ev_i, r_coeffs, r_high, t_eval = memo("r4", round4)
    host.append_evals(t, ev_i, t_eval)
    v_i = t.challenge_scalar(L.AGGREGATE_WITNESS)

    # ---------------- round 5: aggregate openings ----------------
    with _timed(timings, "r5_openings", dv):
        def round5():
            zn = pow(zeta_i, n, R_MOD)
            t_flat = lincomb([pow(zn, k, R_MOD) for k in range(n_chunks)],
                             chunks)
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
            if blinds is None:
                return tuple(commit_many(
                    [_aggregate_open(agg_zeta, v_i, zeta_i),
                     _aggregate_open(agg_zw, v_i, zw_i)]))
            hz = [(), r_high] + [wire_high[w] for w in "abcd"] + [()] * 7
            hzw = [z_high] + [wire_high[w] for w in "abd"]
            qz, qz_high = _aggregate_open_blinded(
                [(c, v, h) for (c, v), h in zip(agg_zeta, hz)],
                v_i, zeta_i, n)
            qzw, qzw_high = _aggregate_open_blinded(
                [(c, v, h) for (c, v), h in zip(agg_zw, hzw)],
                v_i, zw_i, n)
            cms = commit_many([qz, qzw])
            return (_blind_commit(cms[0], qz_high, high_pts),
                    _blind_commit(cms[1], qzw_high, high_pts))

        comm["w_z"], comm["w_zw"] = memo("r5", round5)
    t.append_commitment(L.W_Z, comm["w_z"])
    t.append_commitment(L.W_Z_W, comm["w_zw"])

    evals = {k: ev_i[k] for k in
             ("a", "b", "c", "d", "a_next", "b_next", "d_next",
              "sigma1", "sigma2", "sigma3",
              "q_arith", "q_c", "q_l", "q_r", "z_shifted", "r")}
    return Proof(comm, evals)
