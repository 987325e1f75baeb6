"""The port's quotient-phase body (tpu_plonk_torch/proof_system/quotient.py)
on the CPU: its plain version against a pure-Python oracle of the same
body built from the reference's constraint algebra
(tpu_plonk.proof_system.constraints.gate_value plus the permutation, L1
and Z_H^-1 terms of the reference host prover's _quotient_evals), on
seeded random inputs, exactly.  Each phase is self-contained, so the next
row of row i is (i + 1) mod n.  Also: the multiply count behind the
kernel's bound, the CUDA kernel's regrouped algebra (emulated here on the
plain field ops, widget by widget as csrc/quotient.cu does it) and the
kernel wrapper's operand checks."""

import os
import re

import numpy as np
import pytest
import torch

from tpu_plonk.params import R_MOD, K1, K2, K3
from tpu_plonk.proof_system import constraints as jC

from tpu_plonk_torch import kernels, params as tparams
from tpu_plonk_torch.fields import device as dev
from tpu_plonk_torch.proof_system import quotient

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CH_NAMES = ("beta", "gamma", "range", "logic", "fixed", "vgadd")


def _inputs(n, seed):
    """Host ints: the 23 input vectors by name, and the 8 scalars
    (the six challenges, alpha, zh_inv)."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(32), "little") % R_MOD

    vecs = {name: [rand() for _ in range(n)] for name in quotient.IN_NAMES}
    scal = {name: rand() for name in CH_NAMES + ("alpha", "zh_inv")}
    return vecs, scal


def _port_args(vecs, scal):
    def w(vals):
        return dev.ints_to_words(vals, dev.FR, "cpu", mont=True)
    v = {k: w(x) for k, x in vecs.items()}
    s = {k: w([x]) for k, x in scal.items()}
    return ({c: v[c] for c in "abcd"}, v["z"], v["pi"],
            {k: v[k] for k in quotient.SEL_ORDER},
            [v[f"sigma{j}"] for j in range(1, 5)], v["xpts"], s["alpha"],
            {k: s[k] for k in CH_NAMES}, s["zh_inv"], v["l1"])


def _oracle(vecs, scal):
    """tpu_plonk/proof_system/prover.py _quotient_evals on one phase."""
    n = len(vecs["a"])
    M = R_MOD
    beta, gamma, alpha = scal["beta"], scal["gamma"], scal["alpha"]
    ch = {k: scal[k] for k in ("range", "logic", "fixed", "vgadd")}
    ks = (1, K1, K2, K3)
    out = []
    for i in range(n):
        inx = (i + 1) % n
        w = tuple(vecs[c][i] for c in "abcd")
        wn = tuple(vecs[c][inx] for c in "abcd")
        q = {k: vecs[k][i] for k in quotient.SEL_ORDER}
        gate = jC.gate_value(w, wn, q, vecs["pi"][i], ch)
        x = vecs["xpts"][i]
        num = den = 1
        for j in range(4):
            num = num * ((w[j] + beta * ks[j] * x + gamma) % M) % M
            den = den * ((w[j] + beta * vecs[f"sigma{j + 1}"][i] + gamma)
                         % M) % M
        z, zn = vecs["z"][i], vecs["z"][inx]
        perm = (num * z - den * zn) % M
        l1_term = vecs["l1"][i] * ((z - 1) % M) % M
        total = (gate + alpha * perm + alpha * alpha % M * l1_term) % M
        out.append(total * scal["zh_inv"] % M)
    return out


@pytest.mark.parametrize("n,seed", [(64, 1), (37, 2)])
def test_plain_matches_reference_oracle(n, seed):
    vecs, scal = _inputs(n, seed)
    got = quotient.quotient_phase_plain(*_port_args(vecs, scal))
    assert got.shape == (n, 8)
    assert dev.words_to_ints(got, mont=True, ctx=dev.FR) == \
        _oracle(vecs, scal)


def test_multiply_count_behind_the_bound(monkeypatch):
    """MULS_PER_POINT, which chip_smoke.py's bound for the kernel counts,
    is the number of point-wise multiplies the plain version (and the
    kernel, step for step) does."""
    n = 16
    count = [0]
    plain = dev.mont_mul_plain

    def counted(a, b, ctx):
        out = plain(a, b, ctx)
        count[0] += out.shape[0] == n
        return out

    monkeypatch.setattr(dev, "mont_mul_plain", counted)
    quotient.quotient_phase_plain(*_port_args(*_inputs(n, 3)))
    assert count[0] == quotient.MULS_PER_POINT


def _kernel_algebra(wire_ph, z_ph, pi_ph, q, sigma_ph, xpts, alpha, ch,
                    zh_inv_c, l1_vec, count):
    """csrc/quotient.cu's widgets on the plain field ops, step for step;
    count[0] gains one per point-wise multiply."""
    n = xpts.shape[0]
    FR = dev.FR

    def mm(x, y):
        out = dev.mont_mul_plain(x, y, FR)
        count[0] += out.shape[0] == n
        return out

    def ad(x, y):
        return dev.add_mod_plain(x, y, FR)

    def sb(x, y):
        return dev.sub_mod_plain(x, y, FR)

    def x2(v):
        return ad(v, v)

    def x3(v):
        return ad(x2(v), v)

    def x4(v):
        return x2(x2(v))

    def cst(v):
        return FR.const(v, "cpu")

    one, two, three = cst(1), cst(2), cst(3)

    def delta(v):
        t = mm(v, sb(v, three))
        return mm(t, ad(t, two))

    def nxt(v):
        return torch.roll(v, -1, dims=0)

    a, b, c, d = (wire_ph[w] for w in "abcd")
    an, bn, dn = nxt(a), nxt(b), nxt(d)
    kr, kl, kf, kv = ch["range"], ch["logic"], ch["fixed"], ch["vgadd"]
    beta, gamma = ch["beta"], ch["gamma"]
    jd = cst(quotient.JUBJUB_D)
    c83, c27, c23 = (cst(v) for v in (quotient._C83_6, quotient._C27_2,
                                     quotient._C2_3))
    def p(x, y):  # a product of two challenges: once, not per point
        return dev.mont_mul_plain(x, y, FR)

    # arith
    t = mm(q["q_m"], mm(a, b))
    t = ad(t, mm(q["q_l"], a))
    t = ad(t, mm(q["q_r"], b))
    t = ad(t, mm(q["q_4"], d))
    t = ad(t, mm(q["q_o"], c))
    t = ad(t, q["q_c"])
    gate = ad(mm(q["q_arith"], t), pi_ph)
    # range
    kr2 = p(kr, kr)
    r = delta(sb(c, x4(d)))
    r = ad(r, mm(kr, delta(sb(b, x4(c)))))
    r = ad(r, mm(kr2, delta(sb(a, x4(b)))))
    r = ad(r, mm(p(kr2, kr), delta(sb(dn, x4(a)))))
    gate = ad(gate, mm(mm(kr, q["q_range"]), r))
    # logic
    kl2 = p(kl, kl)
    kl3 = p(kl2, kl)
    qa, qb, qd = sb(an, x4(a)), sb(bn, x4(b)), sb(dn, x4(d))
    g = delta(qa)
    g = ad(g, mm(kl, delta(qb)))
    g = ad(g, mm(kl2, delta(qd)))
    ab = mm(qa, qb)
    g = ad(g, mm(kl3, sb(c, ab)))
    sm = ad(qa, qb)
    sq = sb(mm(sm, sm), x2(ab))
    u = sb(ad(c27, mm(c23, c)), x3(sm))
    u = ad(sb(ad(c83, x3(sq)), mm(c27, sm)), mm(c, u))
    andv = mm(c, u)
    g5 = sb(sb(qd, andv), mm(q["q_c"], sb(sm, x3(andv))))
    g = ad(g, mm(p(kl3, kl), g5))
    gate = ad(gate, mm(mm(kl, q["q_logic"]), g))
    # fixed-base ECC
    kf2 = p(kf, kf)
    k = sb(dn, x2(d))
    k2 = mm(k, k)
    x_t = mm(k, q["q_l"])
    y_t = ad(mm(k2, sb(q["q_r"], one)), one)
    f = mm(k, sb(k2, one))
    f = ad(f, mm(kf, sb(c, mm(k, q["q_c"]))))
    dabc = mm(mm(jd, a), mm(b, c))
    f = ad(f, mm(kf2, sb(ad(an, mm(an, dabc)), ad(mm(a, y_t), mm(b, x_t)))))
    f = ad(f, mm(p(kf2, kf), sb(sb(bn, mm(bn, dabc)),
                                ad(mm(b, y_t), mm(a, x_t)))))
    gate = ad(gate, mm(mm(kf, q["q_fixed"]), f))
    # variable-base ECC add
    v = sb(dn, mm(a, b))
    dp = mm(mm(jd, dn), mm(c, d))
    v = ad(v, mm(kv, sb(ad(an, mm(an, dp)), ad(mm(a, d), mm(b, c)))))
    v = ad(v, mm(p(kv, kv), sb(sb(bn, mm(bn, dp)), ad(mm(b, d), mm(a, c)))))
    gate = ad(gate, mm(mm(kv, q["q_vgadd"]), v))
    # permutation, L1, Z_H^-1
    bx = mm(beta, xpts)
    bx4 = x4(bx)
    bx8 = x2(bx4)
    num = ad(ad(a, bx), gamma)
    for w, kx in ((b, sb(bx8, bx)), (c, ad(ad(bx8, bx4), bx)),
                  (d, ad(x2(bx8), bx))):
        num = mm(num, ad(ad(w, kx), gamma))
    perm = mm(num, z_ph)
    den = None
    for w, s in zip((a, b, c, d), sigma_ph):
        term = ad(ad(w, mm(beta, s)), gamma)
        den = term if den is None else mm(den, term)
    perm = sb(perm, mm(den, nxt(z_ph)))
    total = ad(gate, mm(alpha, perm))
    total = ad(total, mm(p(alpha, alpha), mm(l1_vec, sb(z_ph, one))))
    return mm(total, zh_inv_c)


def test_kernel_algebra_matches_plain():
    """The CUDA kernel's regrouped widgets give the plain version's words
    exactly, with KERNEL_MULS_PER_POINT point-wise multiplies (the count
    behind the kernel's bound in chip_smoke.py), and the k_j it
    multiplies by doublings and adds are the port's K1..K3."""
    n = 37
    args = _port_args(*_inputs(n, 5))
    count = [0]
    got = _kernel_algebra(*args, count)
    assert torch.equal(got, quotient.quotient_phase_plain(*args))
    assert count[0] == quotient.KERNEL_MULS_PER_POINT
    # csrc/quotient.cu multiplies beta x by its constants kK1..kK3 with
    # add chains written for 7, 13, 17
    with open(os.path.join(kernels.CSRC, "quotient.cu")) as f:
        ks = re.search(r"constexpr int kK1 = (\d+), kK2 = (\d+), "
                       r"kK3 = (\d+);", f.read())
    assert tuple(int(v) for v in ks.groups()) == (7, 13, 17)
    assert (tparams.K1, tparams.K2, tparams.K3) == (K1, K2, K3) == (7, 13, 17)


def test_kernel_wrapper_rejects_bad_operands():
    """The kernel's wrapper takes contiguous (n, 8) int32 CUDA tensors
    only; it raises before launching on anything else."""
    args = list(_port_args(*_inputs(8, 4)))
    before = kernels.counts()["quotient_phase"]
    with pytest.raises(ValueError, match="CUDA"):
        quotient.quotient_phase_kernel(*args)
    a = args[0]["a"]
    strided = torch.stack([a, a], dim=1)[:, 0]
    assert not strided.is_contiguous()
    for bad, match in ((strided, "contiguous"),
                       (a[:, :7].contiguous(), "last axis"),
                       (a.to(torch.int64), "int32")):
        wires = dict(args[0], a=bad)
        with pytest.raises((ValueError, TypeError), match=match):
            quotient.quotient_phase_kernel(wires, *args[1:])
    assert kernels.counts()["quotient_phase"] == before
