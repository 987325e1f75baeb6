"""The quotient-phase body (mirrors tpu_plonk/proof_system/quotient_pallas.py):
at every point of one interleaved size-n coset s_i*H, the gate
constraint (arith, range, logic, fixed-base and variable-base ECC
widgets), the permutation term, the L1 term and the Z_H^-1 scale.

`quotient_phase_kernel` launches csrc/quotient.cu (K6's port) on CUDA
tensors; `quotient_phase_plain` computes the same in plain torch on the
plain field ops, on any device, in the reference kernel's order of
operations.  The CUDA kernel regroups some widgets' algebra to do fewer
multiplies (its source note lists how); both read the next row at
(j + 1) mod n (each phase is self-contained: index j+P on the P-phase
coset is one step further in j on the same phase).  Montgomery values
are canonical and the field ops exact, so the two agree bit for bit.

Arguments, as engine_device passes them: wire_ph {a,b,c,d}, z_ph, pi_ph,
sel_ph {name: values}, sigma_ph [4], xpts and l1_vec, each (n, 8)
Montgomery words; alpha, ch {beta, gamma, range, logic, fixed, vgadd}
and zh_inv_c (1, 8) Montgomery scalars.
"""

import ctypes
import functools

import torch

from ..params import K1, K2, K3, JUBJUB_D
from ..fields import device as dev
from .. import kernels as K
from .constraints import _C83_6, _C27_2, _C2_3

FR = dev.FR

#: selector order of the kernel's inputs (reference _SEL_ORDER)
SEL_ORDER = ("q_m", "q_l", "q_r", "q_o", "q_4", "q_c", "q_arith",
             "q_range", "q_logic", "q_fixed", "q_vgadd")
#: the kernel's inputs, in csrc/quotient.cu's `In` order
IN_NAMES = ("a", "b", "c", "d", "z", "pi") + SEL_ORDER + (
    "sigma1", "sigma2", "sigma3", "sigma4", "xpts", "l1")
#: constant-table rows (the reference's _COLS less its k1..k3, which
#: csrc/quotient.cu holds as constants): Montgomery form except the
#: modulus and -q^-1, which the reference's REDC reads
COLS = ("mod", "ninv", "one", "beta", "gamma", "alpha",
        "kr", "kl", "kf", "kv", "zh_inv",
        "jubjub_d", "c83_6", "c27_2", "c2_3")
#: Fr multiplies per point with a point-dependent operand in
#: quotient_phase_plain (products of two challenges are made once)
MULS_PER_POINT = 107
#: the same in the CUDA kernel, whose regrouped algebra needs fewer: the
#: least the function needs as far as this port knows, so the kernel's
#: bound counts these
KERNEL_MULS_PER_POINT = 89

_QUOTIENT = K.Kernel("quotient_phase", "tpk_quotient_phase",
                     [K.P, K.P, K.P, K.I64])


@functools.lru_cache(maxsize=None)
def _static_rows(device: str) -> torch.Tensor:
    """(15, 8) table with the circuit-independent rows filled."""
    t = torch.zeros(len(COLS), FR.n_words, dtype=torch.int32)
    t[0] = torch.from_numpy(FR.words(FR.modulus))
    t[1] = torch.from_numpy(FR.words(
        (-pow(FR.modulus, -1, FR.mont_r)) % FR.mont_r))
    for name, v in (("one", 1), ("jubjub_d", JUBJUB_D), ("c83_6", _C83_6),
                    ("c27_2", _C27_2), ("c2_3", _C2_3)):
        t[COLS.index(name)] = FR.const(v, "cpu")[0]
    return t.to(device)


def const_table(alpha, ch, zh_inv_c) -> torch.Tensor:
    """The (15, 8) constant table on the challenges' device, assembled
    there from the (1, 8) challenge tensors (no host round trip)."""
    st = _static_rows(str(alpha.device))
    dyn = [ch["beta"], ch["gamma"], alpha, ch["range"], ch["logic"],
           ch["fixed"], ch["vgadd"], zh_inv_c]
    return torch.cat([st[:3]] + [x.reshape(1, -1) for x in dyn] + [st[11:]])


def quotient_phase_kernel(wire_ph, z_ph, pi_ph, sel_ph, sigma_ph, xpts,
                          alpha, ch, zh_inv_c, l1_vec):
    """t evaluations over one phase coset by the CUDA kernel."""
    ins = ([wire_ph[w] for w in "abcd"] + [z_ph, pi_ph]
           + [sel_ph[k] for k in SEL_ORDER] + list(sigma_ph)
           + [xpts, l1_vec])
    n = ins[0].shape[0]
    for name, t in zip(IN_NAMES, ins):
        K.check_words(t, FR.n_words, f"quotient_phase {name}")
        if t.shape != (n, FR.n_words) or t.device != ins[0].device:
            raise ValueError(f"quotient_phase {name}: expected ({n}, 8) on "
                             f"{ins[0].device}, got {tuple(t.shape)} on "
                             f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"quotient_phase {name}: the kernel loads 16 "
                             f"bytes at a time; the tensor must be 16-byte "
                             f"aligned")
    table = const_table(alpha, ch, zh_inv_c)
    K.check_words(table, FR.n_words, "quotient_phase constants")
    if table.shape != (len(COLS), FR.n_words) or \
            table.device != ins[0].device:
        raise ValueError("quotient_phase: constants must be (1, 8) tensors "
                         "on the inputs' device")
    out = torch.empty((n, FR.n_words), dtype=torch.int32,
                      device=ins[0].device)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    _QUOTIENT(ctypes.addressof(ptrs), table.data_ptr(), out.data_ptr(), n)
    return out


def quotient_phase_plain(wire_ph, z_ph, pi_ph, sel_ph, sigma_ph, xpts,
                         alpha, ch, zh_inv_c, l1_vec):
    """The kernel's computation in plain torch, step for step."""
    def mm(x, y):
        return dev.mont_mul_plain(x, y, FR)

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
        return FR.const(v, xpts.device)

    one = cst(1)

    def delta(v):
        two = x2(one)
        three = ad(two, one)
        return mm(mm(v, sb(v, one)), mm(sb(v, two), sb(v, three)))

    def nxt(v):
        return torch.roll(v, -1, dims=0)

    q = sel_ph
    a, b, c, d = (wire_ph[w] for w in "abcd")
    an, bn, dn = nxt(a), nxt(b), nxt(d)
    kr, kl, kf, kv = ch["range"], ch["logic"], ch["fixed"], ch["vgadd"]
    beta, gamma = ch["beta"], ch["gamma"]
    jd = cst(JUBJUB_D)

    # --- arith ---
    t = mm(q["q_m"], mm(a, b))
    t = ad(t, mm(q["q_l"], a))
    t = ad(t, mm(q["q_r"], b))
    t = ad(t, mm(q["q_4"], d))
    t = ad(t, mm(q["q_o"], c))
    t = ad(t, q["q_c"])
    gate = ad(mm(q["q_arith"], t), pi_ph)

    # --- range ---
    kr2 = mm(kr, kr)
    r = delta(sb(c, x4(d)))
    r = ad(r, mm(kr, delta(sb(b, x4(c)))))
    r = ad(r, mm(kr2, delta(sb(a, x4(b)))))
    r = ad(r, mm(mm(kr2, kr), delta(sb(dn, x4(a)))))
    gate = ad(gate, mm(mm(kr, q["q_range"]), r))

    # --- logic ---
    kl2 = mm(kl, kl)
    kl3 = mm(kl2, kl)
    qa, qb, qd = sb(an, x4(a)), sb(bn, x4(b)), sb(dn, x4(d))
    g = delta(qa)
    g = ad(g, mm(kl, delta(qb)))
    g = ad(g, mm(kl2, delta(qd)))
    g = ad(g, mm(kl3, sb(c, mm(qa, qb))))
    sm = ad(qa, qb)
    sq = ad(mm(qa, qa), mm(qb, qb))
    w2 = mm(c, c)
    andv = sb(ad(ad(mm(cst(_C83_6), c), x3(mm(c, sq))),
                 ad(mm(cst(_C27_2), w2), mm(cst(_C2_3), mm(w2, c)))),
              ad(mm(mm(cst(_C27_2), c), sm), x3(mm(w2, sm))))
    qc = q["q_c"]
    g5 = sb(qd, ad(mm(qc, sm), mm(sb(one, x3(qc)), andv)))
    g = ad(g, mm(mm(kl3, kl), g5))
    gate = ad(gate, mm(mm(kl, q["q_logic"]), g))

    # --- fixed-base ECC ---
    kf2 = mm(kf, kf)
    k = sb(dn, x2(d))
    x_t = mm(k, q["q_l"])
    y_t = ad(mm(mm(k, k), sb(q["q_r"], one)), one)
    f = mm(mm(k, sb(k, one)), ad(k, one))
    f = ad(f, mm(kf, sb(c, mm(k, qc))))
    dabc = mm(mm(jd, a), mm(b, c))
    f = ad(f, mm(kf2, sb(ad(an, mm(an, dabc)),
                         ad(mm(a, y_t), mm(b, x_t)))))
    f = ad(f, mm(mm(kf2, kf), sb(sb(bn, mm(bn, dabc)),
                                 ad(mm(b, y_t), mm(a, x_t)))))
    gate = ad(gate, mm(mm(kf, q["q_fixed"]), f))

    # --- variable-base ECC add ---
    v = sb(dn, mm(a, b))
    dp = mm(mm(jd, dn), mm(c, d))
    v = ad(v, mm(kv, sb(ad(an, mm(an, dp)), ad(mm(a, d), mm(b, c)))))
    v = ad(v, mm(mm(kv, kv), sb(sb(bn, mm(bn, dp)),
                                ad(mm(b, d), mm(a, c)))))
    gate = ad(gate, mm(mm(kv, q["q_vgadd"]), v))

    # --- permutation, L1, Z_H^-1 ---
    num = ad(ad(a, mm(beta, xpts)), gamma)
    for w, kj in ((b, K1), (c, K2), (d, K3)):
        num = mm(num, ad(ad(w, mm(mm(beta, cst(kj)), xpts)), gamma))
    perm = mm(num, z_ph)
    den = None
    for w, s in zip((a, b, c, d), sigma_ph):
        term = ad(ad(w, mm(beta, s)), gamma)
        den = term if den is None else mm(den, term)
    perm = sb(perm, mm(den, nxt(z_ph)))
    total = ad(gate, mm(alpha, perm))
    total = ad(total, mm(mm(alpha, alpha), mm(l1_vec, sb(z_ph, one))))
    return mm(total, zh_inv_c)
