"""The port's quotient-phase body (tpu_plonk_torch/proof_system/quotient.py)
on the CPU: its plain version against a pure-Python oracle of the same
body built from the reference's constraint algebra
(tpu_plonk.proof_system.constraints.gate_value plus the permutation, L1
and Z_H^-1 terms of the reference host prover's _quotient_evals), on
seeded random inputs, exactly.  Each phase is self-contained, so the next
row of row i is (i + 1) mod n.  Also: the multiply count behind the
kernel's bound, and the kernel wrapper's operand checks."""

import numpy as np
import pytest
import torch

from tpu_plonk.params import R_MOD, K1, K2, K3
from tpu_plonk.proof_system import constraints as jC

from tpu_plonk_torch import kernels
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
