"""The port's host circuit layer and circuit API against the reference,
on the CPU: the MockCircuit (selectors, wires, witness, PI and gate
count, and the insufficient-balance case), Schnorr (signatures, verify
results, the verify gadgets' composers), the `Circuit` API,
`verify_proof` and `gadget_tester` on the FactorCircuit of
tests/test_circuit_api.py (verifier key and proof bytes equal the
reference's, which tests/vectors/factor_circuit.{vk,proof} hold:
written once by the reference's `Circuit.compile` / `gen_proof`, as
tests/test_circuit_api.py runs them, rather than made again here on
every run; the same rejection cases), and the port's host SRS cache,
which never reads the reference's pickles.

The port's proves here commit through tests/torch_host_commit.py (the
host MSM over the committer's table: the same points as the plain CSR
walk, which tests/test_torch_msm.py and test_torch_weighting.py
hold)."""

import os

import pytest
import torch

from tpu_plonk.params import R_MOD
from tpu_plonk.circuits.mock_circuit import build_mock_circuit as jmock
from tpu_plonk import cs as jcs
from tpu_plonk.gadgets import schnorr as jschnorr
from tpu_plonk.pcs import srs as jsrs

from tpu_plonk_torch import circuits as tcircuits
from tpu_plonk_torch.circuits.mock_circuit import build_mock_circuit
from tpu_plonk_torch import cs as tcs
from tpu_plonk_torch.gadgets import schnorr
from tpu_plonk_torch.pcs import srs as tsrs

from torch_host_commit import host_commits

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _structure(cs):
    return (cs.n_gates, cs.padded_size(), cs.q, cs.wires, cs.witness, cs.pi)


@pytest.mark.parametrize("args,satisfied", [
    ((10_000, 0xDEADBEEF, [1, 2, 3, 4], 7_000, 500), True),
    ((100, 5, [1], 7_000, 500), False)],
    ids=["cli_circuit", "insufficient_balance"])
def test_mock_circuit_matches_reference(args, satisfied):
    """tests/test_mock_circuit.py's circuits: the CLI's, and a note worth
    less than the transaction (the enforced balance check fails)."""
    cs, public = build_mock_circuit(*args)
    want, want_public = jmock(*args)
    assert cs.check_satisfied() is satisfied
    assert want.check_satisfied() is satisfied
    assert public == want_public
    assert _structure(cs) == _structure(want)


@pytest.mark.parametrize("double", [False, True], ids=["single", "double"])
def test_schnorr_signatures_match_reference(double):
    """tests/test_schnorr.py's native cases in both packages: the same
    keys and signatures, the same verify results."""
    def cases(mod):
        if not double:
            sk, pk = mod.keygen(0x5EC12E7)
            sig = mod.sign(sk, message=42)
            R, s = sig
            _, pk2 = mod.keygen(0xBAD)
            return (pk, sig, [mod.verify(pk, 42, sig), mod.verify(pk, 43, sig),
                              mod.verify(pk, 42, (R, s + 1)),
                              mod.verify(pk2, 42, sig)])
        sk, pk, pk2 = mod.keygen_double(0xD0B1E)
        sig = mod.sign_double(sk, message=99)
        R, Rp, s = sig
        _, _, pk2_bad = mod.keygen_double(0xBAD)
        return ((pk, pk2), sig, [
            mod.verify_double(pk, pk2, 99, sig),
            mod.verify_double(pk, pk2, 98, sig),
            mod.verify_double(pk, pk2, 99, (R, Rp, s + 1)),
            mod.verify_double(pk, pk2_bad, 99, sig)])
    got = cases(schnorr)
    assert got == cases(jschnorr)
    assert got[2] == [True, False, False, False]


def _gadget_composer(mod, cs_mod, double: bool, tamper: bool):
    """tests/test_schnorr.py's gadget cases on either package: the
    composer and whether it is satisfied (a bad signature may also trip
    an assertion while the gadget is built)."""
    cs = cs_mod.Composer()
    if double:
        sk, pk, pk2 = mod.keygen_double(31337)
        R, Rp, s = mod.sign_double(sk, message=777)
        pkv = cs_mod.PointVar(cs.add_input(pk[0]), cs.add_input(pk[1]), pk)
        pk2v = cs_mod.PointVar(cs.add_input(pk2[0]), cs.add_input(pk2[1]),
                               pk2)
        build = lambda: mod.verify_double_gadget(  # noqa: E731
            cs, pkv, pk2v, (R, Rp, s + tamper), 777)
    else:
        sk, pk = mod.keygen(7777)
        R, s = mod.sign(sk, message=1234)
        pkv = cs_mod.PointVar(cs.add_input(pk[0]), cs.add_input(pk[1]), pk)
        build = lambda: mod.verify_gadget(  # noqa: E731
            cs, pkv, (R, s + tamper), 1234)
    try:
        build()
        satisfied = cs.check_satisfied()
    except AssertionError:
        return None, False
    return _structure(cs), satisfied


@pytest.mark.parametrize("double", [False, True], ids=["single", "double"])
@pytest.mark.parametrize("tamper", [False, True], ids=["good", "bad_sig"])
def test_schnorr_gadgets_match_reference(double, tamper):
    got = _gadget_composer(schnorr, tcs, double, tamper)
    assert got == _gadget_composer(jschnorr, jcs, double, tamper)
    assert got[1] is not tamper


def _factor_circuit(base):
    class FactorCircuit(base.Circuit):
        """tests/test_circuit_api.py's: knowledge of p, q with p q = n
        for a public n (gate-form PI = -n)."""

        def __init__(self, p, q):
            self.p, self.q = p, q

        def gadget(self, composer):
            a = composer.add_input(self.p)
            b = composer.add_input(self.q)
            c = composer.mul(1, a, b, 0)
            composer.constrain_to_constant(
                c, 0, (-(self.p * self.q)) % R_MOD)
    return FactorCircuit(31, 41)


@pytest.fixture(scope="module")
def factor():
    """Compile the (31, 41) circuit once and prove it with the label
    b"factors"; then prove the witness (7, 2003) on the same keys with
    the default label."""
    want = {}
    for ext in ("vk", "proof"):
        with open(os.path.join(os.path.dirname(__file__), "vectors",
                               f"factor_circuit.{ext}"), "rb") as f:
            want[ext] = f.read()
    circ = _factor_circuit(tcircuits)
    srs = tsrs.cached_setup(circ.padded_gates() + 8)
    with host_commits():
        pk, vd = circ.compile(srs, device="cpu")
        proofs = [circ.gen_proof(srs, pk, b"factors", device="cpu")]
        pis = [circ.public_inputs()]
        circ.p, circ.q = 7, 2003
        proofs.append(circ.gen_proof(srs, pk, device="cpu"))
        pis.append(circ.public_inputs())
    return {"srs": srs, "vd": vd, "proofs": proofs, "pis": pis,
            "want": want}


def test_circuit_compile_prove_verify(factor):
    vd, srs = factor["vd"], factor["srs"]
    proof, pi = factor["proofs"][0], factor["pis"][0]
    assert isinstance(vd, tcircuits.VerifierData)
    assert vd.pi_pos == [4]             # the reference's VerifierData
    assert vd.key.to_bytes() == factor["want"]["vk"]
    assert proof.to_bytes() == factor["want"]["proof"]
    assert pi == [(-(31 * 41)) % R_MOD]
    assert tcircuits.verify_proof(proof, vd, pi, srs, b"factors")
    # wrong public input, wrong arity, wrong label -> reject
    assert not tcircuits.verify_proof(proof, vd, [(-1272) % R_MOD], srs,
                                      b"factors")
    assert not tcircuits.verify_proof(proof, vd, [], srs, b"factors")
    assert not tcircuits.verify_proof(proof, vd, pi, srs, b"other-label")


def test_circuit_reprove_new_witness(factor):
    """dusk trait semantics: the instance IS the witness; a new witness
    proves against the SAME keys."""
    proof, pi = factor["proofs"][1], factor["pis"][1]
    assert pi == [(-(7 * 2003)) % R_MOD]
    assert tcircuits.verify_proof(proof, factor["vd"], pi, factor["srs"])


def _good(cs):
    x = cs.add_input(9)
    y = cs.add_input(3)
    s = cs.add((1, x), (1, y), 0)
    cs.constrain_to_constant(s, 12)


def _bad(cs):
    # unsatisfied witness: 9 + 4 != 12 constant gate
    x = cs.add_input(9)
    y = cs.add_input(4)
    s = cs.add((1, x), (1, y), 0)
    cs.constrain_to_constant(s, 12)


@pytest.mark.parametrize("gadget,ok", [(_good, True), (_bad, False)],
                         ids=["satisfied", "unsatisfied"])
def test_gadget_tester_positive_negative(gadget, ok):
    """tests/test_circuit_api.py's cases: the satisfied gadget's proof
    verifies, the unsatisfied one is refused."""
    with host_commits():
        assert tcircuits.gadget_tester(gadget, device="cpu") is ok


def test_gadget_tester_does_not_prove_an_unsatisfied_witness(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("gadget_tester preprocessed an unsatisfied "
                             "circuit")
    from tpu_plonk_torch.circuits import circuit
    monkeypatch.setattr(circuit, "preprocess_device", refuse)
    monkeypatch.setattr(circuit, "prove_device", refuse)
    assert tcircuits.gadget_tester(_bad, device="cpu") is False


def test_srs_cache_never_reads_the_reference_pickle(tmp_path, monkeypatch):
    """The port's pickles have their own name: the reference's
    `srs_{size}.pkl` in the same directory (here a file that is no
    pickle at all) is never opened, and the port's pickle names only the
    port's classes."""
    monkeypatch.setattr(tsrs, "_CACHE_DIR", str(tmp_path))
    (tmp_path / "srs_16.pkl").write_bytes(b"the reference's, not a pickle")
    opened = []

    def recording_open(path, *a, **k):
        opened.append(os.path.basename(path))
        return open(path, *a, **k)
    monkeypatch.setattr(tsrs, "open", recording_open, raising=False)
    first = tsrs.cached_setup(8)                  # a miss: writes size 16
    again = tsrs.cached_setup(8)                  # a hit
    assert "srs_16.pkl" not in opened
    assert sorted(os.listdir(tmp_path)) == ["srs_16.pkl", "torch_srs_16.pkl"]
    want = jsrs.setup(15)
    assert first.powers_g1 == again.powers_g1 == want.powers_g1[:9]
    assert (again.g2_gen, again.g2_tau) == (want.g2_gen, want.g2_tau)
    data = (tmp_path / "torch_srs_16.pkl").read_bytes()
    assert b"tpu_plonk_torch.pcs.srs" in data
    assert b"tpu_plonk.pcs" not in data
