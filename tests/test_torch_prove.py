"""The port's prover end to end on the CPU (plain versions): the golden
circuit's proof equals tests/vectors/golden_proof.hex byte for byte, the
port's preprocess_device gives the reference's tables and verifier key,
its verifier accepts the proof and rejects a tampered one, and
proof_system.convert round-trips the reference's ProverKey.

The golden circuit is preprocessed through preprocess_device_cached in a
temporary directory, a miss (preprocess_device) and then a hit; the
proof is made from the hit's key.  Commits go through
tests/torch_host_commit.py (the host MSM over the committer's table):
the plain CSR walk that the committer runs on the CPU is held against
the reference's host MSM by tests/test_torch_msm.py and
test_torch_weighting.py, and on the card by chip_smoke.py."""

import copy
import os

import numpy as np
import torch
import pytest

from tpu_plonk.params import R_MOD, FR_MONT_R
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.pcs import srs as jsrs
from tpu_plonk.pcs import msm_csr as jmsm_csr
from tpu_plonk.proof_system import preprocess as jpre

from tpu_plonk_torch.cs import Composer
from tpu_plonk_torch.gadgets import AllocatedScalar, range_check
from tpu_plonk_torch.curves import device_g1 as tdg1
from tpu_plonk_torch.pcs.commit_device import DeviceCommitter
from tpu_plonk_torch.pcs.srs_device import VerifierSRS
from tpu_plonk_torch.proof_system import convert
from tpu_plonk_torch.proof_system.preprocess import (
    cache_path, circuit_fingerprint, preprocess_device_cached)
from tpu_plonk_torch.proof_system.engine_device import prove_device
from tpu_plonk_torch.proof_system.proof import Proof
from tpu_plonk_torch.proof_system.verifier import verify

from torch_host_commit import host_commits

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "vectors",
                       "golden_proof.hex")


def _golden_circuit():
    """tests/test_golden_proof.py's circuit, on the port's composer."""
    cs = Composer()
    a = cs.add_input(1234)
    b = cs.add_input(5678)
    c = cs.mul(1, a, b, 7)
    cs.constrain_to_constant(c, 0, (-(1234 * 5678 + 7)) % R_MOD)
    w = AllocatedScalar.allocate(cs, 4242)
    range_check(cs, 1000, 10000, w)
    x = cs.add_input(0b1010)
    y = cs.add_input(0b0111)
    cs.xor_gate(x, y, 4)
    return cs


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    cs = _golden_circuit()
    n = cs.padded_size()
    srs = jsrs.cached_setup(n + 8)
    committer = DeviceCommitter(srs, n + 8, device="cpu")
    cache = str(tmp_path_factory.mktemp("preprocess_cache"))
    with host_commits():
        miss = preprocess_device_cached(cs, committer, cache, device="cpu")
        pk, vk = preprocess_device_cached(cs, committer, cache,
                                          device="cpu")
        proof = prove_device(cs, pk, committer, device="cpu")
    jpk, jvk = jpre.preprocess(cs, srs, light=True)
    return {"cs": cs, "srs": srs, "pk": pk, "vk": vk, "proof": proof,
            "miss": miss, "cache": cache, "jpk": jpk, "jvk": jvk}


def _mont_limbs(vals):
    return jlimbs.fr_to_limbs([v * FR_MONT_R % R_MOD for v in vals])


def test_golden_proof_bytes(golden):
    with open(FIXTURE) as f:
        assert golden["proof"].to_bytes().hex() == f.read().strip()


def test_verifier_accepts_and_rejects_tampered(golden):
    cs, vk, proof = golden["cs"], golden["vk"], golden["proof"]
    vsrs = VerifierSRS()
    assert verify(proof, vk, cs.pi, vsrs)
    bad = Proof.from_bytes(proof.to_bytes())
    bad.evals["a"] = (bad.evals["a"] + 1) % R_MOD
    assert not verify(bad, vk, cs.pi, vsrs)


def test_preprocess_matches_reference(golden):
    pk, jpk = golden["pk"], golden["jpk"]
    assert golden["miss"][1].to_bytes() == golden["jvk"].to_bytes()
    sel, sig = convert.prover_key_to_arrays(pk)
    for name, coeffs in jpk.selector_coeffs.items():
        assert np.array_equal(sel[name], _mont_limbs(coeffs)), name
    for got, coeffs in zip(sig, jpk.sigma_coeffs):
        assert np.array_equal(got, _mont_limbs(coeffs))
    assert pk.wire_vars == jpk.wire_vars


def test_preprocess_cache_hit_equals_miss(golden):
    """One entry, named by the circuit's fingerprint; the hit's tensors
    and key bytes are the miss's."""
    (mpk, mvk), pk, vk = golden["miss"], golden["pk"], golden["vk"]
    fp = circuit_fingerprint(golden["cs"])
    assert os.listdir(golden["cache"]) == [f"torch_ppdev_{fp}.npz"]
    assert cache_path(golden["cs"], golden["cache"]) == os.path.join(
        golden["cache"], f"torch_ppdev_{fp}.npz")
    assert vk.to_bytes() == mvk.to_bytes()
    assert (pk.n, pk.wire_vars) == (mpk.n, mpk.wire_vars)
    assert list(pk.selector_coeffs) == list(mpk.selector_coeffs)
    for name, coeffs in mpk.selector_coeffs.items():
        assert torch.equal(pk.selector_coeffs[name], coeffs), name
    assert all(torch.equal(a, b)
               for a, b in zip(pk.sigma_coeffs, mpk.sigma_coeffs))
    assert len(pk.sigma_coeffs) == 4


def test_circuit_fingerprint_matches_reference(golden):
    """The reference's hash of the same structure; one selector changes
    it, a witness value does not."""
    cs = golden["cs"]
    fp = circuit_fingerprint(cs)
    assert fp == jpre.circuit_fingerprint(cs)
    other = copy.deepcopy(cs)
    other.q["q_c"][0] = (other.q["q_c"][0] + 1) % R_MOD
    assert circuit_fingerprint(other) != fp
    other = copy.deepcopy(cs)
    other.witness[1] = (other.witness[1] + 1) % R_MOD
    assert circuit_fingerprint(other) == fp


def test_convert_roundtrips_reference_key_and_srs(golden):
    srs, jpk = golden["srs"], golden["jpk"]
    sel = {k: _mont_limbs(v) for k, v in jpk.selector_coeffs.items()}
    sig = [_mont_limbs(v) for v in jpk.sigma_coeffs]
    pk = convert.prover_key_from_arrays(jpk.n, sel, sig, jpk.wire_vars,
                                        device="cpu")
    sel2, sig2 = convert.prover_key_to_arrays(pk)
    assert all(np.array_equal(sel2[k], sel[k]) for k in sel)
    assert all(np.array_equal(a, b) for a, b in zip(sig2, sig))
    packed = np.asarray(jmsm_csr.pack_points(srs.powers_g1[:16]))
    table = convert.srs_from_packed(packed, device="cpu")
    assert tdg1.affine_from_device(table) == srs.powers_g1[:16]
