"""The port's zero-knowledge (blinded) prove on the CPU (plain versions)
against the reference host prover: the 28-gate circuit of
tests/test_blinding_device.py and the golden circuit, byte for byte.
Exercises the 8-phase quotient (8x8 inverse Vandermonde, five chunks),
the rank-1 phase corrections, the host-tracked high coefficients in
commits and evaluations, and the split Ruffini of the openings.

The proves commit through tests/torch_host_commit.py (the reference's
host multi-scalar multiplication over a DeviceCommitter's SRS points):
the same commitments, several times faster at these sizes than the
plain CSR walk, which tests/test_torch_msm.py, test_torch_weighting.py
and the card's smoke run hold.
On the 28-gate circuit one DevicePK serves three proves: a blinded one
with a second seed (it builds the 8-phase tables), the blinded one the
reference also makes (it reuses them) and an unblinded one.  The
reference's proofs of that circuit (seed b"dev-zk", and unblinded),
which tests/test_blinding_device.py also makes, are read from
tests/vectors/blinding_circuit_proof_zk.hex and blinding_circuit_proof.hex,
written once by the reference host prover, rather than proved again
here on every run."""

import os

import pytest
import torch

from tpu_plonk.params import R_MOD, FR_MONT_R
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.cs import Composer as JComposer
from tpu_plonk.pcs import srs as jsrs
from tpu_plonk.proof_system.preprocess import preprocess as jpreprocess
from tpu_plonk.proof_system.prover import prove as jprove

from tpu_plonk_torch.cs import Composer
from tpu_plonk_torch.gadgets import AllocatedScalar, range_check
from tpu_plonk_torch.pcs.commit_device import BLIND_HIGHS, DeviceCommitter
from tpu_plonk_torch.pcs.srs_device import VerifierSRS
from tpu_plonk_torch.proof_system import convert
from tpu_plonk_torch.proof_system.engine_device import (
    DevicePK, prove_device, _resolve_high_g1)
from tpu_plonk_torch.proof_system.preprocess import VerifierKey
from tpu_plonk_torch.proof_system.proof import Proof, BLINDED_PROOF_SIZE
from tpu_plonk_torch.proof_system.verifier import verify

from torch_host_commit import host_commits

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
FIXTURE = os.path.join(VECTORS, "golden_proof_zk.hex")
GOLDEN_SEED = b"golden-zk"


def _small_circuit(cs):
    """tests/test_blinding_device.py:_build_cs, for either package."""
    a = cs.add_input(37)
    b = cs.add_input(21)
    c = cs.mul(1, a, b, 5)
    cs.constrain_to_constant(c, 0, (-782) % R_MOD)
    x = cs.add_input(0b1011)
    y = cs.add_input(0b0110)
    cs.xor_gate(x, y, 4)
    cs.range_gate(cs.add_input(13), 8)
    prev = c
    while cs.n_gates < 28:
        prev = cs.mul(1, prev, prev, 3)
    assert cs.check_satisfied()
    return cs


def _golden_circuit(cs):
    """tests/test_golden_proof.py:_circuit, on the port's composer."""
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


def _port_key(jpk):
    """The reference's ProverKey as the port's (proof_system.convert)."""
    def limbs(vals):
        return jlimbs.fr_to_limbs([v * FR_MONT_R % R_MOD for v in vals])
    return convert.prover_key_from_arrays(
        jpk.n, {k: limbs(v) for k, v in jpk.selector_coeffs.items()},
        [limbs(v) for v in jpk.sigma_coeffs], jpk.wire_vars, device="cpu")


@pytest.fixture(scope="module")
def small():
    jcs = _small_circuit(JComposer())
    n = jcs.padded_size()
    srs = jsrs.cached_setup(n + 8)
    jpk, jvk = jpreprocess(jcs, srs, light=True)
    want = {}
    for seed, name in ((b"dev-zk", "blinding_circuit_proof_zk.hex"),
                       (None, "blinding_circuit_proof.hex")):
        with open(os.path.join(VECTORS, name)) as f:
            want[seed] = bytes.fromhex(f.read().strip())
    cs = _small_circuit(Composer())
    pk = _port_key(jpk)
    dpk = DevicePK(pk)
    host = DeviceCommitter(srs, n + 8, device="cpu")
    with host_commits():
        got = {"other_seed": prove_device(cs, pk, host, dpk=dpk,
                                          device="cpu",
                                          blinding_seed=b"dev-zk-2")}
        tables = dpk.phases(8).static
        got["zk"] = prove_device(cs, pk, host, dpk=dpk, device="cpu",
                                 blinding_seed=b"dev-zk")
        got["reused"] = (tables is not None
                         and dpk.phases(8).static is tables)
        got["plain"] = prove_device(cs, pk, host, dpk=dpk, device="cpu")
    return {"cs": cs, "srs": srs, "pk": pk, "want": want, "got": got,
            "vk": VerifierKey.from_bytes(jvk.to_bytes())}


def test_blinded_matches_reference_host_prover(small):
    data = small["got"]["zk"].to_bytes()
    assert len(data) == BLINDED_PROOF_SIZE
    assert data == small["want"][b"dev-zk"]


def test_blinded_verifies_and_tampering_fails(small):
    proof, vk, vsrs = small["got"]["zk"], small["vk"], VerifierSRS()
    assert verify(proof, vk, small["cs"].pi, vsrs)
    bad = Proof.from_bytes(proof.to_bytes())
    bad.evals["z_shifted"] = (bad.evals["z_shifted"] + 1) % R_MOD
    assert not verify(bad, vk, small["cs"].pi, vsrs)


def test_second_blinded_prove_reuses_phase8_tables(small):
    assert small["got"]["reused"]
    assert small["got"]["zk"].to_bytes() == small["want"][b"dev-zk"]


def test_unblinded_prove_on_the_same_device_pk(small):
    got = small["got"]
    assert got["plain"].to_bytes() == small["want"][None]
    assert got["plain"].to_bytes() != got["zk"].to_bytes()


def test_two_seeds_give_different_proofs(small):
    """The first prove on the DevicePK, with the other seed: it built the
    8-phase tables, and its proof verifies."""
    other = small["got"]["other_seed"]
    assert len(other.to_bytes()) == BLINDED_PROOF_SIZE
    assert other.to_bytes() != small["got"]["zk"].to_bytes()
    assert verify(other, small["vk"], small["cs"].pi, VerifierSRS())


def test_golden_zk_fixture_reference_and_port():
    """The reference host prover still writes golden_proof_zk.hex, and
    the port's blinded CPU proof equals it."""
    with open(FIXTURE) as f:
        golden = f.read().strip()
    jcs = _golden_circuit(JComposer())
    n = jcs.padded_size()
    srs = jsrs.cached_setup(n + 8)
    jpk, _ = jpreprocess(jcs, srs)
    assert jprove(jcs, jpk, srs, blinding_seed=GOLDEN_SEED).to_bytes().hex() \
        == golden
    with host_commits():
        proof = prove_device(_golden_circuit(Composer()), _port_key(jpk),
                             DeviceCommitter(srs, n + 8, device="cpu"),
                             device="cpu", blinding_seed=GOLDEN_SEED)
    assert proof.to_bytes().hex() == golden


def test_resolve_high_g1(small):
    """The high points come off the committer's table and are cached on
    the DevicePK; a committer that cannot supply them raises."""
    srs, n = small["srs"], small["pk"].n
    highs = tuple(srs.powers_g1[n:n + BLIND_HIGHS])
    com = DeviceCommitter(srs, n + 8, device="cpu")
    assert com.high_g1(n) == highs
    dpk = DevicePK(small["pk"])
    assert _resolve_high_g1(dpk, com, n) == highs
    assert _resolve_high_g1(dpk, object(), n) == highs      # cached
    for short in (object(), DeviceCommitter(srs, n + 2, device="cpu")):
        with pytest.raises(ValueError):
            _resolve_high_g1(DevicePK(small["pk"]), short, n)
