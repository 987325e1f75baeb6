"""The port's prover on the every-widget circuit of
tests/test_engine_device.py (arith, PI, range, logic, fixed- and
variable-base ECC, copy constraints), fed the reference's own
ProverKey through proof_system.convert: proof bytes equal the reference
host prover's (which that file holds equal to its device engine), as
tests/vectors/mixed_proof.hex holds them: written once by the
reference's `proof_system.prover.prove` on this circuit, rather than
proved again here on every run.
The port's prove commits through tests/torch_host_commit.py: the plain
CSR walk is held by tests/test_torch_msm.py and
test_torch_weighting.py."""

import os

import torch

from tpu_plonk.params import R_MOD, FR_MONT_R
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.cs import Composer as JComposer
from tpu_plonk.pcs import srs as jsrs
from tpu_plonk.proof_system.preprocess import preprocess as jpreprocess

from tpu_plonk_torch import cs as tcs
from tpu_plonk_torch import gadgets as tgadgets
from tpu_plonk_torch.curves import jubjub as tjubjub
from tpu_plonk_torch.pcs.commit_device import DeviceCommitter
from tpu_plonk_torch.pcs.srs_device import VerifierSRS
from tpu_plonk_torch.proof_system import convert
from tpu_plonk_torch.proof_system.engine_device import prove_device
from tpu_plonk_torch.proof_system.preprocess import VerifierKey
from tpu_plonk_torch.proof_system.verifier import verify

from torch_host_commit import host_commits

FIXTURE = os.path.join(os.path.dirname(__file__), "vectors",
                       "mixed_proof.hex")

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def mixed_circuit(cs_mod, gadgets, jubjub):
    """tests/test_engine_device.py:_mixed_circuit for either package."""
    cs = cs_mod.Composer()
    a = cs.add_input(37)
    b = cs.add_input(21)
    c = cs.mul(1, a, b, 5)
    cs.constrain_to_constant(c, 0, (-782) % R_MOD)
    w = gadgets.AllocatedScalar.allocate(cs, 999)
    gadgets.range_check(cs, 100, 2000, w)
    x = cs.add_input(0b1011)
    y = cs.add_input(0b0110)
    cs.xor_gate(x, y, 4)
    k = cs.add_input(0xABCDEF)
    p = cs.fixed_base_scalar_mul(k, jubjub.GENERATOR)
    q_pt = jubjub.mul(jubjub.GENERATOR, 3)
    qv = cs_mod.PointVar(cs.add_input(q_pt[0]), cs.add_input(q_pt[1]), q_pt)
    cs.point_addition_gate(p, qv)
    assert cs.check_satisfied()
    return cs


def _mont_limbs(vals):
    return jlimbs.fr_to_limbs([v * FR_MONT_R % R_MOD for v in vals])


def test_mixed_circuit_matches_reference_prover():
    import tpu_plonk.cs as jcs
    import tpu_plonk.gadgets as jgadgets
    from tpu_plonk.curves import jubjub as jjubjub
    jcs_circ = mixed_circuit(jcs, jgadgets, jjubjub)
    assert isinstance(jcs_circ, JComposer)
    n = jcs_circ.padded_size()
    srs = jsrs.cached_setup(n + 8)
    jpk, jvk = jpreprocess(jcs_circ, srs, light=True)
    with open(FIXTURE) as f:
        want = bytes.fromhex(f.read().strip())

    cs = mixed_circuit(tcs, tgadgets, tjubjub)
    pk = convert.prover_key_from_arrays(
        n, {k: _mont_limbs(v) for k, v in jpk.selector_coeffs.items()},
        [_mont_limbs(v) for v in jpk.sigma_coeffs], jpk.wire_vars,
        device="cpu")
    committer = DeviceCommitter(srs, n + 8, device="cpu")
    with host_commits():
        proof = prove_device(cs, pk, committer, device="cpu")
    assert proof.to_bytes() == want
    vk = VerifierKey.from_bytes(jvk.to_bytes())
    assert verify(proof, vk, cs.pi, VerifierSRS())
