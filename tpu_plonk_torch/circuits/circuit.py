"""`Circuit` authoring API (mirrors tpu_plonk/circuits/circuit.py, the
dusk-plonk 0.8.2 `Circuit` trait analog): the user-facing surface the
`MockCircuit` is written against.

  * `Circuit.gadget(composer)` — subclass hook appending gates; witness
    values live on the instance.
  * `Circuit.compile(srs)` — fresh composer -> preprocess_device ->
    `(ProverKey, VerifierData)`; `VerifierData` carries the
    `VerifierKey` plus the public-input gate positions recorded at
    compile time (dusk's `VerifierData { key, pi_pos }`).
  * `Circuit.gen_proof(srs, pk, label)` — rebuild + prove_device.
  * `verify_proof(...)` — zips caller-supplied PI values (gate form,
    i.e. exactly what was passed to the gate builders) with the
    compiled positions and runs the host verifier.

`compile` and `gen_proof` run on `device` (the card unless the caller
names another, e.g. "cpu" for the plain versions) and commit through a
DeviceCommitter over all the G1 powers of the `srs` passed in (a host
SRS, e.g. `pcs.srs.cached_setup(circuit.padded_gates() + 8)`).

`gadget_tester` is dusk-plonk's own test idiom: run the FULL pipeline
(compose -> preprocess -> prove -> verify) over a gadget closure.
"""

import dataclasses

from ..params import R_MOD
from ..cs import Composer
from ..pcs import srs as srs_mod
from ..pcs.commit_device import DeviceCommitter
from ..proof_system.preprocess import preprocess_device
from ..proof_system.engine_device import prove_device
from ..proof_system.verifier import verify
from ..transcript import labels as L


@dataclasses.dataclass
class VerifierData:
    """VerifierKey + public-input positions (dusk `VerifierData`)."""
    key: object                 # preprocess_device() VerifierKey
    pi_pos: list                # sorted gate indices carrying PI


def _committer(srs, device):
    return DeviceCommitter(srs, len(srs.powers_g1), device)


class Circuit:
    """Subclass and implement `gadget(composer)`.

    The default `compile`/`gen_proof` build a fresh composer per call
    (dusk's trait semantics: the struct IS the witness; proving twice
    with different field values just works)."""

    def gadget(self, composer: Composer) -> None:
        raise NotImplementedError

    def build(self) -> Composer:
        cs = Composer()
        self.gadget(cs)
        return cs

    def padded_gates(self) -> int:
        """Power-of-two domain size of the compiled circuit (dusk
        `Circuit::padded_gates`)."""
        return self.build().padded_size()

    def compile(self, srs, device=None):
        """-> (ProverKey, VerifierData), preprocessed on `device`.  The
        reference's `light=` is gone: the port never builds the host
        4n extended-coset tables that it skips."""
        cs = self.build()
        pk, vk = preprocess_device(cs, _committer(srs, device), device)
        return pk, VerifierData(vk, sorted(cs.pi))

    def gen_proof(self, srs, pk, label: bytes = L.PROTOCOL,
                  blinding_seed: bytes = None, device=None):
        cs = self.build()
        return prove_device(cs, pk, _committer(srs, device), label,
                            device=device, blinding_seed=blinding_seed)

    def public_inputs(self) -> list:
        """PI values in gate order (the `pi_values` argument of
        `verify_proof`), extracted from a fresh build."""
        cs = self.build()
        return [cs.pi[i] for i in sorted(cs.pi)]


def verify_proof(proof, verifier_data: VerifierData, pi_values, srs,
                 label: bytes = L.PROTOCOL) -> bool:
    """Free verification function (dusk `circuit::verify_proof`):
    `pi_values` are the gate-form public-input scalars in position
    order; positions come from compile-time `VerifierData`.  `srs` needs
    only the two G2 points (a host SRS or srs_device.VerifierSRS)."""
    if len(pi_values) != len(verifier_data.pi_pos):
        return False
    pi = {pos: int(v) % R_MOD for pos, v in
          zip(verifier_data.pi_pos, pi_values)}
    return verify(proof, verifier_data.key, pi, srs, label)


def gadget_tester(gadget_fn, label: bytes = b"gadget-tester",
                  srs=None, device=None) -> bool:
    """dusk-plonk's per-gadget integration idiom: compose the gadget,
    preprocess, prove, verify on `device`; returns whether the proof
    verifies (callers assert True for sound witnesses, False for
    unsatisfied ones).  An unsatisfied witness is reported as False
    without proving."""
    cs = Composer()
    gadget_fn(cs)
    if not cs.check_satisfied():
        return False
    if srs is None:
        srs = srs_mod.cached_setup(cs.padded_size() + 8)
    committer = _committer(srs, device)
    pk, vk = preprocess_device(cs, committer, device)
    proof = prove_device(cs, pk, committer, label, device=device)
    return verify(proof, vk, cs.pi, srs, label)
