"""MockCircuit: the reference's payment-note circuit
(src/zk/circuits.rs:26-73), built on the gadget layer.

Reference quirks handled per SURVEY.md §2.3:
  - circuits.rs:58 calls `.into()` on a bare Variable, which cannot
    supply the witness value (the crate does not compile as-is); here
    `valid_balance` takes the AllocatedScalar the code clearly intended.
  - circuits.rs:59 drops the min_bound indicator, making the balance
    check advisory; we implement the intended semantics and constrain
    the indicator to 1 (`enforce=True`, the default) while keeping the
    literal advisory behavior available (`enforce=False`).
"""

from ..params import R_MOD
from ..cs import Composer
from ..curves import jubjub
from ..gadgets import AllocatedScalar, min_bound
from ..gadgets import poseidon


class MockCircuit:
    def __init__(self, note_value: AllocatedScalar, private_key: AllocatedScalar,
                 hash_inputs, public_key):
        """note_value/private_key: AllocatedScalar; hash_inputs: list of
        witness variables; public_key: affine JubJub point
        (circuits.rs:36-48)."""
        self.note_value = note_value
        self.private_key = private_key
        self.hash_inputs = list(hash_inputs)
        self.public_key = public_key

    def valid_balance(self, composer: Composer, tx_value: int,
                      gas_fee: int, enforce: bool = True):
        """note_value >= tx_value + gas_fee over a 30-bit range
        (circuits.rs:51-60)."""
        total_tx = (tx_value + gas_fee) % R_MOD
        output = min_bound(composer, total_tx, self.note_value, 30)
        if enforce:
            composer.constrain_to_constant(output, 1)
        return output

    def prove_ownership(self, composer: Composer):
        """public_key == private_key * G (circuits.rs:63-66)."""
        circuit_pk = composer.fixed_base_scalar_mul(
            self.private_key.var, jubjub.GENERATOR)
        composer.assert_equal_public_point(circuit_pk, self.public_key)

    def check_hash_inputs(self, composer: Composer, public_hash: int):
        """Poseidon sponge(hash_inputs) == public_hash, with the hash
        exposed as a public input (circuits.rs:69-72)."""
        hash_var = poseidon.sponge_gadget(composer, self.hash_inputs)
        composer.constrain_to_constant(hash_var, 0,
                                       (-public_hash) % R_MOD)


def build_mock_circuit(note_value: int, private_key: int, hash_inputs,
                       tx_value: int, gas_fee: int):
    """Convenience: allocate witnesses, run all three constraint
    methods, return (composer, public data)."""
    composer = Composer()
    nv = AllocatedScalar.allocate(composer, note_value)
    sk = AllocatedScalar.allocate(composer, private_key)
    hi_vars = [composer.add_input(h) for h in hash_inputs]
    public_key = jubjub.mul(jubjub.GENERATOR, private_key)
    public_hash = poseidon.sponge_hash(hash_inputs)

    circuit = MockCircuit(nv, sk, hi_vars, public_key)
    circuit.valid_balance(composer, tx_value, gas_fee)
    circuit.prove_ownership(composer)
    circuit.check_hash_inputs(composer, public_hash)
    return composer, {"public_key": public_key, "public_hash": public_hash}
