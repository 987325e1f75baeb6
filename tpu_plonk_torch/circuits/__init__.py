from .mock_circuit import MockCircuit  # noqa: F401
from .circuit import (  # noqa: F401
    Circuit, VerifierData, verify_proof, gadget_tester,
)
