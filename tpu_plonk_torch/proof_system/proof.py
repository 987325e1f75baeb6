"""Proof object + canonical serialization.

Layout (docs/PROTOCOL.md §proof): 11 compressed G1 commitments (48 B
each) followed by 16 scalars (32 B LE each) = 1040 bytes.  Commitment
order: w_l w_r w_o w_4 z t1 t2 t3 t4 w_z w_zw.  Evaluation order:
a b c d | a' b' d' | sigma1 sigma2 sigma3 | q_arith q_c q_l q_r |
z(zw) | r(z).
(the dusk 0.8 shape: c is opened only at zeta — no widget reads the
output wire on the next row; SURVEY.md §2.8 round 4.)

ZK (blinded) variant: proofs produced with `blinding_seed=` carry a
5th quotient chunk commitment t_5 (after t_4) — 1088 bytes.  The two
formats are distinguished by length; the blinded format is this
framework's own (dusk-plonk 0.8 has no blinding at all)."""

import dataclasses

from ..curves import g1
from ..fields import fr

COMMITMENT_NAMES = ("w_l", "w_r", "w_o", "w_4", "z",
                    "t_1", "t_2", "t_3", "t_4", "w_z", "w_zw")
BLINDED_COMMITMENT_NAMES = ("w_l", "w_r", "w_o", "w_4", "z",
                            "t_1", "t_2", "t_3", "t_4", "t_5",
                            "w_z", "w_zw")
EVAL_NAMES = ("a", "b", "c", "d",
              "a_next", "b_next", "d_next",
              "sigma1", "sigma2", "sigma3",
              "q_arith", "q_c", "q_l", "q_r",
              "z_shifted", "r")

PROOF_SIZE = 11 * 48 + 16 * 32          # 1040 bytes
BLINDED_PROOF_SIZE = 12 * 48 + 16 * 32  # 1088 bytes


@dataclasses.dataclass
class Proof:
    commitments: dict  # name -> affine G1 point (or None)
    evals: dict        # name -> int

    @property
    def blinded(self) -> bool:
        return "t_5" in self.commitments

    def to_bytes(self) -> bytes:
        names = BLINDED_COMMITMENT_NAMES if self.blinded \
            else COMMITMENT_NAMES
        out = [g1.to_bytes(self.commitments[n]) for n in names]
        out += [fr.to_bytes(self.evals[n]) for n in EVAL_NAMES]
        data = b"".join(out)
        assert len(data) == (BLINDED_PROOF_SIZE if self.blinded
                             else PROOF_SIZE)
        return data

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        # untrusted input: never use assert (stripped under -O)
        if len(data) == PROOF_SIZE:
            names = COMMITMENT_NAMES
        elif len(data) == BLINDED_PROOF_SIZE:
            names = BLINDED_COMMITMENT_NAMES
        else:
            raise ValueError("bad proof length")
        comms, off = {}, 0
        for n in names:
            comms[n] = g1.from_bytes(data[off:off + 48])
            off += 48
        evals = {}
        for n in EVAL_NAMES:
            evals[n] = fr.from_bytes(data[off:off + 32])
            off += 32
        return Proof(comms, evals)
