"""merlin transcript, byte-compatible with the Rust `merlin` crate
(the Fiat-Shamir channel dusk-plonk 0.8 builds on — SURVEY.md §2.8).

Framing (as in merlin::Transcript):
    new(label)            : Strobe128("Merlin v1.0"); append_message(b"dom-sep", label)
    append_message(l, m)  : meta_ad(l) ; meta_ad(LE32(len(m)), more) ; ad(m)
    challenge_bytes(l, n) : meta_ad(l) ; meta_ad(LE32(n), more) ; prf(n)
"""

from .strobe import Strobe128
from ..fields import fr

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, length: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(length.to_bytes(4, "little"), True)
        return self.strobe.prf(length, False)

    # --- dusk-plonk TranscriptProtocol extensions (SURVEY.md §2.8) ---

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, fr.to_bytes(scalar))

    def append_commitment(self, label: bytes, point) -> None:
        from ..curves import g1
        self.append_message(label, g1.to_bytes(point))

    def challenge_scalar(self, label: bytes) -> int:
        return fr.from_bytes_wide(self.challenge_bytes(label, 64))

    def circuit_domain_sep(self, n: int) -> None:
        self.append_message(b"dom-sep", b"circuit_size")
        self.append_u64(b"n", n)
