"""STROBE-128 duplex construction, byte-compatible with merlin's
`Strobe128` (the subset merlin uses: meta-AD, AD, PRF, KEY).

Byte-exactness here is what makes every Fiat-Shamir challenge in the
prover reproducible against the Rust stack (SURVEY.md §7 "hard parts"
item 2); validated against merlin's published conformance vector in
tests/test_transcript.py.
"""

from .keccak import f1600

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # --- public ops (merlin subset) ---

    def meta_ad(self, data: bytes, more: bool) -> None:
        if not more:
            self._begin_op(FLAG_M | FLAG_A)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        if not more:
            self._begin_op(FLAG_A)
        self._absorb(data)

    def prf(self, length: int, more: bool) -> bytes:
        if not more:
            self._begin_op(FLAG_I | FLAG_A | FLAG_C)
        return self._squeeze(length)

    def key(self, data: bytes, more: bool) -> None:
        if not more:
            self._begin_op(FLAG_A | FLAG_C)
        self._overwrite(data)

    # --- internals ---

    def _run_f(self) -> None:
        st = self.state
        st[self.pos] ^= self.pos_begin
        st[self.pos + 1] ^= 0x04
        st[STROBE_R + 1] ^= 0x80
        f1600(st)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, length: int) -> bytes:
        out = bytearray(length)
        for i in range(length):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int) -> None:
        assert flags & FLAG_T == 0, "transport ops unsupported (as in merlin)"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()
