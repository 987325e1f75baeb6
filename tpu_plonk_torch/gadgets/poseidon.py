"""Poseidon-252 over Fr via the Hades permutation — native (host) and
in-circuit (gadget) forms, sharing one constant set
(SURVEY.md §2.9 dusk-poseidon row).

Parameters (dusk-hades shape): width 5, rate 4, x^5 S-box, 8 full +
59 partial rounds; partial-round S-box on the last state element;
ARK -> S-box -> MDS per round with per-element round constants.

Constants are generated with the Grain-LFSR procedure of the Poseidon
reference implementation (generate_parameters_grain.sage) and a Cauchy
MDS matrix — deterministic and documented.

INTEROP WARNING: dusk-hades 0.22 ships its own checked-in constant set
which is NOT on this machine and is almost certainly different, so
hashes produced here are **not interoperable with the dusk stack** —
self-consistency (native == gadget == batched device) is tested, dusk
cross-compatibility is not.  To pin parity when a dusk fixture becomes
available: check the vector into tests/vectors/, gate it in
tests/test_gadgets.py, and swap `round_constants()`/`mds_matrix()` for
the crate's tables (one module; nothing else changes).

Cost: the sponge gadget emits ~1.1k gates per permutation
(reference circuits.rs:70 calls sponge::gadget).
"""

import functools

from ..params import R_MOD
from ..cs import Composer

WIDTH = 5
RATE = 4
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 59


# ---------------------------------------------------------------------------
# Grain LFSR constant generation (Poseidon reference procedure)
# ---------------------------------------------------------------------------


class _Grain:
    def __init__(self, field_bits=255, t=WIDTH, r_f=FULL_ROUNDS,
                 r_p=PARTIAL_ROUNDS):
        bits = []
        bits += _int_bits(1, 2)        # field: GF(p)
        bits += _int_bits(0, 4)        # sbox: x^alpha
        bits += _int_bits(field_bits, 12)
        bits += _int_bits(t, 12)
        bits += _int_bits(r_f, 10)
        bits += _int_bits(r_p, 10)
        bits += [1] * 30
        self.state = bits              # 80 bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # von Neumann filtering: emit b2 of pairs (1, b2); skip (0, _)
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1:
                return b2

    def next_field_element(self) -> int:
        while True:
            v = 0
            for _ in range(255):
                v = (v << 1) | self.next_bit()
            if v < R_MOD:
                return v


def _int_bits(v: int, width: int):
    return [(v >> (width - 1 - i)) & 1 for i in range(width)]


@functools.lru_cache(maxsize=None)
def round_constants():
    """(FULL+PARTIAL) * WIDTH constants, consumed one row per round."""
    g = _Grain()
    total = (FULL_ROUNDS + PARTIAL_ROUNDS) * WIDTH
    return tuple(g.next_field_element() for _ in range(total))


@functools.lru_cache(maxsize=None)
def mds_matrix():
    """Cauchy matrix M[i][j] = 1 / (x_i + y_j), x_i = i, y_j = t + j."""
    return tuple(
        tuple(pow((i + WIDTH + j) % R_MOD, -1, R_MOD) for j in range(WIDTH))
        for i in range(WIDTH)
    )


# ---------------------------------------------------------------------------
# native permutation + sponge
# ---------------------------------------------------------------------------


def permute(state):
    """Hades permutation on a 5-element list of ints."""
    assert len(state) == WIDTH
    st = [x % R_MOD for x in state]
    rc = round_constants()
    mds = mds_matrix()
    half_full = FULL_ROUNDS // 2
    r = 0

    def ark(s, r):
        base = r * WIDTH
        return [(x + rc[base + i]) % R_MOD for i, x in enumerate(s)]

    def sbox(x):
        x2 = x * x % R_MOD
        return x2 * x2 % R_MOD * x % R_MOD

    def mix(s):
        return [sum(mds[i][j] * s[j] for j in range(WIDTH)) % R_MOD
                for i in range(WIDTH)]

    for _ in range(half_full):
        st = mix([sbox(x) for x in ark(st, r)])
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        st = ark(st, r)
        st[WIDTH - 1] = sbox(st[WIDTH - 1])
        st = mix(st)
        r += 1
    for _ in range(half_full):
        st = mix([sbox(x) for x in ark(st, r)])
        r += 1
    return st


def _pad(messages):
    """10* padding to a multiple of RATE."""
    padded = list(messages) + [1]
    while len(padded) % RATE:
        padded.append(0)
    return padded


def sponge_hash(messages) -> int:
    """Native sponge (dusk sponge::hash analog): additive rate-4
    absorption into state[1..5], output state[1]."""
    state = [0] * WIDTH
    for chunk_start in range(0, len(_pad(messages)), RATE):
        chunk = _pad(messages)[chunk_start:chunk_start + RATE]
        for i, m in enumerate(chunk):
            state[i + 1] = (state[i + 1] + m) % R_MOD
        state = permute(state)
    return state[1]


# ---------------------------------------------------------------------------
# in-circuit gadget
# ---------------------------------------------------------------------------


def _gadget_sbox(cs: Composer, var: int, constant: int) -> int:
    """(x + c)^5 in 4 gates."""
    t = cs.add((1, var), (0, var), constant)
    t2 = cs.mul(1, t, t, 0)
    t4 = cs.mul(1, t2, t2, 0)
    return cs.mul(1, t4, t, 0)


def _gadget_mix(cs: Composer, vars_, consts):
    """MDS row combinations; per-element pre-ARK constants folded into
    the big_add q_c terms.  consts[j] is added to element j BEFORE the
    matrix (zero for S-boxed elements whose constant was consumed)."""
    mds = mds_matrix()
    out = []
    for i in range(WIDTH):
        fold = sum(mds[i][j] * consts[j] for j in range(WIDTH)) % R_MOD
        s1 = cs.big_add((mds[i][0], vars_[0]), (mds[i][1], vars_[1]),
                        (mds[i][2], vars_[2]), 0)
        s = cs.big_add((1, s1), (mds[i][3], vars_[3]),
                       (mds[i][4], vars_[4]), fold)
        out.append(s)
    return out


def permute_gadget(cs: Composer, state_vars):
    """In-circuit Hades permutation on 5 witness variables."""
    assert len(state_vars) == WIDTH
    rc = round_constants()
    st = list(state_vars)
    half_full = FULL_ROUNDS // 2
    r = 0
    for _ in range(half_full):
        base = r * WIDTH
        st = _gadget_mix(
            cs, [_gadget_sbox(cs, st[i], rc[base + i]) for i in range(WIDTH)],
            [0] * WIDTH)
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        base = r * WIDTH
        new_last = _gadget_sbox(cs, st[WIDTH - 1], rc[base + WIDTH - 1])
        st = _gadget_mix(cs, st[:WIDTH - 1] + [new_last],
                         list(rc[base:base + WIDTH - 1]) + [0])
        r += 1
    for _ in range(half_full):
        base = r * WIDTH
        st = _gadget_mix(
            cs, [_gadget_sbox(cs, st[i], rc[base + i]) for i in range(WIDTH)],
            [0] * WIDTH)
        r += 1
    return st


def sponge_gadget(cs: Composer, message_vars) -> int:
    """In-circuit sponge over witness variables (dusk sponge::gadget,
    reference circuits.rs:70)."""
    padded = list(message_vars)
    padded.append(cs.one_var)
    while len(padded) % RATE:
        padded.append(cs.zero_var)
    state = [cs.zero_var] * WIDTH
    for start in range(0, len(padded), RATE):
        chunk = padded[start:start + RATE]
        absorbed = [state[0]]
        for i, m in enumerate(chunk):
            absorbed.append(cs.add((1, state[i + 1]), (1, m), 0))
        state = permute_gadget(cs, absorbed)
    return state[1]
