"""Batched native Poseidon on the device (mirrors
tpu_plonk/gadgets/poseidon_device.py): B messages hashed at once, for
witness generation of hash-heavy circuits and Merkle paths.

State: (B, WIDTH, 8) Montgomery words.  The constants are the port's
own Grain / Cauchy set (gadgets/poseidon.py), so the digests equal the
host `sponge_hash` bit for bit.  Every round is the port's field ops on
the whole batch: the round-constant add and the MDS sums are
`fr_add_sub`, the S-box and the MDS products `fr_mont_mul` (the MDS as
one batched (B, 5, 5) multiply); on a CPU tensor, and in the `_plain`
functions on any device, their plain versions.  No kernel of its own:
a round is nine launches, a permutation 603.
"""

import functools

import torch

from ..fields import device as dev
from ..kernels import resolve_device
from . import poseidon as hp

FR = dev.FR
ROUNDS = hp.FULL_ROUNDS + hp.PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _consts(device: str):
    """(ROUNDS, WIDTH, 8) round constants and the (WIDTH, WIDTH, 8) MDS
    matrix, Montgomery, on `device`."""
    rc = dev.ints_to_words(hp.round_constants(), FR, device, mont=True)
    mds = dev.ints_to_words([v for row in hp.mds_matrix() for v in row],
                            FR, device, mont=True)
    return (rc.reshape(ROUNDS, hp.WIDTH, FR.n_words),
            mds.reshape(hp.WIDTH, hp.WIDTH, FR.n_words))


def _ops(plain: bool):
    if plain:
        return (lambda a, b: dev.mont_mul_plain(a, b, FR),
                lambda a, b: dev.add_mod_plain(a, b, FR))
    return (lambda a, b: dev.mont_mul(a, b, FR),
            lambda a, b: dev.add_mod(a, b, FR))


def _permute(state, plain: bool):
    mul, add = _ops(plain)
    rc, mds = _consts(str(state.device))
    b, w = state.shape[0], hp.WIDTH

    def sbox(x):
        x2 = mul(x, x)
        return mul(mul(x2, x2), x)

    def mix(s):
        prod = mul(s[:, None].expand(b, w, w, FR.n_words), mds)
        acc = add(add(prod[:, :, 0], prod[:, :, 1]),
                  add(prod[:, :, 2], prod[:, :, 3]))
        return add(acc, prod[:, :, 4])

    half = hp.FULL_ROUNDS // 2
    for r in range(ROUNDS):
        state = add(state, rc[r])
        if half <= r < half + hp.PARTIAL_ROUNDS:
            state = torch.cat([state[:, :w - 1],
                               sbox(state[:, w - 1:])], dim=1)
        else:
            state = sbox(state)
        state = mix(state)
    return state


def permute_device(state):
    """Hades permutation of (B, WIDTH, 8) Montgomery states: the field
    kernels on a CUDA tensor, their plain versions on a CPU one."""
    return _permute(state, plain=False)


def permute_plain(state):
    """Plain version of permute_device (any device, no kernel)."""
    return _permute(state, plain=True)


def _sponge(message_batches, device, plain: bool):
    b = len(message_batches)
    ln = len(message_batches[0])
    if any(len(m) != ln for m in message_batches):
        raise ValueError("a batch must share one message length")
    pad = [1] + [0] * (-(ln + 1) % hp.RATE)
    flat = [v for m in message_batches for v in list(m) + pad]
    words = dev.ints_to_words(flat, FR, "cpu", mont=True).reshape(
        b, ln + len(pad), FR.n_words).to(device)
    _, add = _ops(plain)
    state = torch.zeros((b, hp.WIDTH, FR.n_words), dtype=torch.int32,
                        device=device)
    for start in range(0, words.shape[1], hp.RATE):
        state = torch.cat([state[:, :1],
                           add(state[:, 1:], words[:, start:start + hp.RATE])],
                          dim=1)
        state = _permute(state, plain)
    return dev.words_to_ints(state[:, 1], mont=True, ctx=FR)


def sponge_hash_device(message_batches, device=None):
    """Hash B equal-length messages (lists of ints) -> B digests, on
    `device` (cuda unless named).  Absorption mirrors the host
    `sponge_hash`: 10* padding to the rate, additive absorption into
    state[1:], output state[1]."""
    return _sponge(message_batches, resolve_device(device), plain=False)


def sponge_hash_plain(message_batches, device):
    """Plain version of sponge_hash_device on `device` (no kernel)."""
    return _sponge(message_batches, torch.device(device), plain=True)
