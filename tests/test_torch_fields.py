"""Port field arithmetic (tpu_plonk_torch.fields.device, plain versions
on the CPU) against the JAX reference (tpu_plonk.fields.device and the
Pallas Fr multiply in interpret mode): same numpy-seeded inputs, limbs
compared exactly (tolerance 0: integer field arithmetic)."""

import numpy as np
import torch
import pytest
import jax.numpy as jnp

from tpu_plonk.fields import device as jdev
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.fields import pallas_fr

from tpu_plonk_torch.fields import device as tdev

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CTX = {"fr": (jdev.FR, tdev.FR), "fp": (jdev.FP, tdev.FP)}
N = 16


def _vals(mod: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    nb = (mod.bit_length() + 7) // 8
    vals = [int.from_bytes(rng.bytes(nb), "little") % mod for _ in range(n)]
    vals[:3] = [0, 1, mod - 1]
    return vals


def _limbs(vals, ctx_j):
    return jlimbs.ints_to_limbs(vals, ctx_j.n_limbs)


def _port(arr):
    return tdev.limbs16_to_words(arr)


def _same(port_out, jax_out):
    return np.array_equal(tdev.words_to_limbs16(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_mul_add_sub_neg_match_reference(name):
    cj, ct = CTX[name]
    a = _limbs(_vals(cj.modulus, N, 1), cj)
    b = _limbs(_vals(cj.modulus, N, 2)[::-1], cj)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _port(a), _port(b)
    assert _same(tdev.mont_mul(ta, tb, ct), jdev.mont_mul(ja, jb, cj))
    assert _same(tdev.add_mod(ta, tb, ct), jdev.add_mod(ja, jb, cj))
    assert _same(tdev.sub_mod(ta, tb, ct), jdev.sub_mod(ja, jb, cj))
    assert _same(tdev.neg_mod(ta, ct), jdev.neg_mod(ja, cj))
    # broadcast of one row against the batch
    assert _same(tdev.mont_mul(ta, tb[3:4], ct),
                 jdev.mont_mul(ja, jnp.broadcast_to(jb[3], ja.shape), cj))


@pytest.mark.parametrize("name", ["fr", "fp"])
def test_pow_inv_scan_batch_inv_match_reference(name):
    cj, ct = CTX[name]
    a = _limbs(_vals(cj.modulus, N, 3), cj)
    ja, ta = jnp.asarray(a), _port(a)
    assert _same(tdev.mont_pow(ta, 13, ct), jdev.mont_pow(ja, 13, cj))
    assert _same(tdev.mont_inv(ta, ct), jdev.mont_inv(ja, cj))
    assert _same(tdev.prefix_mul_mont(ta, ct), jdev.prefix_mul_mont(ja, cj))
    assert _same(tdev.batch_inv_mont(ta, ct), jdev.batch_inv_mont(ja, cj))


@pytest.mark.parametrize("n,scalar", [(1000, False), (64, True)])
def test_fr_mont_mul_matches_pallas_kernel(n, scalar):
    """The TPU kernel the Fr multiply replaces, in interpret mode, at the
    shapes tests/test_pallas_fr.py uses (1000 rows; 64 rows x a scalar)."""
    vals = _vals(tdev.FR.modulus, n, 4)
    a = _limbs(vals, jdev.FR)
    b = _limbs(_vals(tdev.FR.modulus, 1 if scalar else n, 5), jdev.FR)
    jb = jnp.asarray(b[0]) if scalar else jnp.asarray(b)
    want = pallas_fr.mont_mul(jnp.asarray(a), jb, interpret=True)
    tb = _port(b[:1]) if scalar else _port(b)
    assert _same(tdev.mont_mul(_port(a), tb, tdev.FR), want)


def test_word_layout_roundtrip():
    vals = _vals(tdev.FP.modulus, 8, 6)
    w = tdev.ints_to_words(vals, tdev.FP)
    assert tdev.words_to_ints(w) == vals
    assert np.array_equal(tdev.words_to_limbs16(w), jlimbs.fp_to_limbs(vals))
    assert tdev.words_to_ints(tdev.to_mont(w, tdev.FP), True, tdev.FP) == vals
