"""Port NTT (tpu_plonk_torch.poly.ntt, plain version on the CPU) against
the JAX reference's ntt / intt / coset transforms / ntt_many(scale=) and
its host-int ntt_ints, on the same numpy-seeded inputs; exact limbs."""

import numpy as np
import torch
import pytest
import jax.numpy as jnp

from tpu_plonk.params import R_MOD, FR_MONT_R
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.poly import ntt as jntt

from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.poly import ntt as tntt

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _coeffs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


def _mont_limbs(vals):
    return jlimbs.fr_to_limbs([v * FR_MONT_R % R_MOD for v in vals])


@pytest.mark.parametrize("log_n", [3, 10])
def test_transforms_match_reference(log_n):
    n = 1 << log_n
    vals = _coeffs(n, log_n)
    x = _mont_limbs(vals)
    jx, tx = jnp.asarray(x), tdev.limbs16_to_words(x)
    for tf, jf in ((tntt.ntt, jntt.ntt), (tntt.intt, jntt.intt),
                   (tntt.coset_ntt, jntt.coset_ntt),
                   (tntt.coset_intt, jntt.coset_intt)):
        got = tdev.words_to_limbs16(tf(tx, log_n))
        assert np.array_equal(got, np.asarray(jf(jx, log_n))), tf.__name__
    # the host-int oracle
    assert tdev.words_to_ints(tntt.ntt(tx, log_n), True, tdev.FR) == \
        jntt.ntt_ints(vals, log_n)
    assert tdev.words_to_ints(tntt.coset_intt(tx, log_n), True, tdev.FR) \
        == jntt.ntt_ints(vals, log_n, inverse=True, coset=True)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_many_scale_matches_reference(inverse):
    log_n, scale = 6, 0x1234567
    xs = np.stack([_mont_limbs(_coeffs(1 << log_n, 20 + k)) for k in range(3)])
    want = jntt.ntt_many(jnp.asarray(xs), log_n, inverse=inverse, scale=scale)
    got = tntt.ntt_many(tdev.limbs16_to_words(xs), log_n, inverse=inverse,
                        scale=scale)
    assert np.array_equal(tdev.words_to_limbs16(got), np.asarray(want))
