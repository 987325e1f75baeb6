"""The NTT kernel's pass schedule (csrc/ntt.cu, poly/ntt.py pass_plan),
emulated on the CPU in plain torch and held against the JAX reference:
the tiles each block loads, the twiddle each butterfly uses (from the
block's heap-ordered table), the bit reversal and coset pre-scale folded
into the first pass's load and the inverse's n^-1 s^j folded into the
last pass's store.  Batch 3; forward, inverse and coset; sizes below a
tile, one tile, even and uneven splits into two passes, and three
passes.  Exact limbs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_plonk.params import R_MOD, FR_MONT_R
from tpu_plonk.fields import limbs as jlimbs
from tpu_plonk.poly import ntt as jntt
from tpu_plonk.poly.domain import Domain as JDomain

from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.poly import ntt as tntt

torch.set_num_threads(1)

FR = tdev.FR
SCALE = 0x1234567


def _heap_twiddles(tw, log_n, a, k, lo):
    """(blocks, 2^k, 8): entry 2^s + j of block lo is w^(((j << a) | lo)
    << (log_n - 1 - a - s)), as the kernel loads it; entry 0 unused."""
    e = torch.arange(1, 1 << k)
    s = torch.floor(torch.log2(e.double())).long()
    j = e - (1 << s)
    idx = ((j[None] << a) | lo[:, None]) << (log_n - 1 - a - s[None])
    out = torch.zeros(lo.shape[0], 1 << k, 8, dtype=torch.int32)
    out[:, 1:] = tw[idx]
    return out


def emulate(xs, log_n, tw, pre, post, plan):
    """The kernel's passes over (B, n, 8), block by block (all blocks of
    a pass at once); the same butterflies as the CUDA threads."""
    n = xs.shape[1]
    out = torch.empty_like(xs)
    a = 0
    for p, k in enumerate(plan):
        blk = torch.arange(n >> k)
        lo, hi = blk & ((1 << a) - 1), blk >> a
        m = torch.arange(1 << k)
        pos = (hi[:, None] << (a + k)) | (m[None] << a) | lo[:, None]
        if p == 0:
            rev = torch.zeros_like(pos)
            for bit in range(log_n):
                rev |= ((pos >> bit) & 1) << (log_n - 1 - bit)
            tile = xs[:, rev]
            if pre is not None:
                tile = tdev.mont_mul_plain(tile, pre[rev], FR)
        else:
            tile = out[:, pos]
        wt = _heap_twiddles(tw, log_n, a, k, lo)
        t = torch.arange(1 << (k - 1))
        for s in range(k):
            j = t & ((1 << s) - 1)
            m0 = ((t >> s) << (s + 1)) | j
            m1 = m0 + (1 << s)
            v = tdev.mont_mul_plain(tile[:, :, m1], wt[:, (1 << s) + j], FR)
            u = tile[:, :, m0]
            tile = tile.clone()
            tile[:, :, m0] = tdev.add_mod_plain(u, v, FR)
            tile[:, :, m1] = tdev.sub_mod_plain(u, v, FR)
        if p == len(plan) - 1 and post is not None:
            tile = tdev.mont_mul_plain(tile, post[pos], FR)
        out[:, pos] = tile
        a += k
    return out


def run_emulated(xs, log_n, inverse, scale, plan=None):
    """ntt_many's kernel route with the kernel replaced by `emulate`, on
    `plan` (the kernel takes any plan of 1 .. 10 stages a pass; default
    pass_plan's)."""
    scale %= R_MOD
    tw = tntt._twiddles(log_n, inverse, "cpu", True)
    pre = post = None
    if not inverse and scale != 1:
        pre = tntt._powers(scale, 1 << log_n, "cpu", True)
    if inverse:
        post = tntt._post_scale(scale, log_n, "cpu", True)
    return emulate(xs, log_n, tw, pre, post, plan or tntt.pass_plan(log_n))


def _inputs(log_n, seed):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "little") % R_MOD
             for _ in range(1 << log_n)] for _ in range(3)]


def _words(vals):
    flat = [v for row in vals for v in row]
    return tdev.ints_to_words(flat, FR, mont=True).reshape(len(vals), -1, 8)


def test_pass_plan():
    for log_n in range(1, 31):
        plan = tntt.pass_plan(log_n)
        assert sum(plan) == log_n
        assert all(1 <= k <= tntt.MAX_TILE_LOG for k in plan)
        assert max(plan) - min(plan) <= 1
        assert len(plan) == -(-log_n // tntt.MAX_TILE_LOG)
    assert tntt.pass_plan(18) == [9, 9]
    assert tntt.pass_plan(20) == [10, 10]
    assert tntt.pass_plan(22) == [8, 7, 7]


@pytest.mark.parametrize("log_n,plan", [
    (1, None), (2, None), (3, None), (5, None), (9, None), (10, None),
    (12, None), (5, [3, 2]), (10, [4, 3, 3])])
def test_pass_schedule_matches_domain(log_n, plan):
    """Forward, inverse, coset forward and coset inverse against the
    reference's host-int Domain(n) transforms, three polynomials; on
    pass_plan's plans (one pass up to 2^10, two at 2^12) and on an
    uneven two-pass and an uneven three-pass plan of small tiles."""
    vals = _inputs(log_n, 70 + log_n)
    xs = _words(vals)
    dom = JDomain(1 << log_n)
    g = SCALE
    cases = ((False, 1, dom.ntt), (True, 1, dom.intt),
             (False, g, lambda v: dom.coset_ntt(v, g)),
             (True, pow(g, -1, R_MOD), lambda v: dom.coset_intt(v, g)))
    for inverse, scale, host in cases:
        got = tdev.words_to_ints(
            run_emulated(xs, log_n, inverse, scale, plan).reshape(-1, 8),
            True, FR)
        want = [y for row in vals for y in host(row)]
        assert got == want, (log_n, inverse, scale)


@pytest.mark.parametrize("log_n", [2])
def test_pass_schedule_matches_ntt_many(log_n):
    """Against the reference's device ntt_many (scale=) on Montgomery
    limbs: forward, inverse, coset (one size: its eager compile takes
    seconds a size)."""
    vals = _inputs(log_n, 90 + log_n)
    limbs = np.stack([jlimbs.fr_to_limbs([v * FR_MONT_R % R_MOD for v in row])
                      for row in vals])
    xs = tdev.limbs16_to_words(limbs)
    for inverse, scale in ((False, 1), (True, 1), (False, SCALE)):
        want = jntt.ntt_many(jnp.asarray(limbs), log_n, inverse=inverse,
                             scale=scale)
        got = run_emulated(xs, log_n, inverse, scale)
        assert np.array_equal(tdev.words_to_limbs16(got), np.asarray(want))
