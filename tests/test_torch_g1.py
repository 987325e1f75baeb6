"""Port G1 add / double / select (tpu_plonk_torch.curves.device_g1, plain
version on the CPU) against the JAX reference's complete RCB add, with
projective limbs compared exactly.  One batch holds generic, identity,
doubling and negated lanes: each JAX add instance costs a long XLA
compile here, so the file makes a single reference call."""

import numpy as np
import torch
import jax.numpy as jnp

from tpu_plonk.params import R_MOD
from tpu_plonk.curves import g1 as jg1
from tpu_plonk.curves import device_g1 as jdg1

from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.curves import device_g1 as tdg1

# the plain versions run many small tensor ops: one intra-op thread per
# test process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [jg1.mul(jg1.GEN, int.from_bytes(rng.bytes(32), "little") % R_MOD)
            for _ in range(n)]


def _batch():
    ps = _points(6, 1)
    P = [ps[0], ps[1], None, ps[2], None, ps[3], ps[4], ps[5]]
    Q = [ps[5], ps[1], ps[3], jg1.neg(ps[2]), None, ps[3], ps[0], None]
    return P, Q


def _jax_proj(points):
    x, y, z = jdg1.points_to_device(points)
    return np.stack([np.asarray(x), np.asarray(y), np.asarray(z)], axis=1)


def _port_proj(arr):
    return tdev.limbs16_to_words(arr)


def test_add_double_select_match_reference():
    P, Q = _batch()
    jp, jq = _jax_proj(P), _jax_proj(Q)
    want = jdg1.add(tuple(jnp.asarray(jp[:, k]) for k in range(3)),
                    tuple(jnp.asarray(jq[:, k]) for k in range(3)))
    want = np.stack([np.asarray(w) for w in want], axis=1)
    tp, tq = _port_proj(jp), _port_proj(jq)
    got = tdg1.add(tp, tq)
    assert np.array_equal(tdev.words_to_limbs16(got), want)
    # the affine results are the host sums (identity, doubling, P - P)
    assert tdg1.points_from_device(got) == [jg1.add(a, b) for a, b in zip(P, Q)]
    # lane 1 is a doubling: double() agrees with the reference there
    assert np.array_equal(tdev.words_to_limbs16(tdg1.double(tp[1:2]))[0],
                          want[1])
    # select and the identity / conversions
    mask = torch.tensor([True, False] * 4)
    sel = tdg1.select(mask, tp, tq)
    assert tdg1.points_from_device(sel) == [p if m else q for p, q, m in
                                            zip(P, Q, [True, False] * 4)]
    assert tdg1.points_from_device(tdg1.identity((2,))) == [None, None]
    assert np.array_equal(tdev.words_to_limbs16(tdg1.points_to_device(P)), jp)
