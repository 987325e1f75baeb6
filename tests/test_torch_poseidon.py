"""The port's batched Poseidon (tpu_plonk_torch.gadgets.poseidon_device,
plain versions on the CPU) against the reference's host permutation and
sponge (tpu_plonk.gadgets.poseidon), as tests/test_gadgets.py holds the
reference's own device sponge: messages shorter than the rate and
longer than it, digests compared exactly."""

import numpy as np
import pytest
import torch

from tpu_plonk.params import R_MOD
from tpu_plonk.gadgets import poseidon as jpos

from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.gadgets import poseidon_device as pd

torch.set_num_threads(1)


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


@pytest.mark.parametrize("msgs", [
    [[1, 2, 3], [7, 8, 9], [0, 0, 0], _rand(3, 1), [R_MOD - 1] * 3],
    [list(range(9)), [5] * 9, _rand(9, 2)],          # three absorptions
    [_rand(4, 3), _rand(4, 4)],                      # exactly the rate
], ids=["three", "nine", "four"])
def test_sponge_matches_reference(msgs):
    want = [jpos.sponge_hash(m) for m in msgs]
    assert pd.sponge_hash_device(msgs, device="cpu") == want


def test_permute_matches_reference():
    states = [_rand(5, 10 + k) for k in range(3)] + [[0] * 5]
    words = tdev.ints_to_words([v for s in states for v in s], tdev.FR,
                               mont=True).reshape(len(states), 5, 8)
    got = tdev.words_to_ints(pd.permute_device(words), True, tdev.FR)
    want = [v for s in states for v in jpos.permute(s)]
    assert got == want
    assert torch.equal(pd.permute_plain(words), pd.permute_device(words))


def test_plain_ragged_batch_and_no_card():
    assert pd.sponge_hash_plain([[4, 5, 6]], "cpu") == [
        jpos.sponge_hash([4, 5, 6])]
    with pytest.raises(ValueError):
        pd.sponge_hash_device([[1, 2], [3]], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pd.sponge_hash_device([[1, 2, 3]])
