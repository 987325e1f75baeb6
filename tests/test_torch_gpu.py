"""Each CUDA kernel of the port against its plain PyTorch version on the
card, exact.  Marked `gpu`; without a card every test skips (decided in
the fixture, so every xdist worker collects the same tests).  This file
imports no JAX, so it runs on the card's machine with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from tpu_plonk_torch import kernels
from tpu_plonk_torch.fields import device as dev
from tpu_plonk_torch.poly import ntt
from tpu_plonk_torch.curves import device_g1 as dg1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _words(n, ctx, seed, device):
    rng = np.random.default_rng(seed)
    nb = 4 * ctx.n_words
    vals = [int.from_bytes(rng.bytes(nb), "little") % ctx.modulus
            for _ in range(n)]
    vals[:3] = [0, 1, ctx.modulus - 1]
    return dev.ints_to_words(vals, ctx, device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fr", "fp"])
def test_field_kernels_match_plain(cuda, name):
    ctx = dev.FR if name == "fr" else dev.FP
    a, b = _words(5000, ctx, 1, cuda), _words(5000, ctx, 2, cuda)
    before = kernels.counts()
    assert torch.equal(dev.mont_mul(a, b, ctx), dev.mont_mul_plain(a, b, ctx))
    assert torch.equal(dev.mont_mul(a, b[7:8], ctx),
                       dev.mont_mul_plain(a, b[7:8], ctx))
    if ctx is dev.FR:
        assert torch.equal(dev.add_mod(a, b, ctx), dev.add_mod_plain(a, b, ctx))
        assert torch.equal(dev.sub_mod(a, b, ctx), dev.sub_mod_plain(a, b, ctx))
    after = kernels.counts()
    assert after[f"{name}_mont_mul"] == before[f"{name}_mont_mul"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("log_n", [1, 4, 11])
def test_ntt_kernel_matches_plain(cuda, log_n):
    x = _words(3 << log_n, dev.FR, log_n, cuda).reshape(3, 1 << log_n, 8)
    for inverse, scale in ((False, 1), (True, 1), (False, 7), (True, 11)):
        assert torch.equal(ntt.ntt_many(x, log_n, inverse, scale),
                           ntt.transform_plain(x, log_n, inverse, scale))


@pytest.mark.gpu
def test_g1_kernels_match_plain(cuda):
    n = 2048
    p = torch.stack([_words(n, dev.FP, 10 + k, cuda) for k in range(3)], 1)
    q = torch.stack([_words(n, dev.FP, 20 + k, cuda) for k in range(3)], 1)
    q[:8] = p[:8]
    p[8:16] = dg1.identity((8,), cuda)
    neg = torch.arange(n, device=cuda) % 3 == 0
    assert torch.equal(dg1.add(p, q, neg), dg1.add_plain(p, q, neg))
    rng = np.random.default_rng(5)
    lens = torch.from_numpy(rng.integers(0, 24, 500).astype(np.int32)).to(cuda)
    starts = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    idx = torch.from_numpy(rng.integers(-n, n + 1, int(lens.sum()))
                           .astype(np.int32)).to(cuda)
    for affine, tbl in ((True, p[:, :2].contiguous()), (False, q)):
        assert torch.equal(
            dg1.accumulate_csr(tbl, affine, idx, starts, lens),
            dg1.accumulate_csr_plain(tbl, affine, idx, starts, lens))


@pytest.mark.gpu
def test_walk_wrapper_rejects_bad_csr(cuda):
    """The walk's wrapper refuses a strided index tensor (its pointer
    would be read as dense), a row that runs past the end of idx and an
    index outside the table, before anything is launched."""
    tbl = torch.stack([_words(64, dev.FP, 30 + k, cuda) for k in range(2)], 1)
    idx = torch.arange(1, 65, dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 16], dtype=torch.int32, device=cuda)
    lens = torch.tensor([16, 16], dtype=torch.int32, device=cuda)
    before = kernels.counts()["g1_csr_walk"]
    with pytest.raises(ValueError, match="contiguous"):
        dg1.accumulate_csr(tbl, True, idx[::2], starts, lens)
    with pytest.raises(IndexError):
        dg1.accumulate_csr(tbl, True, idx[:20], starts, lens)
    bad = idx.clone()
    bad[3] = -65
    with pytest.raises(IndexError):
        dg1.accumulate_csr(tbl, True, bad, starts, lens)
    assert kernels.counts()["g1_csr_walk"] == before
    dg1.accumulate_csr(tbl, True, idx, starts, lens)
    assert kernels.counts()["g1_csr_walk"] == before + 1
