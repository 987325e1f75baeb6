"""Each CUDA kernel of the port against its plain PyTorch version on the
card, exact.  Marked `gpu`; without a card every test skips (decided in
the fixture, so every xdist worker collects the same tests).  This file
imports no JAX, so it runs on the card's machine with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from tpu_plonk_torch import kernels
from tpu_plonk_torch.fields import device as dev
from tpu_plonk_torch.poly import ntt
from tpu_plonk_torch.curves import device_g1 as dg1
from tpu_plonk_torch.pcs import msm_csr
from tpu_plonk_torch.proof_system import quotient


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


def _rand_words(count, seed, device):
    """count random Fr words below 2^254 < r, made by numpy (the large
    sizes would take Python ints seconds)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    raw[:, 7] &= (1 << 30) - 1
    return torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("log_n,batch", [(1, 3), (4, 3), (11, 3), (18, 6),
                                         (20, 2), (22, 1)])
def test_ntt_kernel_matches_plain(cuda, log_n, batch):
    """Every pass plan: one tile (2^1, 2^4), two uneven passes (2^11),
    two (2^18 at the quotient phases' batch, 2^20) and three (2^22);
    forward, inverse, coset forward and coset inverse, exact."""
    n = 1 << log_n
    if log_n < 18:
        x = _words(batch * n, dev.FR, log_n, cuda).reshape(batch, n, 8)
    else:
        x = _rand_words(batch * n, log_n, cuda).reshape(batch, n, 8)
    for inverse, scale in ((False, 1), (True, 1), (False, 7), (True, 11)):
        before = kernels.counts()
        got = ntt.ntt_many(x, log_n, inverse, scale)
        after = kernels.counts()
        assert after["ntt"] == before["ntt"] + 1
        assert torch.equal(got, ntt.transform_plain(x, log_n, inverse, scale))
    # a warm inverse call launches the pass kernel (one launch a pass of
    # pass_plan, at most 3) and nothing else: no separate multiply.  The
    # trace bounds the count from above only: CUPTI has been seen to miss
    # one of the three records at 2^22 (PERF.md, PR 7)
    from torch.profiler import profile, ProfilerActivity
    ntt.ntt_many(x, log_n, True, 11)
    torch.cuda.synchronize()
    before = kernels.counts()["fr_mont_mul"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ntt.ntt_many(x, log_n, True, 11)
        torch.cuda.synchronize()
    assert kernels.counts()["fr_mont_mul"] == before
    rows = {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}
    assert [k for k in rows if "pass_kernel" not in k] == []
    assert 1 <= sum(rows.values()) <= len(ntt.pass_plan(log_n)) <= 3


@pytest.mark.gpu
def test_wrappers_refuse_misaligned_rows(cuda):
    """The NTT and K6 load 16 bytes at a time: an operand one word off a
    16-byte boundary is refused before any launch."""
    n = 1 << 4
    flat = _words(3 * n + 1, dev.FR, 60, cuda).flatten()
    x = flat[1:1 + 3 * n * 8].view(3, n, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = kernels.counts()
    with pytest.raises(ValueError, match="aligned"):
        ntt.ntt_many(x, 4)
    vecs = [_words(n, dev.FR, 61 + k, cuda)
            for k in range(len(quotient.IN_NAMES))]
    vecs[3] = flat[1:1 + n * 8].view(n, 8)
    ins = dict(zip(quotient.IN_NAMES, vecs))
    one = vecs[0][:1]
    args = ({w: ins[w] for w in "abcd"}, ins["z"], ins["pi"],
            {k: ins[k] for k in quotient.SEL_ORDER},
            [ins[f"sigma{j}"] for j in range(1, 5)], ins["xpts"], one,
            dict.fromkeys(("beta", "gamma", "range", "logic", "fixed",
                           "vgadd"), one), one, ins["l1"])
    with pytest.raises(ValueError, match="aligned"):
        quotient.quotient_phase_kernel(*args)
    assert kernels.counts() == before


@pytest.mark.gpu
def test_g1_kernels_match_plain(cuda):
    n = 2048
    p = torch.stack([_words(n, dev.FP, 10 + k, cuda) for k in range(3)], 1)
    q = torch.stack([_words(n, dev.FP, 20 + k, cuda) for k in range(3)], 1)
    q[:8] = p[:8]
    p[8:16] = dg1.identity((8,), cuda)
    q[16:24, 0], q[16:24, 2] = p[16:24, 0], p[16:24, 2]     # P - P
    q[16:24, 1] = dev.sub_mod_plain(torch.zeros_like(p[16:24, 1]),
                                    p[16:24, 1], dev.FP)
    assert torch.equal(dg1.add(p, q), dg1.add_plain(p, q))
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
def test_walk_edge_rows_match_plain(cuda):
    """Rows of length 0 and 1, a row of pads only, leading and trailing
    pads, a point added to itself and to its negation, on both tables."""
    n = 64
    p = torch.stack([_words(n, dev.FP, 40 + k, cuda) for k in range(3)], 1)
    rows = [[], [5], [0, 0, 0], [0, 0, 7, -3], [9, 0], [4, 4, 4],
            [6, -6, 2], [-1], [0], list(range(1, 40))]
    lens = torch.tensor([len(r) for r in rows], dtype=torch.int32,
                        device=cuda)
    starts = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    idx = torch.tensor(sum(rows, []), dtype=torch.int32, device=cuda)
    for affine, tbl in ((True, p[:, :2].contiguous()), (False, p)):
        kname = "g1_csr_walk" if affine else "g1_csr_walk_proj"
        before = kernels.counts()[kname]
        got = dg1.accumulate_csr(tbl, affine, idx, starts, lens)
        assert kernels.counts()[kname] == before + 1
        assert torch.equal(
            got, dg1.accumulate_csr_plain(tbl, affine, idx, starts, lens))
        # the kernel gathers 16 bytes at a time: a table one word off a
        # 16-byte boundary is refused before any launch
        flat = torch.cat([tbl.new_zeros(1), tbl.flatten()])
        with pytest.raises(ValueError, match="aligned"):
            dg1.accumulate_csr(flat[1:].view(tbl.shape), affine, idx,
                               starts, lens)
        assert kernels.counts()[kname] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("c", [4, 11, 13])
def test_weighting_kernel_matches_plain(cuda, c):
    """The bucket weighting at the port's window widths (B = 8, 1,024,
    4,096 buckets, W = 3), with identity buckets, at the window's ends
    and inside it, and two equal adjacent buckets."""
    W, B = 3, 1 << (c - 1)
    bk = torch.stack([_words(W * B, dev.FP, 50 + c + k, cuda)
                      for k in range(3)], 1).reshape(W, B, 3, 12)
    bk[0, 0] = dg1.identity((), cuda)
    bk[0, B - 1] = dg1.identity((), cuda)
    bk[1, B // 2:] = dg1.identity((), cuda)
    bk[2, 5] = bk[2, 4]
    before = kernels.counts()["g1_bucket_weight"]
    got = msm_csr.weighted_window_sums(bk)
    assert kernels.counts()["g1_bucket_weight"] == before + 1
    assert torch.equal(got, msm_csr.weighted_window_sums_plain(bk))


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


@pytest.mark.gpu
def test_quotient_kernel_matches_plain(cuda):
    """K6 on a size that is not a multiple of the block (the grid-stride
    tail and the wrap of the next row at n - 1)."""
    n = (1 << 12) + 5
    vecs = [_words(n, dev.FR, 100 + k, cuda)
            for k in range(len(quotient.IN_NAMES))]
    ins = dict(zip(quotient.IN_NAMES, vecs))
    rng = np.random.default_rng(7)
    scal = [dev.ints_to_words([int.from_bytes(rng.bytes(32), "little")
                               % dev.FR.modulus], dev.FR, cuda)
            for _ in range(8)]
    ch = dict(zip(("beta", "gamma", "range", "logic", "fixed", "vgadd"),
                  scal[:6]))
    args = ({w: ins[w] for w in "abcd"}, ins["z"], ins["pi"],
            {k: ins[k] for k in quotient.SEL_ORDER},
            [ins[f"sigma{j}"] for j in range(1, 5)], ins["xpts"],
            scal[6], ch, scal[7], ins["l1"])
    before = kernels.counts()["quotient_phase"]
    got = quotient.quotient_phase_kernel(*args)
    assert kernels.counts()["quotient_phase"] == before + 1
    assert torch.equal(got, quotient.quotient_phase_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name,blind", [
    ("mock_circuit", []), ("mock_circuit_zk", ["--blind", "mock-zk"])])
def test_cli_prove_matches_reference_fixtures(cuda, tmp_path, name, blind):
    """`cli prove` on the card writes the MockCircuit artifacts that the
    reference's CLI wrote (tests/vectors/mock_circuit*), byte for byte,
    and `cli verify` accepts them."""
    from tpu_plonk_torch import cli
    out = str(tmp_path / name)
    assert cli.main(["prove", "--engine", "device", "--out", out]
                    + blind) == 0
    vectors = os.path.join(os.path.dirname(__file__), "vectors")
    for ext in ("proof", "vk", "pi"):
        with open(f"{out}.{ext}", "rb") as f, \
                open(os.path.join(vectors, f"{name}.{ext}"), "rb") as g:
            assert f.read() == g.read(), ext
    assert cli.main(["verify", "--out", out]) == 0


def _sharded_vs_single(mesh, log_n, batch):
    """One nccl rank: the sharded four-step against ntt_many on the same
    words, forward, inverse and scaled; returns the cases that differ."""
    x = _rand_words(batch << log_n, log_n, mesh.device).reshape(
        batch, 1 << log_n, 8)
    from tpu_plonk_torch.dist.ntt_sharded import ntt_replicated
    bad = []
    for inverse, scale in ((False, 1), (True, 1), (False, 7), (True, 11)):
        if not torch.equal(ntt_replicated(mesh, x, log_n, inverse, scale),
                           ntt.ntt_many(x, log_n, inverse, scale)):
            bad.append((log_n, inverse, scale))
    return bad


@pytest.mark.gpu
def test_sharded_ntt_nccl_matches_ntt_many(cuda, tmp_path):
    """The four-step on an nccl group of one (its all_to_all and
    all_gather are real nccl calls) equals the single-device kernel."""
    from tpu_plonk_torch.dist import multihost
    kernels.library()
    for log_n, batch in ((12, 3), (18, 2)):
        assert multihost.launch(_sharded_vs_single, 1, (log_n, batch),
                                backend="nccl", store_dir=str(tmp_path),
                                timeout=300) == [[]]


@pytest.mark.gpu
def test_dryrun_multichip_two_ranks_one_card(cuda):
    """graft_entry's dryrun on two gloo ranks sharing the card: sharded
    NTT and commit against host oracles, the mesh proof equal to the
    single-device one and verified."""
    from tpu_plonk_torch import graft_entry
    graft_entry.dryrun_multichip(2)
    fn, (x,) = graft_entry.entry()
    assert x.is_cuda and torch.equal(fn(x), x)


@pytest.mark.gpu
def test_poseidon_kernels_match_plain(cuda):
    """The batched permutation and sponge through the field kernels equal
    their plain versions on the card (one absorption and three)."""
    from tpu_plonk_torch.gadgets import poseidon_device as pd
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % dev.FR.modulus
            for _ in range(5 * 1000)]
    st = dev.ints_to_words(vals, dev.FR, cuda, mont=True).reshape(1000, 5, 8)
    before = kernels.counts()
    assert torch.equal(pd.permute_device(st), pd.permute_plain(st))
    after = kernels.counts()
    assert after["fr_mont_mul"] > before["fr_mont_mul"]
    assert after["fr_add_sub"] > before["fr_add_sub"]
    for ln in (3, 9):
        msgs = [vals[i:i + ln] for i in range(0, 64 * ln, ln)]
        assert pd.sponge_hash_device(msgs) == pd.sponge_hash_plain(msgs,
                                                                   cuda)
