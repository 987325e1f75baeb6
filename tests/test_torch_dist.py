"""The port's mesh path (tpu_plonk_torch.dist) on the CPU: ranks spawned
by multihost.launch, joined on gloo through a file store in tmp_path,
running the plain versions (tests/torch_dist_ranks.py holds their
programs).

- The sharded NTT, iNTT, phase-scaled NTT and coset pair at D = 2 (n =
  64) and D = 4 (n = 128) against the reference's single-device
  `tpu_plonk.poly.ntt` functions and the host `Domain(n)`, exactly.
- The ShardedCommitter's commitment (from host points and from a whole
  table), msm_sharded and high_g1 against the reference's host MSM and
  the SRS rows.
- A two-rank mesh prove of the golden circuit, unblinded and blinded
  (seed b"golden-zk"), on both ranks against tests/vectors/golden_proof
  .hex and golden_proof_zk.hex.  Its commits gather and fold the ranks'
  window sums as on the card, but each rank's sums come from the host
  MSM of its rows (torch_dist_ranks.host_window_sums), which keeps the
  test within seconds; the plain CSR pipeline under a rank's sums is
  the one held against the host MSM above.

The reference's own sharded programs are not run here: their tests
(tests/test_dist.py, test_dist_prover.py) hold them equal to the
single-device functions this file compares with."""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from tpu_plonk.params import R_MOD
from tpu_plonk.curves import g1 as jg1
from tpu_plonk.pcs import msm as jmsm
from tpu_plonk.pcs import srs as jsrs
from tpu_plonk.poly import ntt as jntt
from tpu_plonk.poly.domain import Domain

from tpu_plonk_torch.dist import multihost
from tpu_plonk_torch.dist.mesh import make_mesh
from tpu_plonk_torch.dist.ntt_sharded import split
from tpu_plonk_torch.fields import device as tdev
from tpu_plonk_torch.pcs.commit_device import DeviceCommitter
from tpu_plonk_torch.proof_system.preprocess import preprocess_device_cached

import torch_dist_ranks as ranks
from torch_host_commit import host_commits

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
SCALE = 0x1234567
GOLDEN_SEED = b"golden-zk"


def _fixture(name):
    with open(os.path.join(VECTORS, name)) as f:
        return f.read().strip()


def _coeffs(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n)]


@pytest.fixture(scope="module")
def inputs():
    """Per rank count D: the batch to transform (n = 32 D), the commit's
    points and scalars."""
    out = {}
    for d in (2, 4):
        log_n = 4 + d.bit_length()              # 64 at D = 2, 128 at D = 4
        vals = [_coeffs(1 << log_n, 10 * d + k) for k in range(2)]
        rng = np.random.default_rng(d)
        m = 37 * d + 3                   # shards of unequal length
        pts = [jg1.mul(jg1.GEN, int.from_bytes(rng.bytes(32), "little")
                       % R_MOD) for _ in range(m)]
        out[d] = {"log_n": log_n, "vals": vals,
                  "words": np.stack([ranks.limbs_of(v) for v in vals]),
                  "points": pts, "scalars": _coeffs(m, 99 + d)}
    return out


@pytest.fixture(scope="module")
def ran(inputs, tmp_path_factory):
    """One launch per rank count, both at once, each rank's results by
    program: the transforms and the commit; at D = 2 also the golden
    proves, through a preprocess cache written here."""
    cs = ranks.golden_circuit()
    n = cs.padded_size()
    srs = jsrs.cached_setup(n + 8)
    cache = str(tmp_path_factory.mktemp("golden_cache"))
    with host_commits():
        preprocess_device_cached(cs, DeviceCommitter(srs, n + 8, device="cpu"),
                                 cache, device="cpu")
    runs = {}
    with concurrent.futures.ThreadPoolExecutor(len(inputs)) as pool:
        for d, inp in inputs.items():
            jobs = [("transforms", (inp["words"], inp["log_n"], (SCALE,))),
                    ("commit", (inp["points"], inp["scalars"]))]
            if d == 2:
                jobs.append(("golden_prove", (list(srs.powers_g1[:n + 8]),
                                              cache, [None, GOLDEN_SEED])))
            runs[d] = pool.submit(multihost.launch, ranks.run, d, (jobs,),
                                  backend="gloo", device="cpu",
                                  store_dir=cache)
        return {d: run.result() for d, run in runs.items()}


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_transforms_match_reference(inputs, ran, d):
    """Every rank's gathered result against the reference's host-int
    transforms (tpu_plonk.poly.ntt.ntt_ints) and Domain(n)."""
    inp = inputs[d]
    log_n, vals = inp["log_n"], inp["vals"]
    n = 1 << log_n
    dom = Domain(n)
    spow = [pow(SCALE, j, R_MOD) for j in range(n)]
    want = {"ntt": [jntt.ntt_ints(v, log_n) for v in vals],
            "intt": [jntt.ntt_ints(v, log_n, inverse=True) for v in vals],
            f"scaled_{SCALE}": [dom.ntt([a * b % R_MOD
                                         for a, b in zip(v, spow)])
                                for v in vals],
            "coset_ntt": [jntt.ntt_ints(vals[0], log_n, coset=True)],
            "coset_intt": [jntt.ntt_ints(vals[0], log_n, inverse=True,
                                         coset=True)]}
    assert want["ntt"][0] == dom.ntt(vals[0])
    assert want["coset_intt"][0] == dom.coset_intt(vals[0])
    for got in ran[d]:                             # every rank, whole
        res = got["transforms"]
        assert set(res) == set(want)
        for k, w in want.items():
            assert [tdev.words_to_ints(torch.from_numpy(row), True, tdev.FR)
                    for row in res[k]] == w, (d, k)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_commit_matches_host_msm(inputs, ran, d):
    pts, sc = inputs[d]["points"], inputs[d]["scalars"]
    want = jmsm.msm(pts, sc)
    for got in ran[d]:
        cm, cm_table, cm_msm, highs = got["commit"]
        assert cm == cm_table == cm_msm == want
        assert highs == tuple(pts[-3:])


@pytest.mark.parametrize("seed,fixture", [(None, "golden_proof.hex"),
                                          (GOLDEN_SEED, "golden_proof_zk.hex")])
def test_mesh_prove_golden_bytes(ran, seed, fixture):
    k = 0 if seed is None else 1
    want = _fixture(fixture)
    for got in ran[2]:                               # both ranks
        assert got["golden_prove"][k].hex() == want


def test_split_and_mesh_of_one():
    """The R / C split (the reference's rule), and a process without a
    group as a mesh of one whose collectives are the identity."""
    assert split(6, 2) == 3 and split(7, 4) == 3 and split(20, 2) == 10
    with pytest.raises(ValueError):
        split(2, 4)
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    x = torch.arange(12, dtype=torch.int32).reshape(1, 3, 4)
    assert torch.equal(multihost.all_to_all(mesh, x), x)
    assert torch.equal(multihost.allgather(mesh, x, dim=1), x)
    assert torch.equal(multihost.global_put(mesh, x, dim=1), x)
    assert multihost.is_coordinator()
    multihost.initialize("localhost:1", 1, 0)        # one process: no-op
    with pytest.raises(ValueError):
        multihost.initialize("localhost:1", 2, 0, backend="mpi")


def test_graft_entry_round_trip_on_cpu():
    """graft_entry.entry: the NTT round trip at 2^12 gives its input back;
    the dryrun's circuit pads to 8 x 8.  (dryrun_multichip itself runs
    on the card, tests/test_torch_gpu.py: on the CPU its plain CSR walks
    take minutes.)"""
    from tpu_plonk_torch import graft_entry
    fn, (x,) = graft_entry.entry(device="cpu")
    assert x.shape == (1 << graft_entry.LOG_N, 8)
    assert torch.equal(fn(x), x)
    assert graft_entry.tiny_circuit().padded_size() == 64
