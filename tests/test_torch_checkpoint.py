"""The port's checkpoints (tpu_plonk_torch.utils.checkpoint), following
tests/test_utils.py: the transcript's state round-trips, and a
checkpointed prove_device (plain versions on the CPU, commits by the
host MSM as in tests/test_torch_prove.py) that fails in round 3 resumes
from rounds 1-2 without recomputing them and gives the golden fixture's
bytes; `cli demo --checkpoint` resumes every round."""

import json
import os

import pytest
import torch

from tpu_plonk.pcs import srs as jsrs
from tpu_plonk.transcript import Transcript as JTranscript

from tpu_plonk_torch import cli
from tpu_plonk_torch.pcs.commit_device import DeviceCommitter
from tpu_plonk_torch.proof_system import engine_device
from tpu_plonk_torch.proof_system.preprocess import preprocess_device
from tpu_plonk_torch.transcript import Transcript
from tpu_plonk_torch.utils import checkpoint
from tpu_plonk_torch.utils.config import parse_args

import torch_dist_ranks
from torch_host_commit import host_commits

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "vectors",
                       "golden_proof.hex")


def test_checkpoint_transcript_roundtrip(tmp_path):
    t = Transcript(b"ckpt test")
    t.append_scalar(b"a", 123)
    mid_state = checkpoint.transcript_state(t)
    c1 = t.challenge_scalar(b"c")
    path = str(tmp_path / "state.pkl")
    checkpoint.save(path, {"transcript": mid_state, "round": 2})
    assert os.listdir(tmp_path) == ["state.pkl"]
    loaded = checkpoint.load(path)
    t2 = checkpoint.restore_transcript(loaded["transcript"])
    assert t2.challenge_scalar(b"c") == c1
    assert loaded["round"] == 2
    # the reference's transcript gives the same challenge
    jt = JTranscript(b"ckpt test")
    jt.append_scalar(b"a", 123)
    assert jt.challenge_scalar(b"c") == c1


def test_host_data_roundtrip():
    x = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    value = ([x, x[1]], (3, None), {"p": (5, 7), "t": x})
    host = checkpoint.to_host(value)
    assert not any(isinstance(v, torch.Tensor) for v in host[0])
    back = checkpoint.to_device(host, "cpu")
    assert torch.equal(back[0][0], x) and torch.equal(back[2]["t"], x)
    assert back[1] == (3, None) and back[2]["p"] == (5, 7)


@pytest.fixture(scope="module")
def golden():
    cs = torch_dist_ranks.golden_circuit()
    n = cs.padded_size()
    com = DeviceCommitter(jsrs.cached_setup(n + 8), n + 8, device="cpu")
    with host_commits():
        pk, vk = preprocess_device(cs, com, device="cpu")
    return cs, pk, com


def test_prove_resumes_after_a_failure_in_round_3(golden, tmp_path,
                                                  monkeypatch):
    cs, pk, com = golden
    path = str(tmp_path / "prove.ckpt")
    calls = []

    def broken(*args):
        raise RuntimeError("round 3 fails on purpose")

    with host_commits():
        with monkeypatch.context() as mp:
            mp.setattr(engine_device, "quotient_phase_dev", broken)
            with pytest.raises(RuntimeError, match="on purpose"):
                engine_device.prove_device(
                    cs, pk, com, device="cpu",
                    ckpt=checkpoint.RoundCheckpoint(path))
        assert checkpoint.RoundCheckpoint(path).completed() == ["r1", "r2"]
        commit = DeviceCommitter.commit
        monkeypatch.setattr(DeviceCommitter, "commit",
                            lambda self, c: calls.append(1) or commit(self, c))
        ck = checkpoint.RoundCheckpoint(path)
        proof = engine_device.prove_device(cs, pk, com, device="cpu",
                                           ckpt=ck)
        # rounds 1-2 (4 wire commits and z's) load; 4 chunks + 2 openings
        assert len(calls) == 6
        assert ck.completed() == ["r1", "r2", "r3", "r4", "r5"]
        again = engine_device.prove_device(
            cs, pk, com, device="cpu", ckpt=checkpoint.RoundCheckpoint(path))
    assert len(calls) == 6
    with open(FIXTURE) as f:
        want = f.read().strip()
    assert proof.to_bytes().hex() == want == again.to_bytes().hex()


def test_cli_demo_checkpoint(golden, tmp_path, monkeypatch, capsys):
    """`demo --checkpoint` on the golden circuit (and the fixture's
    committer, not a new SRS table): the second run loads all five rounds
    and still verifies."""
    assert parse_args(["--checkpoint", "x"]).checkpoint == "x"
    assert parse_args([]).checkpoint == ""
    monkeypatch.setattr(cli, "_mock_circuit",
                        torch_dist_ranks.golden_circuit)
    monkeypatch.setattr(cli, "_committer", lambda n, cfg: golden[2])
    path = str(tmp_path / "demo.ckpt")
    argv = ["demo", "--engine", "host", "--checkpoint", path]
    with host_commits():
        for resumed in (None, 5):
            assert cli.main(argv) == 0
            out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert out["verified"] is True
            assert out.get("resumed_rounds") == resumed
