"""The port's command line on the CPU: `verify` accepts the MockCircuit
artifacts that the reference's CLI wrote (tests/vectors/mock_circuit*,
`python -m tpu_plonk.cli prove --out ...`, unblinded and `--blind
mock-zk`) and rejects a copy with one bit flipped, `info` reports the
CPU, and the usage errors return 2.  The card's `prove`, which must
write the same bytes, is tests/test_torch_gpu.py's
`test_cli_prove_matches_reference_fixtures`."""

import json
import os
import shutil

import pytest

from tpu_plonk_torch import cli
from tpu_plonk_torch.utils.config import parse_args

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["mock_circuit", "mock_circuit_zk"])
def test_verify_accepts_reference_artifacts_and_rejects_a_flipped_bit(
        name, tmp_path, capsys):
    src = os.path.join(VECTORS, name)
    assert cli.main(["verify", "--out", src]) == 0
    assert _last_json(capsys)["verified"] is True
    bad = str(tmp_path / name)
    for ext in ("proof", "vk", "pi"):
        shutil.copy(f"{src}.{ext}", f"{bad}.{ext}")
    with open(f"{bad}.proof", "r+b") as f:
        data = bytearray(f.read())
        data[-40] ^= 1               # one bit of an opening evaluation
        f.seek(0)
        f.write(data)
    assert cli.main(["verify", "--out", bad]) == 1
    assert _last_json(capsys)["verified"] is False


def test_info_reports_the_cpu(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["info"]) == 0
    out = _last_json(capsys)
    assert out["devices"] == ["cpu"] and out["backend"] == "cpu"
    assert out["torch"] == torch.__version__


@pytest.mark.parametrize("argv", [[], ["nope"], ["prove"], ["verify"]])
def test_usage_errors_return_2(argv):
    assert cli.main(argv) == 2


def test_engine_names_the_device():
    """`device` is the card (None: the entry points' default), `host`
    the CPU, and the card is the default."""
    assert parse_args([]).device is None
    assert parse_args(["--engine", "device"]).device is None
    assert parse_args(["--engine", "host"]).device == "cpu"
