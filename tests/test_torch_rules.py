"""Rules of the port: nothing under tpu_plonk_torch/, nothing in
chip_smoke.py and no scripts/torch_*.py imports jax or the reference
package, and the entry points default to the card, raising when there is
none instead of running on the CPU."""

import ast
import glob
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += sorted(glob.glob(os.path.join(ROOT, "scripts", "torch_*.py")))
    for base, _dirs, files in os.walk(os.path.join(ROOT, "tpu_plonk_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return out


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "tpu_plonk")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_the_card(tmp_path):
    from tpu_plonk_torch import cli, kernels
    from tpu_plonk_torch.circuits import Circuit
    from tpu_plonk_torch.pcs import srs_device
    from tpu_plonk_torch.pcs.commit_device import DeviceCommitter
    from tpu_plonk_torch.proof_system.engine_device import prove_device
    from tpu_plonk_torch.proof_system.preprocess import (
        preprocess_device, preprocess_device_cached)
    if torch.cuda.is_available():
        assert kernels.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srs_device.device_srs_points(8)

    class _SRS:
        powers_g1 = [None] * 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCommitter(_SRS(), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove_device(None, None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_device(None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_device_cached(None, None)
    class _Circuit(Circuit):
        def gadget(self, composer):
            composer.add_input(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _Circuit().compile(_SRS())
    out = str(tmp_path / "p")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["prove", "--out", out])
    assert not os.listdir(tmp_path)
