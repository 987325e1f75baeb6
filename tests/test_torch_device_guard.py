"""The port's entry points refuse a CUDA device other than the current
one: its kernels launch on the current device's stream, so a call on
cuda:1 with cuda:0 current would hand card-1 pointers to card 0.  Checked
on the CPU with torch.cuda's device queries patched."""

import pytest
import torch

from tpu_plonk_torch import kernels
from tpu_plonk_torch.proof_system.engine_device import (
    check_committer, prove_device)
from tpu_plonk_torch.proof_system.preprocess import preprocess_device


@pytest.fixture
def current(monkeypatch):
    """Pretend a card is present; returns a setter for the current
    device's index."""
    state = {"index": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["index"])
    return lambda i: state.update(index=i)


class _Committer:
    """Stands for a committer or a DevicePK: only its device is read."""

    def __init__(self, device):
        self.device = torch.device(device)


class _CardWords:
    """Stands for an int32 (4, 12) tensor on a card: what check_words
    reads of it."""
    dtype = torch.int32
    shape = (4, 12)

    def __init__(self, device):
        self.device = torch.device(device)

    def is_contiguous(self):
        return True

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("index", [0, 1])
def test_resolve_device_fills_in_and_checks_the_index(current, index):
    current(index)
    here = torch.device("cuda", index)
    assert kernels.resolve_device() == here
    assert kernels.resolve_device("cuda") == here
    assert kernels.resolve_device(f"cuda:{index}") == here
    assert kernels.resolve_device("cpu") == torch.device("cpu")
    other = f"cuda:{1 - index}"
    with pytest.raises(ValueError, match=f"{other}.*cuda:{index}"):
        kernels.resolve_device(other)


def test_check_committer_compares_whole_devices(current):
    assert check_committer(_Committer("cuda:0"), None) == \
        torch.device("cuda", 0)
    assert check_committer(_Committer("cuda:0"), "cuda") == \
        torch.device("cuda", 0)
    assert check_committer(_Committer("cpu"), "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="committer lives on cuda:1"):
        check_committer(_Committer("cuda:1"), None)
    with pytest.raises(ValueError, match="committer lives on cpu"):
        check_committer(_Committer("cpu"), None)
    with pytest.raises(ValueError, match="cuda:1.*cuda:0"):
        check_committer(_Committer("cuda:1"), "cuda:1")


def test_entry_points_refuse_another_card_first(current):
    """prove_device and preprocess_device check the device before they
    touch their other arguments."""
    with pytest.raises(ValueError, match="committer lives on cuda:1"):
        prove_device(None, None, _Committer("cuda:1"))
    with pytest.raises(ValueError, match="cuda:1.*cuda:0"):
        preprocess_device(None, _Committer("cuda:1"), device="cuda:1")


def test_prove_device_refuses_a_dpk_on_another_card(current):
    """A DevicePK built under another current device does not reach a
    kernel with a committer on this one."""
    with pytest.raises(ValueError, match="dpk lives on cuda:1"):
        prove_device(None, None, _Committer("cuda:0"),
                     dpk=_Committer("cuda:1"))


@pytest.mark.parametrize("index", [0, 1])
def test_check_words_refuses_a_tensor_on_another_card(current, index):
    """Every kernel wrapper checks its operands with check_words, so a
    tensor on a card other than the current one never reaches a launch."""
    current(index)
    kernels.check_words(_CardWords(f"cuda:{index}"), 12, "x")
    with pytest.raises(ValueError,
                       match=f"x: tensor lives on cuda:{1 - index}.*"
                             f"cuda:{index}"):
        kernels.check_words(_CardWords(f"cuda:{1 - index}"), 12, "x")
