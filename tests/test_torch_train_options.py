"""The port's trainer CLI options ``auto_restart`` and ``detect_anomaly``,
as the top-level ``train.py`` applies them (restart after any ``Exception``
but ``KeyboardInterrupt``; anomaly mode around the training, put back after)."""
import importlib

import pytest
import torch

from nerf_tpu_torch.config import default_cfg

train_main = importlib.import_module("nerf_tpu_torch.train.__main__")
ARGV = ["--device", "cpu", "task_arg.N_rays", "32", "mesh_devices", "1"]


class FlakyTrain:
    """A stand-in for ``loop.train`` that raises ``errors`` in turn, then
    returns "done"; it records the anomaly mode and ``resume`` of each call."""

    def __init__(self, *errors):
        self.errors = list(errors)
        self.calls = []

    def __call__(self, cfg, device=None):
        self.calls.append({"anomaly": torch.is_anomaly_enabled(), "resume": cfg["resume"]})
        if self.errors:
            raise self.errors.pop(0)
        return "done"


def test_detect_anomaly_defaults_to_false_as_jax():
    assert default_cfg()["detect_anomaly"] is False


@pytest.mark.parametrize("error", [OSError("disk full"), ValueError("bad batch"),
                                   RuntimeError("nan"), FloatingPointError("inf")])
def test_auto_restart_resumes_after_any_exception(monkeypatch, error):
    fake = FlakyTrain(error)
    monkeypatch.setattr(train_main, "train", fake)
    assert train_main.main(ARGV + ["auto_restart", "1", "resume", "False"]) == "done"
    assert [c["resume"] for c in fake.calls] == [False, True]


def test_without_auto_restart_the_error_is_raised(monkeypatch):
    fake = FlakyTrain(OSError("disk full"))
    monkeypatch.setattr(train_main, "train", fake)
    with pytest.raises(OSError, match="disk full"):
        train_main.main(ARGV + ["auto_restart", "0"])
    assert len(fake.calls) == 1


def test_auto_restart_gives_up_after_its_count(monkeypatch):
    fake = FlakyTrain(OSError("a"), OSError("b"), OSError("c"))
    monkeypatch.setattr(train_main, "train", fake)
    with pytest.raises(OSError, match="c"):
        train_main.main(ARGV + ["auto_restart", "2"])
    assert len(fake.calls) == 3


def test_keyboard_interrupt_is_never_retried(monkeypatch):
    fake = FlakyTrain(KeyboardInterrupt())
    monkeypatch.setattr(train_main, "train", fake)
    with pytest.raises(KeyboardInterrupt):
        train_main.main(ARGV + ["auto_restart", "5"])
    assert len(fake.calls) == 1


@pytest.mark.parametrize("before", [False, True])
@pytest.mark.parametrize("raises", [False, True])
def test_detect_anomaly_is_on_in_the_call_and_restored_after(monkeypatch, before, raises):
    fake = FlakyTrain(*([OSError("x")] if raises else []))
    monkeypatch.setattr(train_main, "train", fake)
    torch.autograd.set_detect_anomaly(before)
    try:
        if raises:
            with pytest.raises(OSError):
                train_main.main(ARGV + ["detect_anomaly", "True"])
        else:
            assert train_main.main(ARGV + ["detect_anomaly", "True"]) == "done"
        assert fake.calls[0]["anomaly"] is True
        assert torch.is_anomaly_enabled() is before
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_anomaly_mode_is_left_alone_without_the_option(monkeypatch):
    fake = FlakyTrain()
    monkeypatch.setattr(train_main, "train", fake)
    train_main.main(ARGV)
    assert fake.calls[0]["anomaly"] is False
