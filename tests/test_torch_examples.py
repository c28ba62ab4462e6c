"""The port's examples (``examples/torch_*.py``) run on the CPU when asked
to, at small sizes, and refuse to start without a card otherwise: every
entry point defaults to ``cuda`` and never falls back."""

import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_checkpoints_resumes_and_monitors(capsys):
    trainer = _load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(trainer.history) == 8 and trainer.history[-1].val_metrics["acc"] > 0.9
    assert "'crash' -> resume" in out and "schedule (8 decisions)" in out


def test_synthetic_convex_runs_every_method(tmp_path):
    results = _load("torch_synthetic_convex").main(
        ["--device", "cpu", "--epochs", "1", "--out", str(tmp_path / "r.json")])
    assert sorted(results) == sorted(f"{t}/{m}" for t in ("convex", "nonconvex")
                                     for m in ("sgd", "divebatch", "oracle"))
    assert (tmp_path / "r.json").exists()


def test_resnet_cifar_runs(tmp_path):
    out = _load("torch_train_resnet_cifar").main(
        ["--device", "cpu", "--epochs", "1", "--n", "320", "--methods", "sgd,divebatch",
         "--out", str(tmp_path / "r.json")])
    assert sorted(out) == ["divebatch", "sgd"] and all(len(v) == 1 for v in out.values())


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_synthetic_convex",
                                  "torch_train_resnet_cifar"])
def test_examples_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _load(name).main(["--out", str(tmp_path / "r.json")] if name != "torch_quickstart"
                         else [])
