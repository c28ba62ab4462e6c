"""The port's examples (``examples/torch_*.py``) run on the CPU when asked
to, at small sizes, and refuse to start without a card otherwise: every
entry point defaults to ``cuda`` and never falls back.  The LM examples are
held against the reference's (``examples/serve_lm.py``,
``examples/train_lm.py``) on the reference's weights, carried across."""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.interop import params_from_jax

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


def _reference(name, argv, monkeypatch, capsys) -> str:
    """The reference example ``name``'s printed output on ``argv``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    _load(name).main()
    return capsys.readouterr().out


def test_serve_lm_matches_the_reference_example(monkeypatch, capsys):
    """``torch_serve_lm.serve`` on the reference example's weights (its JAX
    init, carried across) on eight CPU entries: the reference example's
    printed tokens and reshard count, with its 8 forced host devices."""
    out = _reference("serve_lm", [], monkeypatch, capsys)
    want = [[int(t) for t in m.split(", ")]
            for m in re.findall(r"req \d+: \d+ tokens -> \[(.*)\]", out)]
    reshards = int(re.search(r"elastic: dp=\[1, 2, 4, 8\] reshards=(\d+)", out)[1])
    mod = _load("torch_serve_lm")
    cfg = mod.model_config()
    jparams = jtf.init_params(_load("serve_lm").get_config("yi-6b", reduced=True).replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2), jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    ladder = mod.MeshLadder(["cpu"] * 8, granule=1)
    results, engine = mod.serve(cfg, params, ladder)
    assert len(want) == 4 and [r.tokens.tolist() for r in results[:4]] == want
    assert engine.stats.reshards == reshards >= 1


def test_train_lm_holds_the_reference_schedule(monkeypatch, capsys):
    """``torch_train_lm.run`` on the reference example's weights and flags:
    the reference example's batch schedule exactly, its printed losses within
    1e-4 relative, and the same lines (a tick line every 2 steps, the step
    lines, the closing ``done.`` line)."""
    flags = ["--steps", "6", "--seq-len", "16", "--micro-batch", "2", "--m0", "4",
             "--m-max", "16", "--epoch-steps", "2"]
    out = _reference("train_lm", flags, monkeypatch, capsys)
    mod = _load("torch_train_lm")
    cfg = mod.model_config(False)
    jparams = jtf.init_params(_load("train_lm").model_config(False), jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    got = mod.run(cfg, params, mod.parser().parse_args(["--device", "cpu", *flags]))
    mine = capsys.readouterr().out

    def lines(text):
        return [(int(m[1]), float(m[2]), m[3]) for m in re.finditer(
            r"step +(\d+) loss=([\d.]+) dt=[\d.]+s +(.*)", text)]

    def rest(tail):  # the timing-free part of a step line
        return re.sub(r"gns=[-\d.e+inf]+", "gns", re.sub(r"Delta=[\d.]+", "Delta", tail))

    ref_lines, my_lines = lines(out), lines(mine)
    assert [s for s, _, _ in my_lines] == [s for s, _, _ in ref_lines] == [1, 2, 4, 6]
    assert [rest(t) for _, _, t in my_lines] == [rest(t) for _, _, t in ref_lines]
    for (_, a, _), (_, b, _) in zip(my_lines, ref_lines):
        assert abs(a - b) <= 1e-4 * abs(b)
    ticks = [int(m[1]) for m in re.finditer(r"-> batch \d+ -> (\d+)", out)]
    schedule = [4, 4] + [ticks[0]] * 2 + [ticks[1]] * 2
    assert got["batch"] == schedule and len(got["loss"]) == 6
    assert mine.splitlines()[-1].startswith("done. compiled buckets: ")


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_synthetic_convex",
                                  "torch_train_resnet_cifar", "torch_serve_lm",
                                  "torch_train_lm"])
def test_examples_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"torch_quickstart": [], "torch_serve_lm": [], "torch_train_lm": []}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _load(name).main(argv.get(name, ["--out", str(tmp_path / "r.json")]))
