"""The port's checkpoints (``repro_torch.ckpt``, ``Trainer.save/resume``,
``train_lm --ckpt-dir``) against the JAX reference's, on the CPU.

* The reference's eight ``tests/test_checkpoint.py`` cases, on the port.
* The format: a tree written by either package loads in the other with
  the same ``meta.json`` index (paths, shapes, dtypes, keys) and equal
  arrays; bfloat16 leaves are held by their bits in both directions (the
  reference writes them as ``'<V2'`` npy arrays); manager directories and
  ``extra.json`` keys are the same.
* Resume.  Within the port: bit-identical (same device, same order of
  operations).  Across packages (the golden test): a checkpoint written by
  either package resumes in the other, compared with the other package's
  uninterrupted run at the Trainer tests' tolerances: the schedule exact,
  losses within 1e-4 relative, parameters within 1e-4.  On a two-pod
  ladder the resumed run starts its compression residuals at zero (they
  are never checkpointed, as in the reference), so it is held at the pod
  slice's card-against-CPU tolerances: losses within 1e-3 relative,
  parameters within 1e-2.
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.adapt import AdaptationProgram as JProgram
from repro.adapt import DiveBatchPolicy as JDiveBatch
from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import load_pytree as jload
from repro.ckpt import save_pytree as jsave
from repro.configs import get_config as jget_config
from repro.data import sigmoid_synthetic
from repro.models import small as jsmall
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.train import init_state as jinit_state
from repro.train.loop import ModelFns as JFns
from repro.train.loop import Trainer as JTrainer
from repro_torch import data as tdata
from repro_torch import interop
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.core.batch_policy import make_policy
from repro_torch.core.controller import AdaptiveBatchController
from repro_torch.launch import train_lm
from repro_torch.models import small
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, sgd
from repro_torch.pod import PodLadder
from repro_torch.train import init_state
from repro_torch.train.loop import ModelFns, Trainer

torch.set_num_threads(2)

N, D = 2000, 32
# the golden test runs six epochs, up to 100 steps each: at lr 0.5 the two
# packages' uninterrupted runs already part by more than the 1e-4
# tolerance (float32 sums in different orders), so the resume tests train
# at lr 0.1
LR = 0.1


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------


def _state():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
        "opt": {"momentum": {"w": torch.zeros((2, 3)), "b": torch.zeros(3)}},
    }


def test_pytree_roundtrip(tmp_path):
    tree = _state()
    save_pytree(str(tmp_path / "t"), tree)
    loaded = load_pytree(str(tmp_path / "t"), tree)
    assert torch.equal(loaded["params"]["w"], tree["params"]["w"])
    assert loaded["params"]["w"].dtype == torch.float32


def test_load_without_target_gives_nested_dict(tmp_path):
    save_pytree(str(tmp_path / "t"), _state())
    loaded = load_pytree(str(tmp_path / "t"))
    assert "params" in loaded and "w" in loaded["params"]


def test_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_manager_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    s = _state()
    mgr.save(1, s, extra={"m": 128})
    s2 = {"params": {"w": torch.full((2, 3), 9.0), "b": torch.ones(3)}, "opt": s["opt"]}
    mgr.save(2, s2, extra={"m": 256})
    out, extra = mgr.restore({"params": s["params"], "opt": s["opt"]}, step=1)
    assert extra["m"] == 128
    assert torch.equal(out["params"]["w"], torch.arange(6.0).reshape(2, 3))


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.zeros((2, 3))}})
    with pytest.raises(ValueError):
        mgr.restore({"params": {"w": torch.zeros((3, 3))}})


def test_missing_leaf_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": {"w": torch.zeros(3)}})
    with pytest.raises(KeyError):
        mgr.restore({"params": {"w": torch.zeros(3), "extra": torch.zeros(1)}})


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state()
    mgr.save(7, state)
    # the host copy was taken before save returned: an in-place update now
    # (the next donated step) does not reach the file
    state["params"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    out, _ = mgr.restore({"params": _state()["params"]})
    assert torch.equal(out["params"]["w"], torch.arange(6.0).reshape(2, 3))


def test_restore_places_onto_a_plan(tmp_path):
    """``restore(plan=)`` puts every tree, records included, on the plan's
    device through ``elastic.reshard.place``."""
    model = small.mlp_init(torch.Generator().manual_seed(0), 8, device="cpu")
    state = init_state(model, sgd(momentum=0.9))
    mgr = CheckpointManager(str(tmp_path))
    ref = interop.reference_state(state)
    mgr.save(1, {"opt_state": ref.opt_state, "div_state": ref.div_state})
    target = interop.reference_state(state, target=True)
    plan = PodLadder(pods=2, devices=["cpu"] * 8, granule=16).rungs[0].plan
    out, extra = mgr.restore({"opt_state": target.opt_state, "div_state": target.div_state},
                             plan=plan)
    assert extra == {"step": 1}
    assert type(out["div_state"]).__name__ == "DiversityState"
    assert out["div_state"].sq_norm_sum.device.type == "cpu"
    assert set(out["opt_state"].momentum) == {"fc1", "fc2"}


def test_no_partial_checkpoint_visible(tmp_path):
    """Tmp staging dirs must never appear as restorable steps."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(str(tmp_path / ".tmp.step_0000000099"))
    assert mgr.latest_step() is None


# ---------------------------------------------------------------------------
# the format, across packages
# ---------------------------------------------------------------------------


def _meta(d):
    with open(os.path.join(d, "meta.json")) as f:
        return json.load(f)


def _members(d):
    """The npy files of every volume, by name, as bytes."""
    out = {}
    for v in range(_meta(d)["num_volumes"]):
        with zipfile.ZipFile(os.path.join(d, f"vol{v}.npz")) as zf:
            out.update({f"vol{v}/{n}": zf.read(n) for n in zf.namelist()})
    return out


def _mixed_tree(rng):
    """Dicts, a list, a record-like nested tree, scalars and several dtypes."""
    return {
        "params": {"dense": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                             "bias": rng.standard_normal(3).astype(np.float32)},
                   "blocks": [rng.standard_normal((2, 2)).astype(np.float32)
                              for _ in range(11)]},
        "step": np.asarray(7, np.int32),
        "count": np.arange(5, dtype=np.int32),
        "mask": np.array([True, False]),
    }


def test_reference_tree_loads_in_the_port_and_writes_the_same(tmp_path):
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    jsave(str(tmp_path / "ref"), jax.tree.map(jnp.asarray, tree))
    ours = load_pytree(str(tmp_path / "ref"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = ours
        for k in path:
            node = node[str(getattr(k, "key", getattr(k, "idx", None)))]
        np.testing.assert_array_equal(node.numpy(), leaf)
    save_pytree(str(tmp_path / "port"), jax.tree.map(torch.from_numpy, tree))
    assert _meta(tmp_path / "port") == _meta(tmp_path / "ref")
    assert _members(tmp_path / "port") == _members(tmp_path / "ref")
    # a target of either type maps the leaves back, cast to the target's dtype
    back = load_pytree(str(tmp_path / "ref"), jax.tree.map(torch.from_numpy, tree))
    assert back["params"]["blocks"][10].dtype == torch.float32
    np.testing.assert_array_equal(back["params"]["blocks"][10].numpy(),
                                  tree["params"]["blocks"][10])


def test_bf16_is_held_by_its_bits_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2 ** 16, size=(5, 7), dtype=np.uint16)
    bits[0, :4] = [0x7FC0, 0xFF80, 0x0001, 0x8000]  # NaN, -inf, a subnormal, -0
    ref = bits.view(ml_dtypes.bfloat16)
    # the reference's write -> the port
    jsave(str(tmp_path / "ref"), {"w": jnp.asarray(ref), "s": jnp.ones(2, jnp.bfloat16)})
    assert _meta(tmp_path / "ref")["index"]["w"]["dtype"] == "bfloat16"
    ours = load_pytree(str(tmp_path / "ref"))
    assert ours["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ours["w"].view(torch.int16).numpy().view(np.uint16), bits)
    # the port's write -> the reference: '<V2' arrays with the same bytes
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    save_pytree(str(tmp_path / "port"), {"w": t, "s": torch.ones(2, dtype=torch.bfloat16)})
    assert _meta(tmp_path / "port") == _meta(tmp_path / "ref")
    assert _members(tmp_path / "port") == _members(tmp_path / "ref")
    theirs = jload(str(tmp_path / "port"))
    assert theirs["w"].dtype.str == "<V2" or theirs["w"].dtype.itemsize == 2
    assert theirs["w"].tobytes() == bits.tobytes()
    # and a bf16 target takes the bits through unchanged
    back = load_pytree(str(tmp_path / "port"), {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                                                "s": torch.zeros(2, dtype=torch.bfloat16)})
    assert torch.equal(back["w"].view(torch.int16), t.view(torch.int16))


def test_managers_lay_out_the_same_directories(tmp_path):
    tree = {"params": {"w": np.arange(6.0, dtype=np.float32)}}
    for root, mgr in (("ref", JManager(str(tmp_path / "ref"), keep=2)),
                      ("port", CheckpointManager(str(tmp_path / "port"), keep=2))):
        wrap = jnp.asarray if root == "ref" else torch.from_numpy
        for step in (3, 12, 123):
            mgr.save(step, {"state": jax.tree.map(wrap, tree)},
                     extra={"program": {"a": step}, "cursor": [1, 2]})
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(os.listdir(tmp_path / "port")) == [
        "step_0000000012", "step_0000000123"]
    for d in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / d / "step_0000000123")) == ["extra.json", "state"]
    extras = [json.load(open(tmp_path / d / "step_0000000123" / "extra.json"))
              for d in ("ref", "port")]
    assert extras[0] == extras[1] == {"step": 123, "program": {"a": 123}, "cursor": [1, 2]}


@pytest.mark.parametrize("opt", ["sgd", "sgd-momentum", "adamw"])
def test_reference_state_has_the_reference_paths(opt, tmp_path):
    """``interop.reference_state`` of a port ``TrainState`` writes the
    reference ``init_state``'s paths, shapes and dtypes, and loads back."""
    tree = jax.tree.map(np.asarray, jsmall.mlp_init(jax.random.key(0), D))
    make = {"sgd": (sgd, jsgd, {}), "sgd-momentum": (sgd, jsgd, {"momentum": 0.9}),
            "adamw": (adamw, None, {})}[opt]
    from repro.optim import adamw as jadamw

    jopt = (make[1] or jadamw)(**make[2])
    state = init_state(interop.small_params_from_jax(tree), make[0](**make[2]))
    jsave(str(tmp_path / "ref"), jinit_state(jax.tree.map(jnp.asarray, tree), jopt))
    save_pytree(str(tmp_path / "port"), interop.reference_state(state))
    assert _meta(tmp_path / "port") == _meta(tmp_path / "ref")
    # a changed state goes out and comes back in
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.5)
    state.div_state.sq_norm_sum.fill_(3.25)
    save_pytree(str(tmp_path / "port2"), interop.reference_state(state))
    fresh = init_state(interop.small_params_from_jax(tree), make[0](**make[2]))
    ref = load_pytree(str(tmp_path / "port2"), interop.reference_state(fresh, target=True))
    fresh = interop.load_reference_state(fresh, params=ref.params, opt_state=ref.opt_state,
                                         div_state=ref.div_state, step=int(ref.step))
    assert all(torch.equal(a, b) for a, b in zip(fresh.params.parameters(),
                                                 state.params.parameters()))
    assert float(fresh.div_state.sq_norm_sum) == 3.25


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _fns(mod):
    cls = JFns if mod is jsmall else ModelFns
    return cls(batch_loss=mod.mlp_batch_loss, example_loss=mod.mlp_loss,
               metrics=lambda p, b: {"acc": mod.mlp_accuracy(p, b)})


def _kw():
    return dict(m0=32, m_max=256, delta=0.08, dataset_size=int(N * 0.8), granule=16)


def _jtrainer(mgr, seed=2):
    tree = jax.tree.map(np.asarray, jsmall.mlp_init(jax.random.key(seed), D))
    train, val, _ = sigmoid_synthetic(n=N, d=D, seed=seed)
    return JTrainer(_fns(jsmall), tree, jsgd(momentum=0.9),
                    JProgram(JDiveBatch(**_kw()), LR), train, val,
                    estimator="exact", ckpt=mgr, seed=7)


def _trainer(mgr, seed=2, controller=None):
    tree = jax.tree.map(np.asarray, jsmall.mlp_init(jax.random.key(seed), D))
    train, val, _ = tdata.sigmoid_synthetic(n=N, d=D, seed=seed)
    prog = controller or AdaptationProgram(DiveBatchPolicy(**_kw()), LR)
    return Trainer(_fns(small), interop.small_params_from_jax(tree), sgd(momentum=0.9),
                   prog, train, val, estimator="exact", ckpt=mgr, seed=7)


def test_resume_reproduces_trajectory(tmp_path):
    """6 epochs straight against 3 + save + a fresh Trainer + resume + 3:
    the same val losses to the bit, batch schedule and step count."""
    t_full = _trainer(None)
    full = t_full.run(6, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    t1 = _trainer(mgr)
    t1.run(3, verbose=False)
    t1.save()
    t2 = _trainer(mgr)
    assert t2.resume()
    resumed = t2.run(3, verbose=False)[3:]
    assert [h.val_loss for h in resumed] == [h.val_loss for h in full[3:]]
    assert [h.batch_size for h in t2.history] == [h.batch_size for h in full]
    assert t2.state.step == t_full.state.step
    assert all(torch.equal(a, b) for a, b in zip(t2.params.parameters(),
                                                 t_full.params.parameters()))


def test_ckpt_every_saves_at_epoch_ends(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=5)
    t = _trainer(mgr)
    t.ckpt_every = 2
    t.run(5, verbose=False)
    assert mgr.all_steps() == [2, 4]
    assert _trainer(CheckpointManager(str(tmp_path / "empty"))).resume() is False


def _assert_close_to(theirs, ours):
    """``ours`` (a port Trainer) against ``theirs`` (a JAX Trainer), or the
    other way round, at the Trainer tests' tolerances."""
    for a, b in zip(theirs.history, ours.history, strict=True):
        assert (a.epoch, a.batch_size, a.steps) == (b.epoch, b.batch_size, b.steps)
        np.testing.assert_allclose([b.train_loss, b.val_loss, b.diversity],
                                   [a.train_loss, a.val_loss, a.diversity], rtol=1e-4)
    pa = (interop.small_params_to_numpy(ours.params) if isinstance(ours, Trainer)
          else jax.tree.map(np.asarray, ours.params))
    pb = (interop.small_params_to_numpy(theirs.params) if isinstance(theirs, Trainer)
          else jax.tree.map(np.asarray, theirs.params))
    for x, y in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
    assert int(ours.state.step) == int(theirs.state.step)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_resume(writer, tmp_path):
    """The golden test: three epochs in one package, a checkpoint, three
    more in the other; against the other package's six uninterrupted
    epochs."""
    mgr_kind = {"jax": (JManager, _jtrainer), "torch": (CheckpointManager, _trainer)}
    wm, wt = mgr_kind[writer]
    rm, rt = mgr_kind["torch" if writer == "jax" else "jax"]
    first = wt(wm(str(tmp_path / "ck")))
    first.run(3, verbose=False)
    first.save()
    second = rt(rm(str(tmp_path / "ck")))
    assert second.resume()
    assert second.cursor.epoch == 3 and len(second.history) == 3
    second.run(3, verbose=False)
    straight = rt(None)
    straight.run(6, verbose=False)
    _assert_close_to(straight, second)


def test_trainer_restores_pre_redesign_checkpoint(tmp_path):
    """A checkpoint whose extra.json carries the v1 controller dict and a v1
    cursor (no sample_index) resumes with the same remaining trajectory
    (``tests/test_adapt.py``'s schema case, on the port)."""

    def build(mgr):
        return _trainer(mgr, controller=AdaptiveBatchController(
            make_policy("divebatch", m0=32, m_max=256, delta=0.08,
                        dataset_size=int(N * 0.8), granule=16), base_lr=0.5))

    full = build(None).run(5, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    t1 = build(mgr)
    t1.run(3, verbose=False)
    t1.save()
    step_dir = os.path.join(mgr.root, f"step_{mgr.latest_step():010d}")
    with open(os.path.join(step_dir, "extra.json")) as f:
        extra = json.load(f)
    v2 = extra["controller"]
    assert v2["version"] == 2
    extra["controller"] = {
        "policy": v2["policy"], "lr": v2["lr"], "epoch": v2["epoch"],
        "history": [{k: a[k] for k in ("epoch", "batch_size", "lr", "diversity",
                                       "raw_batch_size", "rescaled")}
                    for a in v2["history"]],
    }
    del extra["cursor"]["sample_index"]
    with open(os.path.join(step_dir, "extra.json"), "w") as f:
        json.dump(extra, f)
    t2 = build(mgr)
    assert t2.resume()
    resumed = t2.run(2, verbose=False)[3:]
    assert [h.val_loss for h in resumed] == [h.val_loss for h in full[3:]]
    assert [h.batch_size for h in resumed] == [h.batch_size for h in full[3:]]


def _pod_trainer(mgr):
    tree = jax.tree.map(np.asarray, jsmall.mlp_init(jax.random.key(3), D))
    train, val, _ = tdata.sigmoid_synthetic(n=1024, d=D, seed=3)
    kw = dict(m0=64, m_max=256, delta=1.0, dataset_size=int(1024 * 0.8), granule=16)
    return Trainer(_fns(small), interop.small_params_from_jax(tree), sgd(momentum=0.9),
                   AdaptationProgram(DiveBatchPolicy(**kw), 0.5), train, val,
                   estimator="moment", seed=3, ckpt=mgr, ckpt_every=1,
                   elastic=PodLadder(pods=2, devices=["cpu"] * 8, granule=16))


def test_resume_onto_a_pod_ladder_lands_on_the_checkpointed_rung(tmp_path):
    """Two epochs reach the cross-pod rung 3; a fresh Trainer on a fresh
    ladder (starting on rung 2) resumes onto rung 3 with zeroed residuals
    and runs epoch 3 as the uninterrupted run does."""
    straight = _pod_trainer(None)
    rungs = []
    for _ in range(3):
        straight.run_epoch()
        rungs.append(straight.rung.index)
    assert rungs[1:] == [3, 3]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    first = _pod_trainer(mgr)
    first.run(2, verbose=False)
    assert mgr.all_steps() == [1, 2]
    second = _pod_trainer(mgr)
    assert second.rung.index == 2
    assert second.resume()
    assert second.rung.index == 3 and second.engine.rung == 3
    assert all(float(e.abs().max()) == 0.0 for e in second.state.err_state)
    rec = second.run_epoch()
    ref = straight.history[2]
    assert (rec.batch_size, rec.steps, second.rung.index) == (ref.batch_size, ref.steps, 3)
    np.testing.assert_allclose([rec.train_loss, rec.val_loss],
                               [ref.train_loss, ref.val_loss], rtol=1e-3)
    for a, b in zip(second.params.parameters(), straight.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-2)


def test_train_lm_checkpoints_read_in_the_reference_and_resume(tmp_path):
    """``train_lm``'s checkpoints (``--ckpt-dir`` runs ``train(ckpt=...)``)
    on reduced Yi-6B: the ``state`` tree has the reference's paths, shapes,
    dtypes and keys (its ``init_state`` of the same config), loads in the
    reference, and a run resumed from the first tick repeats the
    uninterrupted run's losses and parameters to the bit."""
    cfg = get_config("yi-6b", reduced=True).replace(attn_impl="pallas")
    ck = tmp_path / "ck"

    def program():
        return train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5, granule=2,
                                     lr=0.3, tick_every=2)

    full = train_lm.train(cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                          program(), steps=4, seq_len=16, micro_batch=2,
                          ckpt=CheckpointManager(str(ck)), log=lambda s: None)
    assert sorted(os.listdir(ck)) == ["step_0000000002", "step_0000000004"]
    jstate = jinit_state(jtf.init_params(jget_config("yi-6b", reduced=True),
                                         jax.random.key(0)), jsgd(momentum=0.9))
    jsave(str(tmp_path / "ref"), jstate)
    assert _meta(ck / "step_0000000004" / "state") == _meta(tmp_path / "ref")
    loaded = jload(str(ck / "step_0000000004" / "state"), jstate)
    ours = interop.params_to_numpy(full["state"].params)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(loaded.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(loaded.step) == 4
    # resume from step 2 into a fresh model and program
    params = tf.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    prog = program()
    state, step = train_lm.resume(CheckpointManager(str(ck)), init_state(params, sgd(0.9)),
                                  prog, step=2)
    assert step == 2 and state.step == 2
    out = train_lm.train(cfg, params, prog, steps=4, seq_len=16, micro_batch=2,
                         state=state, start_step=step, log=lambda s: None)
    assert [(r["step"], r["batch"], r["loss"]) for r in out["records"]] == \
        [(r["step"], r["batch"], r["loss"]) for r in full["records"][2:]]
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 full["state"].params.parameters()))


def test_trainer_telemetry_matches_the_reference_events(tmp_path):
    """A Trainer run with a tracer and a run log emits the reference's event
    kinds and fields (``compile``, ``epoch``, ``checkpoint``)."""
    from repro.obs import RunLog as JRunLog
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import RunLog, Tracer, read_runlog

    logs, tracers = {}, {}
    for pkg, (mgr, build, tracer, runlog) in {
        "jax": (JManager, _jtrainer, JTracer(), JRunLog(str(tmp_path / "jax"))),
        "torch": (CheckpointManager, _trainer, Tracer(), RunLog(str(tmp_path / "torch"))),
    }.items():
        t = build(mgr(str(tmp_path / f"ck-{pkg}")))
        t.ckpt_every = 1
        t.bind_obs(tracer=tracer, runlog=runlog)
        t.run(2, verbose=False)
        runlog.close()
        logs[pkg] = read_runlog(str(tmp_path / pkg))
        tracers[pkg] = tracer
    shape = {pkg: [(e["kind"], sorted(set(e) - {"t"})) for e in evs
                   if e["kind"] in ("compile", "epoch", "checkpoint")]
             for pkg, evs in logs.items()}
    assert shape["torch"] == shape["jax"]
    assert [k for k, _ in shape["torch"]].count("checkpoint") == 2
    names = {pkg: sorted({e["name"] for e in tr.to_json()["traceEvents"]
                          if e.get("ph") == "X"})
             for pkg, tr in tracers.items()}
    assert {"compile", "dispatch", "epoch"} <= set(names["torch"]) <= set(names["jax"])
    compiles = [e for e in logs["torch"] if e["kind"] == "compile"]
    assert compiles and all(e["scope"] == "train" and e["what"] == f"bucket={e['bucket']}"
                            for e in compiles)
