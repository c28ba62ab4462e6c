"""The port's paper ``Trainer`` and data pipeline against the JAX reference,
on the CPU (single device).

Inputs are numpy from a seed (``data.sigmoid_synthetic`` is a byte-for-byte
copy, so both packages draw the same data), parameters come from the
reference init through ``interop.small_params_from_jax``.  Discrete outputs
must match exactly: batch schedules, step counts, decisions, loader
indices.  Float outputs, float32 throughout: losses, accuracies and
diversity within 1e-4 relative, parameters within 1e-4 absolute (the two
packages sum in different orders, and an epoch is tens of steps).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import AdaptationProgram as JProgram
from repro.adapt import DiveBatchPolicy as JDiveBatch
from repro.core import make_policy as jmake_policy
from repro.core.controller import AdaptiveBatchController as JController
from repro.data import Cursor as JCursor
from repro.data import EpochLoader as JLoader
from repro.data import sigmoid_synthetic, imagelike_classification
from repro.data import microbatches as jmicrobatches
from repro.models import small as jsmall
from repro.optim import sgd as jsgd
from repro.train.loop import ModelFns as JFns
from repro.train.loop import Trainer as JTrainer
from repro_torch import data as tdata
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy
from repro_torch.configs import get_config
from repro_torch.core.batch_policy import make_policy
from repro_torch.core.controller import AdaptiveBatchController
from repro_torch.data import TokenStream
from repro_torch.data.pipeline import prefetch, put_global_batch
from repro_torch.interop import small_params_from_jax, small_params_to_numpy
from repro_torch.models import small
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, init_state
from repro_torch.train.loop import ModelFns, Trainer

torch.set_num_threads(2)

N, D = 2000, 32


def _fns(mod, model):
    loss, ex, acc = (getattr(mod, f"{model}_{n}") for n in ("batch_loss", "loss", "accuracy"))
    kw = {}
    if model == "mlp":
        kw = dict(probe_loss=mod.mlp_batch_loss_with_probes, probe_specs=mod.mlp_probe_specs)
    cls = JFns if mod is jsmall else ModelFns
    return cls(batch_loss=loss, example_loss=ex,
               metrics=lambda p, b: {"acc": acc(p, b)}, **kw)


def _pair(model, seed=0, n=N, d=D, estimator="exact", make=None, epochs=3, **kw):
    """Both trainers, run ``epochs`` epochs side by side."""
    init = jsmall.logreg_init if model == "logreg" else jsmall.mlp_init
    tree = jax.tree.map(np.asarray, init(jax.random.key(seed), d))
    jtrain, jval, _ = sigmoid_synthetic(n=n, d=d, seed=seed)
    train, val, _ = tdata.sigmoid_synthetic(n=n, d=d, seed=seed)
    jprog, prog = make()
    jt = JTrainer(_fns(jsmall, model), tree, jsgd(momentum=0.9), jprog, jtrain, jval,
                  estimator=estimator, seed=7, **kw)
    t = Trainer(_fns(small, model), small_params_from_jax(tree), sgd(momentum=0.9), prog,
                train, val, estimator=estimator, seed=7, **kw)
    jt.run(epochs, verbose=False)
    t.run(epochs, verbose=False)
    return jt, t


def _divebatch(n=N, m0=64, m_max=512, delta=0.5, lr=0.5):
    kw = dict(m0=m0, m_max=m_max, delta=delta, dataset_size=int(n * 0.8), granule=16)
    return (JController(jmake_policy("divebatch", **kw), base_lr=lr),
            AdaptiveBatchController(make_policy("divebatch", **kw), base_lr=lr))


def _assert_match(jt, t, atol=1e-4):
    assert len(jt.history) == len(t.history)
    for a, b in zip(jt.history, t.history):
        assert (a.epoch, a.batch_size, a.steps) == (b.epoch, b.batch_size, b.steps)
        np.testing.assert_allclose(b.lr, a.lr, rtol=1e-7)
        np.testing.assert_allclose([b.train_loss, b.val_loss], [a.train_loss, a.val_loss],
                                   rtol=1e-4)
        np.testing.assert_allclose(b.val_metrics["acc"], a.val_metrics["acc"], rtol=1e-4)
        assert (a.diversity is None) == (b.diversity is None)
        if a.diversity is not None:
            np.testing.assert_allclose(b.diversity, a.diversity, rtol=1e-4)
    ours = small_params_to_numpy(t.params)
    for k in ours:
        for n in ours[k]:
            np.testing.assert_allclose(ours[k][n], np.asarray(jt.params[k][n]), rtol=0,
                                       atol=atol)
    assert int(jt.state.step) == t.state.step


def test_divebatch_golden_schedule_on_synthetic_convex():
    """DiveBatch on synthetic convex (logreg, the exact tier's vmap path):
    the reference's batch schedule, epoch by epoch."""
    jt, t = _pair("logreg", make=_divebatch, epochs=4)
    _assert_match(jt, t)
    sched = [h.batch_size for h in t.history]
    assert sched == [h.batch_size for h in jt.history] and sched[-1] > 64


@pytest.mark.parametrize("estimator", ["moment", "gram", "exact"])
def test_mlp_tiers_match_reference(estimator):
    """The MLP (synthetic non-convex) on each in-step tier."""
    jt, t = _pair("mlp", seed=1, make=_divebatch, estimator=estimator, epochs=3)
    _assert_match(jt, t)


@pytest.mark.parametrize("estimator", ["oracle", "none"])
def test_host_tiers_match_reference(estimator):
    """The oracle (exact full-dataset diversity at fixed params) and none."""
    jt, t = _pair("mlp", n=500, make=lambda: _divebatch(n=500), estimator=estimator,
                  epochs=2)
    _assert_match(jt, t)


def test_tick_fired_mid_epoch_resize_matches_reference():
    """A tick every 4 steps on the running accumulators: mid-epoch resizes,
    phase-aligned, with the rest of the epoch's permutation."""
    def make():
        kw = dict(m0=32, m_max=256, delta=0.5, dataset_size=int(N * 0.8), granule=16,
                  on_tick=True)
        return (JProgram(JDiveBatch(**kw), 0.5, estimator="moment", tick_every=4),
                AdaptationProgram(DiveBatchPolicy(**kw), 0.5, estimator="moment",
                                  tick_every=4))

    jt, t = _pair("logreg", make=make, estimator="moment", epochs=2)
    _assert_match(jt, t)
    jdec = [(a.epoch, a.step, a.boundary, a.batch_size) for a in jt.adapt.history]
    tdec = [(a.epoch, a.step, a.boundary, a.batch_size) for a in t.adapt.history]
    assert tdec == jdec and any(b == "tick" for _, _, b, _ in tdec)


@pytest.mark.parametrize("mode", [False, "thread"])
def test_prefetch_modes_give_the_same_trajectory(mode):
    _, base = _pair("logreg", make=_divebatch, epochs=2)
    _, t = _pair("logreg", make=_divebatch, epochs=2, prefetch=mode)
    assert [h.val_loss for h in t.history] == [h.val_loss for h in base.history]


def test_trainer_refusals():
    tree = jax.tree.map(np.asarray, jsmall.logreg_init(jax.random.key(0), 8))
    train, val, _ = tdata.sigmoid_synthetic(n=64, d=8)
    args = (_fns(small, "logreg"), small_params_from_jax(tree), sgd(), _divebatch()[1],
            train, val)
    with pytest.raises(NotImplementedError, match="Queue A 4"):
        Trainer(*args, ckpt=object())
    t = Trainer(*args, estimator="moment")
    with pytest.raises(NotImplementedError, match="ckpt"):
        t.save()
    with pytest.raises(ValueError, match="prefetch"):
        Trainer(*args, prefetch="yes")


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def test_datasets_are_identical():
    for a, b in zip(sigmoid_synthetic(n=300, d=7, seed=4)[:2],
                    tdata.sigmoid_synthetic(n=300, d=7, seed=4)[:2]):
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
    for a, b in zip(imagelike_classification(n=50, hw=8, seed=2),
                    tdata.imagelike_classification(n=50, hw=8, seed=2)):
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])


@pytest.mark.parametrize("start", [0, 37, 64, 999])
def test_epoch_loader_mid_epoch_resume_matches_reference(start):
    """A loader resumed at an arbitrary sample offset visits the reference's
    indices, batch by batch; the cursor round-trips its state."""
    train, _, _ = tdata.sigmoid_synthetic(n=1000, d=4, seed=1)
    jtrain, _, _ = sigmoid_synthetic(n=1000, d=4, seed=1)
    ours = tdata.EpochLoader(train, 32, epoch=3, seed=5, start_sample=start)
    ref = JLoader(jtrain, 32, epoch=3, seed=5, start_sample=start)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref, strict=True):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    # resuming at a batch boundary equals the tail of the full epoch
    full = list(tdata.EpochLoader(train, 32, epoch=3, seed=5))
    tail = list(tdata.EpochLoader(train, 32, epoch=3, seed=5, start_batch=5))
    for a, b in zip(full[5:], tail, strict=True):
        np.testing.assert_array_equal(a["x"], b["x"])
    c, jc = tdata.Cursor(2, 7, start), JCursor(2, 7, start)
    assert c.state_dict() == jc.state_dict()
    c2 = tdata.Cursor()
    c2.load_state_dict({"epoch": 1, "batch_index": 4})  # a pre-redesign dict
    assert (c2.epoch, c2.batch_index, c2.sample_index) == (1, 4, 0)


@pytest.mark.parametrize("host_overlap", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_yields_the_same_batches(host_overlap, depth):
    train, _, _ = tdata.sigmoid_synthetic(n=200, d=3, seed=0)
    loader = tdata.EpochLoader(train, 16, epoch=0)
    put = functools.partial(put_global_batch, device="cpu")
    want = [put(b) for b in loader]
    got = list(prefetch(loader, put, depth=depth, host_overlap=host_overlap))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(a[k], b[k]) for k in a)
    feed = prefetch(loader, put, host_overlap=host_overlap)
    next(feed)
    feed.close()  # an abandoned feed stops its producer
    with pytest.raises(ValueError, match="depth"):
        prefetch(loader, put, depth=0)


def test_microbatches_match_reference():
    batch = {"x": np.arange(24).reshape(12, 2), "y": np.arange(12)}
    for a, b in zip(tdata.microbatches(batch, 4), jmicrobatches(batch, 4), strict=True):
        np.testing.assert_array_equal(a["x"], b["x"])
    with pytest.raises(ValueError, match="not divisible"):
        list(tdata.microbatches(batch, 5))


# ---------------------------------------------------------------------------
# StepEngine(donate=False)
# ---------------------------------------------------------------------------


def _snapshot(state):
    return copy.deepcopy(state)


def _states_equal(a, b) -> bool:
    pa, pb = list(a.params.parameters()), list(b.params.parameters())
    ta = pa + list(a.opt_state.momentum) + list(a.div_state.grad_sum.values())
    tb = pb + list(b.opt_state.momentum) + list(b.div_state.grad_sum.values())
    scal = ("sq_norm_sum", "mb_count", "sample_count")
    return (a.step == b.step and all(torch.equal(x, y) for x, y in zip(ta, tb))
            and all(torch.equal(getattr(a.div_state, s), getattr(b.div_state, s))
                    for s in scal))


@pytest.mark.parametrize("engine", ["lm", "model_fns"])
def test_step_engine_without_donation_leaves_the_state(engine):
    """donate=False steps a copy: the caller's TrainState keeps the values it
    had before the step (the reference's undonated buffers)."""
    if engine == "lm":
        cfg = get_config("yi-6b", reduced=True)
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        eng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, donate=False)
        batch = TokenStream(cfg.vocab_size).batch(0, 4, 8)
    else:
        params = small.mlp_init(torch.Generator().manual_seed(0), 8, device="cpu")
        eng = StepEngine.for_model_fns(_fns(small, "mlp"), sgd(momentum=0.9),
                                       estimator="exact", donate=False)
        batch = tdata.sigmoid_synthetic(n=64, d=8)[0].get(np.arange(16))
    state = init_state(params, sgd(momentum=0.9))
    before = _snapshot(state)
    new, _ = eng.step(state, batch, 0.1)
    new, _ = eng.step(new, batch, 0.1)
    assert new is not state and _states_equal(state, before)
    assert not _states_equal(new, before) and new.step == 2
    assert eng.stats.as_dict()["donate"] is False
    donating = StepEngine.for_model_fns(_fns(small, "mlp"), sgd()) if engine != "lm" \
        else StepEngine.for_lm(get_config("yi-6b", reduced=True), sgd(), micro_batch=2)
    assert donating.donate and donating.stats.as_dict()["donate"] is True


def test_for_model_fns_tier_flip_is_a_new_key_and_a_hit_back():
    eng = StepEngine.for_model_fns(_fns(small, "mlp"), sgd(), estimator="moment")
    state = init_state(small.mlp_init(torch.Generator().manual_seed(0), 8, device="cpu"), sgd())
    batch = tdata.sigmoid_synthetic(n=64, d=8)[0].get(np.arange(16))
    for tier in ("moment", "gram", "moment", "exact"):
        eng.tier = tier
        state, m = eng.step(state, batch, 0.1)
        assert np.isfinite(m["loss"].item())
    assert eng.stats.tiers == ["moment", "gram", "exact"] and eng.stats.bucket_hits == 1
    loss, metrics = eng.evaluate(state.params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(loss.item()) and set(metrics) == {"acc"}
