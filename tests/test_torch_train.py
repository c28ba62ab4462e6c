"""The port's LM training slice against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
parameters come from the reference init through ``interop.params_from_jax``.
The reference runs its Pallas flash kernel with the custom_vjp backward in
interpret mode (``attn_impl="pallas"``); the port runs on the CPU, where its
kernel wrappers take their plain versions.  Tolerances, float32 throughout:
single ops within 1e-6 relative (1e-5 for gradients, which sum in another
order); the whole train step within the reference's own bounds for a
pallas-vs-dense trajectory (``tests/test_engine.py``): losses 1e-5 relative,
parameters 2e-4 absolute; the diversity accumulators and the signals read
off them within 1e-4 relative.  Discrete outputs (batch sizes, buckets,
engine counts, decisions) must match exactly.

The gram tier and the exact tier on its probe path (``psn_impl="kernel"``)
are held against the reference's ``make_train_step(..., estimator=...,
probe_loss=..., probe_specs=..., psn_interpret=True)`` on reduced Yi-6B
(``scan_layers=False`` in the reference, the dense attention lane in both):
losses and ``sq_norm_sum`` within 1e-5 relative; ``grad_sum`` and the
parameters within 1e-5 relative plus 5e-5 of each tensor's RMS (entries pass
through zero, and ``grad_sum`` sums three steps of B times the mean
gradient: the largest difference seen is 1.7e-5 of the RMS).  Decisions
match in every discrete field, their float fields within 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adapt as jadapt
from repro.configs import get_config as jget
from repro.core import batch_policy as jbp
from repro.core import diversity as jdiv
from repro.data import TokenStream as JTokenStream
from repro.models import probes as jprobes
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import sgd as jsgd
from repro.train import StepEngine as JStepEngine
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import adapt
from repro_torch.configs import get_config
from repro_torch.core import batch_policy as bp
from repro_torch.core import diversity
from repro_torch.data import TokenStream
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import train_lm
from repro_torch.models import probes
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, apply_updates, sgd
from repro_torch.train import ModelFns, StepEngine, init_state, lm_bucket_of, make_train_step
from repro_torch.train.step import _to_micro

torch.set_num_threads(2)

SEQ = 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# single modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_xent_chunked_value_and_grads_match_reference(softcap):
    """Chunked cross-entropy over 4 chunks: value, dx and dW (the port takes
    the head in (V, d) layout, the reference its (d, V) kernel)."""
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 16, 8)).astype(np.float32)
    kernel = (r.standard_normal((8, 23)) * 0.5).astype(np.float32)
    targets = r.integers(0, 23, size=(2, 16)).astype(np.int32)
    jloss, (jdx, jdw) = jax.value_and_grad(
        lambda x_, k_: jtf.xent_chunked(x_, k_, jnp.asarray(targets), 4, softcap),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kernel))
    tx = _t(x).requires_grad_(True)
    tw = _t(kernel.T.copy()).requires_grad_(True)
    loss = tf.xent_chunked(tx, tw, _t(targets), 4, softcap)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jdw), rtol=1e-5, atol=1e-6)


def test_xent_chunked_rejects_a_ragged_chunk():
    with pytest.raises(ValueError, match="xent chunk"):
        tf.xent_chunked(torch.zeros(1, 6, 4), torch.zeros(5, 4),
                        torch.zeros(1, 6, dtype=torch.long), 4)


@pytest.mark.parametrize("make", [
    lambda o: o.sgd(momentum=0.9),
    lambda o: o.sgd(momentum=0.9, weight_decay=1e-2, nesterov=True),
    lambda o: o.sgd(),
    lambda o: o.adamw(weight_decay=1e-2),
], ids=["sgd-momentum", "sgd-nesterov-wd", "sgd-plain", "adamw-wd"])
def test_optimizer_updates_match_reference(make):
    """Two updates of each optimizer from the same params and gradients."""
    import types

    r = np.random.default_rng(4)
    params = [r.standard_normal(s).astype(np.float32) for s in ((3, 5), (7,), (2, 2, 2))]
    grads = [[r.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(2)]
    jopt = make(types.SimpleNamespace(sgd=jsgd, adamw=jadamw))
    topt = make(types.SimpleNamespace(sgd=sgd, adamw=adamw))
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p.copy()) for p in params]
    jst, tst = jopt.init(jp), topt.init(tp)
    for lr, g in zip((0.1, 0.05), grads):
        ju, jst = jopt.update([jnp.asarray(x) for x in g], jst, jp, jnp.float32(lr))
        jp = japply(jp, ju)
        tu, tst = topt.update([_t(x) for x in g], tst, tp, lr)
        apply_updates(tp, tu)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_token_stream_arrays_identical():
    for vocab, seed in ((251, 0), (64_000, 3)):
        a, b = TokenStream(vocab, seed=seed), JTokenStream(vocab, seed=seed)
        for step, m, s in ((0, 4, 17), (5, 2, 64)):
            x, y = a.batch(step, m, s), b.batch(step, m, s)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def _div_states(seed, mb_count):
    """The same random accumulators in both packages."""
    r = np.random.default_rng(seed)
    grad_sum = {"a": r.standard_normal((4, 3)).astype(np.float32),
                "b": r.standard_normal((5,)).astype(np.float32)}
    q = float(r.uniform(1, 50))
    n = float(8 * mb_count)
    j = jdiv.DiversityState(grad_sum={k: jnp.asarray(v) for k, v in grad_sum.items()},
                            sq_norm_sum=jnp.float32(q), mb_count=jnp.float32(mb_count),
                            sample_count=jnp.float32(n))
    t = diversity.DiversityState(grad_sum={k: _t(v) for k, v in grad_sum.items()},
                                 sq_norm_sum=torch.tensor(q), mb_count=torch.tensor(
                                     float(mb_count)), sample_count=torch.tensor(n))
    return j, t


@pytest.mark.parametrize("mb_count", [1, 3])
def test_diversity_estimators_match_reference(mb_count):
    """exact, moment (and its single-microbatch fallback at mb_count 1) and
    the gradient-noise scale off the same accumulators."""
    j, t = _div_states(mb_count, mb_count)
    for est in ("exact", "gram", "moment"):
        np.testing.assert_allclose(diversity.estimate(t, est).item(),
                                   float(jdiv.estimate(j, est)), rtol=1e-6)
        np.testing.assert_allclose(adapt.gns_from_accumulators(t, est).item(),
                                   float(jadapt.gns_from_accumulators(j, est)), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown estimator"):
        diversity.estimate(t, "vmap")


def test_accumulate_and_reset_match_reference():
    j, t = _div_states(9, 2)
    r = np.random.default_rng(10)
    g = {"a": r.standard_normal((4, 3)).astype(np.float32),
         "b": r.standard_normal((5,)).astype(np.float32)}
    j = jdiv.accumulate(j, {k: jnp.asarray(v) for k, v in g.items()}, 8)
    t = diversity.accumulate(t, {k: _t(v) for k, v in g.items()}, 8)
    for name in ("sq_norm_sum", "mb_count", "sample_count"):
        np.testing.assert_allclose(getattr(t, name).item(), float(getattr(j, name)),
                                   rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(t.grad_sum[k].numpy(), np.asarray(j.grad_sum[k]),
                                   rtol=1e-6)
    diversity.reset_state(t)
    assert t.sample_count.item() == 0 and all(
        not v.any() for v in t.grad_sum.values())


def test_epoch_end_host_reads_and_resets_like_the_reference():
    from repro.train import TrainState as JTrainState
    from repro.train import epoch_end_host as jepoch_end_host
    from repro_torch.train import TrainState, epoch_end_host

    j, t = _div_states(12, 4)
    jdelta, jstate = jepoch_end_host(JTrainState(params={}, opt_state=(), div_state=j,
                                                 step=jnp.int32(0)))
    tdelta, tstate = epoch_end_host(TrainState(params=None, opt_state=None, div_state=t))
    np.testing.assert_allclose(tdelta, jdelta, rtol=1e-6)
    assert tstate.div_state is t and t.mb_count.item() == 0.0
    assert float(jstate.div_state.mb_count) == 0.0


# ---------------------------------------------------------------------------
# the adaptation layer: same signals, same decisions
# ---------------------------------------------------------------------------


def _policies(pkg, bpkg):
    return {
        "fixed": lambda: pkg.FixedPolicy(8, 64, granule=4),
        "adabatch": lambda: pkg.AdaBatchPolicy(8, 128, resize_factor=2, resize_freq=2,
                                               granule=4),
        "divebatch-window": lambda: pkg.DiveBatchPolicy(8, 256, delta=0.5,
                                                        dataset_size=None, granule=4,
                                                        on_tick=True),
        "divebatch-dataset": lambda: pkg.DiveBatchPolicy(8, 256, delta=0.1,
                                                         dataset_size=2000, granule=4),
        "oracle": lambda: pkg.DiveBatchPolicy(8, 256, delta=0.1, dataset_size=2000,
                                              granule=4, oracle=True),
        "gradnoise": lambda: pkg.GradNoisePolicy(8, 256, granule=4, alpha=0.5),
        "from-batch": lambda: pkg.FromBatchPolicy(bpkg.make_policy(
            "divebatch", m0=16, m_max=512, delta=0.2, dataset_size=1000, granule=8)),
    }


def _signal_stream(seed):
    r = np.random.default_rng(seed)
    out = []
    for i in range(12):
        boundary = ("tick", "tick", "epoch", "event")[i % 4]
        kw = dict(diversity=float(r.uniform(0.05, 3.0)), gns=float(r.uniform(1, 400)),
                  loss=float(r.uniform(1, 5)), batch_size=8,
                  samples=float(r.integers(32, 512)),
                  event="straggler" if boundary == "event" else None)
        kw["diversity_bound"] = kw["samples"] * kw["diversity"]
        out.append((kw, dict(epoch=i // 4, step=i * 5, boundary=boundary)))
    return out


@pytest.mark.parametrize("name", list(_policies(adapt, bp)))
@pytest.mark.parametrize("rule", ["linear", "sqrt", "none"])
def test_policies_and_program_decide_identically(name, rule):
    """One Signals stream (ticks, epoch ends, events) through each policy in
    an AdaptationProgram with an lr coupling: the same decisions, batch
    sizes, lr and history, and the same checkpoint dict."""
    tp = adapt.AdaptationProgram(_policies(adapt, bp)[name](), 0.1,
                                 adapt.LrCoupling(rule), tick_every=2)
    jp = jadapt.AdaptationProgram(_policies(jadapt, jbp)[name](), 0.1,
                                  jadapt.LrCoupling(rule), tick_every=2)
    for sig, clock in _signal_stream(len(name) + len(rule)):
        ta = tp.observe(adapt.Signals(**sig), adapt.Clock(**clock))
        ja = jp.observe(jadapt.Signals(**sig), jadapt.Clock(**clock))
        assert (ta is None) == (ja is None)
        if ta is not None:
            assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
        assert (tp.batch_size, tp.lr, tp.epoch) == (jp.batch_size, jp.lr, jp.epoch)
    assert tp.state_dict() == jp.state_dict()
    restored = adapt.AdaptationProgram(_policies(adapt, bp)[name](), 0.1,
                                       adapt.LrCoupling(rule))
    restored.load_state_dict(jp.state_dict())
    assert restored.state_dict() == tp.state_dict()


# ---------------------------------------------------------------------------
# the slice as a whole: StepEngine.for_lm on reduced Yi-6B
# ---------------------------------------------------------------------------


def _slice_run(remat: bool):
    """Reduced Yi-6B, ``for_lm(micro_batch=4, attn_impl="pallas")``, sgd
    with momentum: 3 steps at num_micro 1 then 3 at num_micro 2 on the same
    TokenStream batches in both packages, the signals read and reset after
    each half, and fed to a tick-fired DiveBatch program."""
    jcfg = jget("yi-6b", reduced=True).replace(remat=remat)
    cfg = get_config("yi-6b", reduced=True).replace(remat=remat)
    jparams = jtf.init_params(jcfg, jax.random.key(2))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=4, attn_impl="pallas")
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=4, attn_impl="pallas")
    jstate = jinit_state(jparams, jsgd(momentum=0.9))
    tstate = init_state(params, sgd(momentum=0.9))
    stream = TokenStream(cfg.vocab_size, seed=1)

    def program(pkg):
        return pkg.AdaptationProgram(
            pkg.DiveBatchPolicy(4, 16, delta=0.5, dataset_size=None, granule=4,
                                on_tick=True), 0.1, tick_every=3)

    jprog, tprog = program(jadapt), program(adapt)
    out = {"jloss": [], "tloss": [], "jsig": [], "tsig": [], "decisions": []}
    for step in range(6):
        m = 4 if step < 3 else 8
        b = stream.batch(step, m, SEQ)
        jstate, jm = jeng.step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, 0.1)
        tstate, tm = teng.step(tstate, b, 0.1)
        out["jloss"].append(float(jm["loss"]))
        out["tloss"].append(float(tm["loss"]))
        if step in (2, 5):
            if step == 5:  # the accumulators before the read, for the state check
                out["jdiv"], out["tdiv"] = jstate.div_state, tstate.div_state
                out["tdiv_vals"] = {k: getattr(tstate.div_state, k).item()
                                    for k in ("sq_norm_sum", "mb_count", "sample_count")}
            jsig, jstate = jadapt.read_signals(jstate, "moment", reset=True, batch_size=m)
            tsig, tstate = adapt.read_signals(tstate, "moment", reset=True, batch_size=m)
            out["jsig"].append(jsig)
            out["tsig"].append(tsig)
            clock = dict(epoch=step // 3, step=step + 1, boundary="tick")
            ja = jprog.observe(jsig, jadapt.Clock(**clock))
            ta = tprog.observe(tsig, adapt.Clock(**clock))
            out["decisions"].append((ja.batch_size, ta.batch_size))
    out.update(jstate=jstate, tstate=tstate, jeng=jeng, teng=teng, cfg=cfg)
    return out


@pytest.fixture(scope="module")
def slice_run():
    return _slice_run(remat=True)


def test_slice_losses_and_params_match_reference(slice_run):
    r = slice_run
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-5)
    got = params_to_numpy(r["tstate"].params, r["cfg"])
    want = jax.tree.map(np.asarray, r["jstate"].params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=2e-4)
    assert all(np.isfinite(r["tloss"]))
    # one momentum buffer per parameter, in the parameters' dtype
    mom = r["tstate"].opt_state.momentum
    assert [m.dtype for m in mom] == [p.dtype for p in r["tstate"].params.parameters()]


def test_slice_diversity_state_and_signals_match_reference(slice_run):
    r = slice_run
    for name, val in r["tdiv_vals"].items():
        np.testing.assert_allclose(val, float(getattr(r["jdiv"], name)), rtol=1e-4)
    for ts, js in zip(r["tsig"], r["jsig"]):
        np.testing.assert_allclose(ts.diversity, js.diversity, rtol=1e-4)
        np.testing.assert_allclose(ts.gns, js.gns, rtol=1e-4)
        np.testing.assert_allclose(ts.diversity_bound, js.diversity_bound, rtol=1e-4)
        assert ts.samples == js.samples
    assert [a == b for a, b in r["decisions"]] == [True, True]
    # read_signals(reset=True) zeroed the accumulators in place
    assert r["tstate"].div_state.sample_count.item() == 0.0


def test_slice_engine_stats_match_reference(slice_run):
    t, j = slice_run["teng"].stats.as_dict(), slice_run["jeng"].stats.as_dict()
    assert t.keys() == j.keys()
    for key in ("compiles", "bucket_hits", "bucket_misses", "steps", "reshards",
                "donate", "buckets", "rungs", "tiers"):
        assert t[key] == j[key], key
    assert t["buckets"] == [1, 2] and t["compiles"] == 2


def test_remat_and_dense_lane_give_the_same_gradients():
    """Per-layer checkpointing changes nothing in the gradients, and the
    kernel lane equals the plain dense lane under autograd."""
    cfg = get_config("yi-6b", reduced=True)
    r = np.random.default_rng(6)
    toks = _t(r.integers(0, cfg.vocab_size, size=(2, 17)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    base = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    grads = {}
    for name, kw in {"plain": dict(attn_impl="pallas"),
                     "remat": dict(attn_impl="pallas", remat=True),
                     "dense": dict(attn_impl="dense")}.items():
        model = tf.build(cfg, "cpu")
        model.load_state_dict(base.state_dict())
        model.requires_grad_(True)
        loss, _ = tf.loss_fn(cfg.replace(**kw), model, batch)
        grads[name] = [loss.detach()] + list(
            torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(grads["remat"], grads["plain"]):  # the same ops, run again
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(grads["dense"], grads["plain"]):  # another op order
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# what the slice refuses, and the launcher
# ---------------------------------------------------------------------------


def test_unported_paths_raise_and_name_the_queue(tmp_path):
    """The per-sample tiers without their hooks raise the reference's
    ValueErrors; the vmap path (per-sample gradients of example_loss), once
    refused on the LM loss, builds and steps there ("vmap" and "auto",
    ``tests/test_torch_exact_lm_train.py`` holds it against the reference).
    The XLA flash lane, once unported, gives the dense lane's loss;
    ``--ckpt-dir``, once unported, now writes a checkpoint at each tick."""
    cfg = get_config("yi-6b", reduced=True)
    with pytest.raises(ValueError, match="estimator='gram' needs probe_loss"):
        make_train_step(cfg, sgd(), 1, estimator="gram")
    with pytest.raises(ValueError, match="estimator='gram' needs probe_loss"):
        StepEngine.for_lm(cfg, sgd(), micro_batch=2).jitted(1)  # tier moment: fine
        eng = StepEngine.for_lm(cfg, sgd(), micro_batch=2)
        eng.tier = "gram"
        eng.jitted(1)
    with pytest.raises(ValueError, match="psn_impl='kernel' needs"):
        make_train_step(cfg, sgd(), 1, estimator="exact")
    with pytest.raises(ValueError, match="unknown psn_impl"):
        make_train_step(cfg, sgd(), 1, psn_impl="jvp")
    example = lambda p, e: tf.loss_fn(cfg, p, {k: v[None] for k, v in e.items()})[0]  # noqa: E731
    for kw in (dict(psn_impl="vmap"), dict(psn_impl="auto")):
        step = make_train_step(cfg, sgd(), 1, estimator="exact", example_loss=example, **kw)
        state = init_state(tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), sgd())
        state, m = step(state, TokenStream(cfg.vocab_size).batch(0, 2, 8), 0.1)
        assert np.isfinite(m["loss"].item()) and state.div_state.sq_norm_sum.item() > 0
    make_train_step(cfg, sgd(), 1, estimator="moment", example_loss=example)
    with pytest.raises(ValueError, match="unknown in-step estimator"):
        make_train_step(cfg, sgd(), 1, estimator="vmap")
    with pytest.raises(ValueError, match="estimator='exact' needs example_loss"):
        StepEngine.for_model_fns(ModelFns(batch_loss=lambda p, b: 0.0), sgd(),
                                 estimator="exact", psn_impl="vmap").jitted(8)
    eng = StepEngine(lambda n: make_train_step(cfg, sgd(), n), lm_bucket_of(2))
    eng.tier = "gram"
    with pytest.raises(ValueError, match="takes no tier argument"):
        eng.jitted(1)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    # the XLA flash lane is ported: it gives the plain dense lane's loss
    np.testing.assert_allclose(
        tf.loss_fn(cfg.replace(attn_impl="flash"), model,
                   {"tokens": toks, "targets": toks})[0].item(),
        tf.loss_fn(cfg.replace(attn_impl="dense"), model,
                   {"tokens": toks, "targets": toks})[0].item(), rtol=1e-6)
    ck = tmp_path / "ck"
    train_lm.main(["--device", "cpu", "--steps", "2", "--seq-len", "16",
                   "--epoch-steps", "2", "--ckpt-dir", str(ck)])
    assert sorted(os.listdir(ck)) == ["step_0000000002"]
    assert sorted(os.listdir(ck / "step_0000000002")) == ["extra.json", "state"]


def test_engine_bucket_keys_and_donation():
    cfg = get_config("yi-6b", reduced=True)
    with pytest.raises(ValueError, match="not divisible"):
        _to_micro(torch.zeros(6, 3), 4)
    assert _to_micro(torch.arange(8), 2).tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    eng = StepEngine.for_lm(cfg, sgd(), micro_batch=4)
    assert eng.tier == "moment"
    with pytest.raises(ValueError, match="multiple of micro_batch"):
        eng.step(None, {"tokens": torch.zeros((6, 8), dtype=torch.long)}, 0.1)
    with pytest.raises(ValueError, match="without micro_batch"):
        StepEngine.for_lm(cfg, sgd()).step(None, {"tokens": torch.zeros((4, 8))}, 0.1)
    state = init_state(tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), sgd())
    before = [p.detach().clone() for p in state.params.parameters()]
    b = TokenStream(cfg.vocab_size).batch(0, 4, 8)
    ptrs = [p.data_ptr() for p in state.params.parameters()]
    new, _ = eng.step(state, b, 0.1)
    new, _ = eng.step(new, b, 0.1)
    # donation: the caller's state is the one stepped, its tensors updated in place
    assert new is state and ptrs == [p.data_ptr() for p in new.params.parameters()]
    assert not all(torch.equal(a, p) for a, p in zip(before, new.params.parameters()))
    assert new.step == 2 and new.div_state.sample_count.item() == 8
    d = eng.stats.as_dict()
    assert d["buckets"] == [1] and d["rungs"] == [None] and d["tiers"] == ["moment"]
    assert d["donate"] is True and eng.stats.bucket_hits == 1


def test_train_lm_cli_on_cpu():
    """The launcher on the CPU at a tiny size: finite losses, a tick every 2
    steps with a decision on the num_micro lattice."""
    out = train_lm.main(["--device", "cpu", "--steps", "4", "--seq-len", "16",
                         "--micro-batch", "2", "--m0", "4", "--m-max", "8",
                         "--epoch-steps", "2"])
    recs = out["records"]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)
    ticks = [r for r in recs if "diversity" in r]
    assert len(ticks) == 2 and all(r["next_batch"] in (2, 4, 8) for r in ticks)
    assert out["engine"].stats.steps == 4


def test_train_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_lm.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# the gram tier and the exact tier's probe path
# ---------------------------------------------------------------------------


def _jax_probe_hooks(jcfg):
    return dict(probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b),
                probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, SEQ))


def _port_probe_hooks(cfg):
    return dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))


def _reduced_pair(seed):
    jcfg = jget("yi-6b", reduced=True).replace(scan_layers=False)
    cfg = get_config("yi-6b", reduced=True)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _tree_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-5 * np.sqrt(np.mean(b ** 2)))


def _grad_sum_tree(div, cfg):
    """The port's grad_sum (keyed by parameter name) as the reference tree."""
    model = tf.build(cfg, "cpu", torch.float32)
    model.load_state_dict(div.grad_sum)
    return params_to_numpy(model, cfg)


@pytest.mark.parametrize("num_micro", [1, 2])
@pytest.mark.parametrize("estimator", ["gram", "exact"])
def test_probe_tier_steps_match_reference(estimator, num_micro):
    """3 sgd steps of the gram tier (or the exact tier with
    ``psn_impl="kernel"``, which adds each layer's bias term) on batches of
    4 sequences: losses, the diversity accumulators and the parameters."""
    jcfg, cfg, jparams, params = _reduced_pair(5)
    kw = dict(estimator=estimator, **({"psn_impl": "kernel"} if estimator == "exact" else {}))
    jstep = jax.jit(jmake_train_step(jcfg, jsgd(), num_micro, psn_interpret=True,
                                     **kw, **_jax_probe_hooks(jcfg)))
    tstep = make_train_step(cfg, sgd(), num_micro, **kw, **_port_probe_hooks(cfg))
    jstate, tstate = jinit_state(jparams, jsgd()), init_state(params, sgd())
    stream = TokenStream(cfg.vocab_size, seed=3)
    for step in range(3):
        b = stream.batch(step, 4, SEQ)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.float32(0.1))
        tstate, tm = tstep(tstate, b, 0.1)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tstate.div_state.sq_norm_sum.item(),
                                   float(jstate.div_state.sq_norm_sum), rtol=1e-5)
    for name in ("mb_count", "sample_count"):
        assert getattr(tstate.div_state, name).item() == \
            float(getattr(jstate.div_state, name))
    _tree_close(_grad_sum_tree(tstate.div_state, cfg), jstate.div_state.grad_sum)
    _tree_close(params_to_numpy(tstate.params, cfg), jstate.params)


def test_tier_flips_and_gram_signals_match_reference():
    """Hand-built tiered engines in both packages over moment -> gram ->
    moment flips and a resize: the same step keys, tiers and hit counts; at
    two ticks the signals read with "gram" feed a DiveBatch program each,
    which must decide identically."""
    jcfg, cfg, jparams, params = _reduced_pair(7)
    jeng = JStepEngine(
        lambda n, tier: jmake_train_step(jcfg, jsgd(momentum=0.9), n, estimator=tier,
                                         psn_interpret=True, **_jax_probe_hooks(jcfg)),
        bucket_of=lambda batch: int(jax.tree.leaves(batch)[0].shape[0]) // 2)
    teng = StepEngine(
        lambda n, tier: make_train_step(cfg, sgd(momentum=0.9), n, estimator=tier,
                                        **_port_probe_hooks(cfg)),
        lm_bucket_of(2))
    assert teng.tiered and teng.tier is None
    jstate = jinit_state(jparams, jsgd(momentum=0.9))
    tstate = init_state(params, sgd(momentum=0.9))
    stream = TokenStream(cfg.vocab_size, seed=4)

    def program(pkg):
        return pkg.AdaptationProgram(
            pkg.DiveBatchPolicy(4, 8, delta=4.0, dataset_size=None, granule=2,
                                on_tick=True), 0.1, estimator="gram", tick_every=2)

    jprog, tprog = program(jadapt), program(adapt)
    tiers = ["moment", "gram", "gram", "moment", "gram", "gram"]
    m, decided = 4, []
    for step, tier in enumerate(tiers):
        jeng.tier = teng.tier = tier
        b = stream.batch(step, m, SEQ)
        jstate, jm = jeng.step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, 0.1)
        tstate, tm = teng.step(tstate, b, 0.1)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        if step in (2, 5):  # a tick over a window of two gram steps
            jsig, jstate = jadapt.read_signals(jstate, "gram", reset=True, batch_size=m)
            tsig, tstate = adapt.read_signals(tstate, "gram", reset=True, batch_size=m)
            for field in ("diversity", "gns", "diversity_bound"):
                np.testing.assert_allclose(getattr(tsig, field), getattr(jsig, field),
                                           rtol=1e-4)
            clock = dict(epoch=0, step=step + 1, boundary="tick")
            ja = jprog.observe(jsig, jadapt.Clock(**clock))
            ta = tprog.observe(tsig, adapt.Clock(**clock))
            td, jd = dataclasses.asdict(ta), dataclasses.asdict(ja)
            assert td.keys() == jd.keys()
            for key, val in td.items():
                if isinstance(val, float):
                    np.testing.assert_allclose(val, jd[key], rtol=1e-5)
                else:
                    assert val == jd[key], key
            m = tprog.batch_size
        elif tier == "moment":  # a moment step leaves no statistic in a gram window
            jsig, jstate = jadapt.read_signals(jstate, "moment", reset=True, batch_size=m)
            adapt.read_signals(tstate, "moment", reset=True, batch_size=m)
        decided.append(m)
    assert len(set(decided)) > 1  # the gram signals resized the batch
    t, j = teng.stats.as_dict(), jeng.stats.as_dict()
    for key in ("compiles", "bucket_hits", "bucket_misses", "steps", "buckets", "rungs",
                "tiers"):
        assert t[key] == j[key], key
    assert t["tiers"][:2] == ["moment", "gram"] and t["bucket_hits"] >= 2


def test_schedules_match_reference():
    from repro.optim import make_schedule as jmake
    from repro_torch.optim import make_schedule

    for name, kw in (("constant", {}),
                     ("warmup_cosine", dict(warmup_steps=5, total_steps=40)),
                     ("step_decay", dict(decay_factor=0.5, every_steps=7))):
        ours, ref_ = make_schedule(name, **kw), jmake(name, **kw)
        for step in (0, 3, 5, 6, 21, 40, 55):
            np.testing.assert_allclose(ours(step), float(ref_(jnp.int32(step))), rtol=1e-6)
