"""The exact tier's vmap path on the LM loss through the port's entry
points, against the JAX reference on the CPU, and the vmap rules under it.

``make_train_step(cfg, ..., estimator="exact", example_loss=...)`` (the LM
loss, ``psn_impl`` "vmap" and "auto", ``psn_chunk`` 2) and
``StepEngine.for_model_fns`` take 3 and 2 sgd steps on reduced Yi-6B (remat
on, the ``pallas`` lane) beside the reference's, at
``tests/test_torch_train.py``'s tolerances: losses and ``sq_norm_sum``
within 1e-5 relative, ``grad_sum`` and the parameters within 1e-5 relative
plus 5e-5 of each tensor's RMS.  ``dataset_diversity`` (the Oracle) on
reduced dbrx-132b within 1e-5 relative.

The vmap rules, port only: ``xent_chunked`` under ``vmap`` gives each index
its own mean, and its gradient each index's own (against a loop, 1e-6
relative); the kernel lane's ``flash_attention`` folds any ``in_dims`` into
B (against a loop, 1e-6 relative); and a spy on the kernel lane's
wrappers shows one forward and one backward call per layer for each
``psn_chunk`` fold, not one per sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exact_lm import batch, jax_example_loss, pair, port_example_loss
from repro.core import diversity as jdiv
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.train import ModelFns as JModelFns
from repro.train import StepEngine as JStepEngine
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.core import diversity
from repro_torch.interop import params_to_numpy
from repro_torch.kernels import attention as kattn
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import ModelFns, StepEngine, init_state, make_train_step

torch.set_num_threads(2)

YI_PALLAS = dict(attn_impl="pallas")


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


def _jnp(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def _states_close(tstate, jstate, cfg):
    np.testing.assert_allclose(tstate.div_state.sq_norm_sum.item(),
                               float(jstate.div_state.sq_norm_sum), rtol=1e-5)
    for name in ("mb_count", "sample_count"):
        assert getattr(tstate.div_state, name).item() == \
            float(getattr(jstate.div_state, name))
    _tree_close(_grad_sum_tree(tstate.div_state, cfg), jstate.div_state.grad_sum)
    _tree_close(params_to_numpy(tstate.params, cfg), jstate.params)


@pytest.mark.parametrize("num_micro,psn_impl", [(1, "vmap"), (2, "auto")])
def test_exact_tier_steps_match_reference(num_micro, psn_impl):
    """3 sgd steps on batches of 4 sequences, per-sample gradients 2 at a
    time: losses, the diversity accumulators and the parameters."""
    jcfg, cfg, jparams, params = pair("yi-6b", 5, **YI_PALLAS)
    kw = dict(estimator="exact", psn_impl=psn_impl, psn_chunk=2)
    jstep = jax.jit(jmake_train_step(jcfg, jsgd(), num_micro,
                                     example_loss=jax_example_loss(jcfg), **kw))
    tstep = make_train_step(cfg, sgd(), num_micro, example_loss=port_example_loss(cfg), **kw)
    jstate, tstate = jinit_state(jparams, jsgd()), init_state(params, sgd())
    for step in range(3):
        b = batch(cfg, 10 + step, n=4)
        jstate, jm = jstep(jstate, _jnp(b), jnp.float32(0.1))
        tstate, tm = tstep(tstate, b, 0.1)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tstate.div_state.sq_norm_sum.item(),
                                   float(jstate.div_state.sq_norm_sum), rtol=1e-5)
    _states_close(tstate, jstate, cfg)


def test_model_fns_engine_runs_the_exact_tier_on_the_lm():
    """``StepEngine.for_model_fns`` over the LM loss and its per-sample
    loss, momentum sgd, 2 steps of 4 sequences in both packages."""
    jcfg, cfg, jparams, params = pair("yi-6b", 6, **YI_PALLAS)
    jeng = JStepEngine.for_model_fns(
        JModelFns(batch_loss=lambda p, b: jtf.loss_fn(jcfg, p, b)[0],
                  example_loss=jax_example_loss(jcfg)),
        jsgd(momentum=0.9), estimator="exact", psn_chunk=2)
    teng = StepEngine.for_model_fns(
        ModelFns(batch_loss=lambda p, b: tf.loss_fn(cfg, p, b)[0],
                 example_loss=port_example_loss(cfg)),
        sgd(momentum=0.9), estimator="exact", psn_chunk=2)
    jstate, tstate = jinit_state(jparams, jsgd(momentum=0.9)), init_state(params,
                                                                         sgd(momentum=0.9))
    for step in range(2):
        b = batch(cfg, 20 + step, n=4)
        jstate, jm = jeng.step(jstate, _jnp(b), 0.1)
        tstate, tm = teng.step(tstate, b, 0.1)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    _states_close(tstate, jstate, cfg)
    assert teng.stats.as_dict()["tiers"] == jeng.stats.as_dict()["tiers"] == ["exact"]


def test_dataset_diversity_matches_reference():
    """The Oracle's exact Delta over two batches of 3 sequences, reduced
    dbrx-132b (MoE) with remat on."""
    jcfg, cfg, jparams, model = pair("dbrx-132b", 7)
    batches = [batch(cfg, 30 + i) for i in range(2)]
    want = jdiv.dataset_diversity(jax_example_loss(jcfg), jparams, map(_jnp, batches))
    got = diversity.dataset_diversity(
        port_example_loss(cfg), model,
        ({k: torch.from_numpy(v) for k, v in b.items()} for b in batches))
    assert np.isfinite(float(want)) and float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_xent_chunked_under_vmap_keeps_each_index_apart(softcap):
    """``vmap`` of the chunked cross-entropy over x and targets (the head
    shared), and over a head per index: each index's own mean and its own
    gradients, as a loop gives them."""
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.standard_normal((3, 2, 16, 8)).astype(np.float32))
    w = torch.from_numpy((r.standard_normal((23, 8)) * 0.5).astype(np.float32))
    ws = torch.from_numpy((r.standard_normal((3, 23, 8)) * 0.5).astype(np.float32))
    t = torch.from_numpy(r.integers(0, 23, size=(3, 2, 16)))

    def loss(x_, w_, t_):
        return tf.xent_chunked(x_, w_, t_, 4, softcap)

    got = torch.func.vmap(loss, in_dims=(0, None, 0))(x, w, t)
    want = torch.stack([loss(x[i], w, t[i]) for i in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    got = torch.func.vmap(loss, in_dims=(1, 0, None))(x.transpose(0, 1), ws, t[0])
    want = torch.stack([loss(x[i], ws[i], t[0]) for i in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    gx, gw = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                             in_dims=(0, None, 0))(x, w, t)
    for i in range(3):
        xi, wi = x[i].clone().requires_grad_(True), w.clone().requires_grad_(True)
        lx, lw = torch.autograd.grad(loss(xi, wi, t[i]), (xi, wi))
        torch.testing.assert_close(gx[i], lx, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(gw[i], lw, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 5, 20.0),
                                                   (False, None, None)])
def test_kernel_lane_flash_attention_folds_any_in_dims(causal, window, softcap):
    """Per-sample gradients of the kernel lane's ``flash_attention`` with q
    vmapped on axis 0, k on axis 1 and v shared (expanded in the fold),
    against a loop of ``torch.autograd.grad``."""
    r = np.random.default_rng(9)

    def arr(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32))

    q, k, v, w = arr(3, 1, 12, 4, 16), arr(1, 3, 12, 2, 16), arr(1, 12, 2, 16), arr(12, 4, 16)

    def f(q_, k_, v_):
        return (kattn.flash_attention(q_, k_, v_, causal, window, softcap) * w).sum()

    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)), in_dims=(0, 1, None))(q, k, v)
    for i in range(3):
        leaves = [t.clone().requires_grad_(True) for t in (q[i], k[:, i], v)]
        want = torch.autograd.grad(f(*leaves), leaves)
        for g, lg in zip(got, want):
            torch.testing.assert_close(g[i], lg, rtol=1e-6, atol=1e-6)


def test_kernel_lane_runs_once_per_layer_for_each_fold(monkeypatch):
    """A train step on the exact tier (microbatch 4, ``psn_chunk`` 2) calls
    the kernel lane's forward wrapper and its backward (the CPU's plain
    ``flash_grads_ref``, the card's dq and dk/dv) per layer: the main pass
    twice forward (remat) and once backward at B 4, then each fold of 2
    samples once forward and once backward at B 2, never at B 1."""
    _, cfg, _, params = pair("yi-6b", 11, **YI_PALLAS)
    calls = []

    def spy(name, fn):
        def wrapped(q, *args, **kw):
            calls.append((name, q.shape[0]))
            return fn(q, *args, **kw)
        return wrapped

    monkeypatch.setattr(kattn, "chunk_attention_fwd", spy("fwd", kattn.chunk_attention_fwd))
    monkeypatch.setattr(kattn.ref, "flash_grads_ref", spy("bwd", kattn.ref.flash_grads_ref))
    step = make_train_step(cfg, sgd(), 1, estimator="exact",
                           example_loss=port_example_loss(cfg), psn_chunk=2)
    _, m = step(init_state(params, sgd()), batch(cfg, 12, n=4), 0.1)
    n = cfg.num_layers
    main = [("fwd", 4)] * 2 * n + [("bwd", 4)] * n
    fold = [("fwd", 2)] * n + [("bwd", 2)] * n
    assert sorted(calls[:3 * n]) == sorted(main)
    assert calls[3 * n:] == fold + fold
    assert np.isfinite(m["loss"].item())
