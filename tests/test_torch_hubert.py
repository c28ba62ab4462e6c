"""The port's encoder path (hubert-xlarge) against the JAX reference, on the CPU.

hubert-xlarge is the reference's encoder: non-causal attention, an
embedding frontend (a bias-free dense layer on precomputed frame
embeddings in place of the token table), layer norm and a GELU MLP.  Here
the reduced config (2 layers, d_model 64, 4 heads of hd 16) and a
hubert-shaped one at the full model's head dim 80 (d_model 160, 2 heads),
with the reference's own random weights carried over by
``interop.params_from_jax``; frame batches from ``train_lm.frame_batches``
(numpy from a seed, as ``tests/test_smoke_archs.py`` makes them:
embeddings N(0, 1), targets uniform over the vocabulary).  The reference runs its Pallas flash kernel
with ``causal=False`` in interpret mode where ``attn_impl="pallas"``; the
port runs on the CPU, where its kernel wrappers take their plain versions.

Tolerances, float32 throughout: the loss within 1e-6 relative, the
encoder's logits within 1e-5 absolute (other summation orders over 64-160
wide dots); the whole-slice train steps within the bounds of
``tests/test_torch_train.py``'s slice (losses 1e-5 relative, parameters
2e-4 absolute, the signals 1e-4 relative); per-sample norms 1e-5
relative.  Discrete outputs (batch sizes, buckets, decisions, checkpoint
paths and shapes) must match exactly, and a checkpoint carries every
leaf bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adapt as jadapt
from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import load_pytree as jload
from repro.configs import get_config as jget
from repro.models import probes as jprobes
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.train import StepEngine as JStepEngine
from repro.train import init_state as jinit_state
from repro_torch import adapt, interop
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import train_lm
from repro_torch.models import probes
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, init_state

torch.set_num_threads(2)

SEQ = 32
# hubert-xlarge's head dim (80) at a width the CPU runs in moments
HD80 = dict(d_model=160, num_heads=2, num_kv_heads=2, d_ff=320)


def _pair(extra: dict | None = None, seed: int = 0, **jextra):
    jcfg = jget("hubert-xlarge", reduced=True).replace(**(extra or {}), **jextra)
    cfg = get_config("hubert-xlarge", reduced=True).replace(**(extra or {}))
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _both(b: dict):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_hubert_config_is_a_copy():
    for reduced in (False, True):
        assert dataclasses.asdict(get_config("hubert-xlarge", reduced)) == \
            dataclasses.asdict(jget("hubert-xlarge", reduced))
    cfg = get_config("hubert-xlarge")
    assert (cfg.resolved_head_dim, cfg.causal, cfg.input_mode) == (80, False, "embeddings")


def test_hubert_frontend_init_and_layout():
    """The frontend takes the token table's place: N(0, 1/d_in), stored as
    the reference's ``frontend/kernel`` (transposed), carried both ways."""
    cfg = get_config("hubert-xlarge", reduced=True).replace(d_model=256, num_heads=4,
                                                           num_kv_heads=4)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not hasattr(model, "embed")
    w = model.frontend.weight
    assert w.shape == (256, 256) and model.frontend.bias is None
    np.testing.assert_allclose(w.std().item(), 256 ** -0.5, rtol=0.02)
    leaf = next(lf for lf in interop.layout(model) if lf.names == ["frontend.weight"])
    assert (leaf.path, leaf.form, leaf.stacked) == ("frontend/kernel", "t", False)
    _, cfg, jparams, params = _pair()
    tree = interop.params_to_numpy(params)
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("extra", [{}, HD80], ids=["reduced", "hd80"])
@pytest.mark.parametrize("attn_impl", ["dense", "pallas"])
def test_hubert_loss_fn_matches_reference(attn_impl, extra):
    """The training loss on frames: the frontend, the non-causal stack and
    the chunked cross-entropy, on the plain lane and the kernel lane."""
    jcfg, cfg, jparams, params = _pair({**extra, "attn_impl": attn_impl}, seed=1)
    jb, tb = _both(train_lm.frame_batches(cfg, 1)(0, 3, SEQ))
    jloss, _ = jtf.loss_fn(jcfg, jparams, jb)
    loss, metrics = tf.loss_fn(cfg, params, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert metrics["ce_loss"] is loss


@pytest.mark.parametrize("extra", [{}, HD80], ids=["reduced", "hd80"])
def test_hubert_prefill_step_matches_reference(extra):
    """The encoder branch of ``prefill_step``: float32 logits at every
    position and an empty cache, on the kernel lane (flash, non-causal)."""
    jcfg, cfg, jparams, params = _pair({**extra, "attn_impl": "pallas"}, seed=2)
    jb, tb = _both(train_lm.frame_batches(cfg, 2)(0, 2, SEQ))
    jlogits, jcache = jtf.prefill_step(jcfg, jparams, jb)
    logits, cache = tf.prefill_step(cfg, params, tb)
    assert cache == {} and jcache == {}
    assert logits.shape == (2, SEQ, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    # the causal mask is off: the first position's logits depend on the last frame
    tb["embeddings"][:, -1] += 1.0
    assert not torch.allclose(tf.prefill_step(cfg, params, tb)[0][:, 0], logits[:, 0])


def test_prefill_step_refuses_a_causal_config():
    """A causal config is no longer refused: ``prefill_step`` runs its causal
    branch on the kernel lane, the last position's logits and the dense
    cache (each layer's keys and values) match the reference's."""
    jcfg = jget("yi-6b", reduced=True).replace(attn_impl="pallas")
    cfg = get_config("yi-6b", reduced=True).replace(attn_impl="pallas")
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    model = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    jlogits, jcache = jtf.prefill_step(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = tf.prefill_step(cfg, model, {"tokens": torch.from_numpy(toks).long()})
    assert logits.shape == (2, 1, cfg.vocab_size) and int(cache["len"]) == 8
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["pos0"][kv].numpy(), np.asarray(jcache["pos0"][kv]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra", [{}, HD80], ids=["reduced", "hd80"])
def test_hubert_persample_sq_norms_gram_matches_reference(extra):
    """The gram tier's per-sample norms on frames (the frontend is not
    probed, as in the reference), and the coverage."""
    jcfg, cfg, jparams, params = _pair(extra, seed=4, scan_layers=False)
    jb, tb = _both(train_lm.frame_batches(cfg, 4)(0, 3, 16))
    got = probes.persample_sq_norms_gram(cfg, params, tb)
    want = jprobes.persample_sq_norms_gram(jcfg, jparams, jb)
    assert got.shape == (3,) and bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert probes.coverage(cfg) == jprobes.coverage(jcfg)
    assert probes.coverage(get_config("hubert-xlarge")) == \
        jprobes.coverage(jget("hubert-xlarge"))


# ---------------------------------------------------------------------------
# the slice as a whole: StepEngine.for_lm on the reduced encoder
# ---------------------------------------------------------------------------


def _program(pkg):
    return pkg.AdaptationProgram(
        pkg.DiveBatchPolicy(4, 16, delta=0.5, dataset_size=None, granule=4, on_tick=True),
        0.1, tick_every=3)


@pytest.fixture(scope="module")
def slice_run():
    """Reduced hubert, ``for_lm(micro_batch=4, attn_impl="pallas")``, sgd with
    momentum: 3 steps at num_micro 1 then 3 at num_micro 2 on the same frame
    batches in both packages, the signals read and reset after each half
    and fed to a tick-fired DiveBatch program."""
    jcfg, cfg, jparams, params = _pair({"remat": True}, seed=3)
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=4, attn_impl="pallas")
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=4, attn_impl="pallas")
    jstate = jinit_state(jparams, jsgd(momentum=0.9))
    tstate = init_state(params, sgd(momentum=0.9))
    source = train_lm.frame_batches(cfg, 3)
    jprog, tprog = _program(jadapt), _program(adapt)
    out = {"jloss": [], "tloss": [], "jsig": [], "tsig": [], "decisions": []}
    for step in range(6):
        m = 4 if step < 3 else 8
        jb, tb = _both(source(step, m, SEQ))
        jstate, jm = jeng.step(jstate, jb, 0.1)
        tstate, tm = teng.step(tstate, tb, 0.1)
        out["jloss"].append(float(jm["loss"]))
        out["tloss"].append(float(tm["loss"]))
        if step in (2, 5):
            jsig, jstate = jadapt.read_signals(jstate, "moment", reset=True, batch_size=m)
            tsig, tstate = adapt.read_signals(tstate, "moment", reset=True, batch_size=m)
            out["jsig"].append(jsig)
            out["tsig"].append(tsig)
            clock = dict(epoch=step // 3, step=step + 1, boundary="tick")
            ja = jprog.observe(jsig, jadapt.Clock(**clock))
            ta = tprog.observe(tsig, adapt.Clock(**clock))
            out["decisions"].append((ja.batch_size, ta.batch_size))
    out.update(jstate=jstate, tstate=tstate, jeng=jeng, teng=teng)
    return out


def test_hubert_slice_losses_params_and_signals_match_reference(slice_run):
    r = slice_run
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-5)
    assert all(np.isfinite(r["tloss"]))
    got = interop.params_to_numpy(r["tstate"].params)
    want = jax.tree.map(np.asarray, r["jstate"].params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=2e-4)
    for ts, js in zip(r["tsig"], r["jsig"]):
        np.testing.assert_allclose(ts.diversity, js.diversity, rtol=1e-4)
        np.testing.assert_allclose(ts.gns, js.gns, rtol=1e-4)
        assert ts.samples == js.samples
    assert all(a == b for a, b in r["decisions"])


def test_hubert_slice_engine_stats_match_reference(slice_run):
    t, j = slice_run["teng"].stats.as_dict(), slice_run["jeng"].stats.as_dict()
    for key in ("compiles", "bucket_hits", "bucket_misses", "steps", "buckets", "tiers"):
        assert t[key] == j[key], key
    assert t["buckets"] == [1, 2]


def test_train_lm_takes_a_frame_source():
    """``train_lm.train(batches=...)`` trains the encoder on frames: finite
    losses, a tick every 2 steps, the batch on the num_micro lattice; the
    same source twice gives the same run."""
    cfg = get_config("hubert-xlarge", reduced=True).replace(attn_impl="pallas")
    runs = []
    for _ in range(2):
        params = tf.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        prog = train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5, granule=2,
                                     lr=0.05, tick_every=2)
        runs.append(train_lm.train(cfg, params, prog, steps=4, seq_len=16, micro_batch=2,
                                   batches=train_lm.frame_batches(cfg, 6), log=lambda s: None))
    recs = runs[0]["records"]
    assert all(np.isfinite(x["loss"]) for x in recs)
    assert [("next_batch" in x) for x in recs] == [False, True, False, True]
    assert all(x["batch"] % 2 == 0 and x["num_micro"] == x["batch"] // 2 for x in recs)
    assert [x["loss"] for x in recs] == [x["loss"] for x in runs[1]["records"]]


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _leaves_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _port_trees(state):
    """The port state's params, momenta and grad_sum as reference trees."""
    model = state.params
    names = list(dict(model.named_parameters()))

    def tree(named):
        return jax.tree.map(lambda t: t.detach().numpy(), interop.to_reference(model, named))

    return (tree(dict(model.named_parameters())),
            tree(dict(zip(names, state.opt_state.momentum))),
            tree(state.div_state.grad_sum))


def test_hubert_checkpoint_written_by_the_port_reads_in_the_reference(tmp_path):
    """``train_lm``'s tick checkpoint of a float32 hubert state loads in the
    reference (paths, shapes and dtypes of its own ``init_state``), every
    leaf equal; the reference then steps on from it as the port does."""
    cfg = get_config("hubert-xlarge", reduced=True).replace(attn_impl="pallas")
    jcfg = jget("hubert-xlarge", reduced=True).replace(attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    prog = train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5, granule=2, lr=0.05,
                                 tick_every=2)
    source = train_lm.frame_batches(cfg, 7)
    out = train_lm.train(cfg, params, prog, steps=2, seq_len=16, micro_batch=2,
                         batches=source, ckpt=CheckpointManager(str(tmp_path / "ck")),
                         log=lambda s: None)
    template = jinit_state(jtf.init_params(jcfg, jax.random.key(0)), jsgd(momentum=0.9))
    loaded = jload(str(tmp_path / "ck" / "step_0000000002" / "state"), template)
    state = out["state"]
    ptree, mtree, gtree = _port_trees(state)
    _leaves_equal(loaded.params, ptree)
    _leaves_equal(loaded.opt_state.momentum, mtree)
    _leaves_equal(loaded.div_state.grad_sum, gtree)
    assert int(loaded.step) == 2
    # one more step in each package from the same state and batch
    m = prog.batch_size
    jb, tb = _both(source(2, m, 16))
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=2, attn_impl="pallas")
    jstate, jm = jeng.step(loaded, jb, prog.lr)
    state, tm = out["engine"].step(state, tb, prog.lr)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(state.params)),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4)


def test_hubert_checkpoint_written_by_the_reference_resumes_in_the_port(tmp_path):
    """A reference ``TrainState`` of the reduced hubert after one step,
    saved by the reference's manager with its program, restores through
    ``train_lm.resume`` into a fresh port state (every leaf equal), and the
    resumed port run steps on as the reference does."""
    jcfg, cfg, jparams, _ = _pair({"attn_impl": "pallas"}, seed=8)
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=2, attn_impl="pallas")
    jprog = jadapt.AdaptationProgram(
        jadapt.DiveBatchPolicy(4, 8, delta=0.5, dataset_size=None, granule=2, on_tick=True),
        0.05, estimator="moment", tick_every=2)
    source = train_lm.frame_batches(cfg, 8)
    jb, _ = _both(source(0, 4, 16))
    jstate, _ = jeng.step(jinit_state(jparams, jsgd(momentum=0.9)), jb, 0.05)
    JManager(str(tmp_path / "ck")).save(1, {"state": jstate},
                                        extra={"program": jprog.state_dict()})
    fresh = tf.init_params(cfg, torch.Generator().manual_seed(99), "cpu")
    prog = train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5, granule=2, lr=0.05,
                                 tick_every=2)
    state, step = train_lm.resume(CheckpointManager(str(tmp_path / "ck")),
                                  init_state(fresh, sgd(momentum=0.9)), prog)
    assert step == 1 and state.step == 1
    ptree, mtree, gtree = _port_trees(state)
    _leaves_equal(ptree, jstate.params)
    _leaves_equal(mtree, jstate.opt_state.momentum)
    _leaves_equal(gtree, jstate.div_state.grad_sum)
    jb, tb = _both(source(1, 4, 16))
    jstate, jm = jeng.step(jstate, jb, 0.05)
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, attn_impl="pallas")
    state, tm = teng.step(state, tb, 0.05)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(state.params)),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4)
