"""The port's MoE FFN and the MoE architectures against the JAX reference,
on the CPU.

``models/moe.py`` against ``repro.models.moe``: ``moe_apply`` at 1, 2 and
4 groups and capacity factors 1.0 (assignments dropped) and 8.0 (none),
its gradients, ``moe_reference``, the top-k order among ties and the
capacity.  Then dbrx-132b and kimi-k2-1t-a32b at the reference's own
``reduced()`` sizes (2 layers, d_model 64, 4 and 8 experts, top 2, hd 16,
float32) with the reference's random weights carried over by
``interop.params_from_jax`` and inputs made with numpy from a seed: the
loss with its aux term and its gradients, ``prefill_step`` then lockstep
decode, ``prefill_chunk``, the engines, ``for_lm(moe_groups=2)``, the gram
tier and ``coverage``; the float32 router of a bf16 model through
``init_params``, ``params_from_jax`` and a checkpoint.  Where the
reference reaches a Pallas kernel it runs in interpret mode; the port runs
on the CPU, where its kernel wrappers take their plain versions.

Tolerances: the MoE layer's outputs and aux loss within 1e-6 relative
plus 1e-6 absolute (float32; other summation orders over 32-48 wide
dots), its gradients within 1e-5; the models' logits, losses, gradients
and caches within 1e-5 relative and absolute; the training runs within the
bounds of ``tests/test_torch_dense_archs.py``.  Discrete outputs match
exactly: dropped counts, greedy tokens, engine counts, batch schedules.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adapt as jadapt
from repro.ckpt import save_pytree as jsave
from repro.configs import get_config as jget
from repro.models import moe as jmoe
from repro.models import probes as jprobes
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import StepEngine as JStepEngine
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import adapt, interop
from repro_torch.ckpt import load_pytree, save_pytree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import TokenStream
from repro_torch.dist.plan import Mesh, ShardingPlan, use_plan
from repro_torch.models import moe, probes
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import StepEngine, init_state, make_train_step

torch.set_num_threads(2)

MOE = ("dbrx-132b", "kimi-k2-1t-a32b")
TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
D, F_, E, K = 32, 48, 8, 2  # the standalone layer: widths, experts, top-k
SEQ = 32


def _pair(arch: str, seed: int = 0, **extra):
    jcfg = jget(arch, reduced=True).replace(**extra)
    cfg = get_config(arch, reduced=True).replace(**extra)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _t(a) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _tree_close(got: dict, want: dict, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _layer(seed: int = 0):
    """The reference's ``moe_init`` tree and a port ``MoE`` holding it."""
    jp = jmoe.moe_init(jax.random.key(seed), D, F_, E)
    layer = moe.MoE(D, F_, E, torch.float32)
    with torch.no_grad():
        layer.router.weight.copy_(_t(jp["router"]["kernel"]).t())
        for name in ("w_gate", "w_up", "w_out"):
            getattr(layer, name).copy_(_t(jp[name]))
    return jp, layer


def _jax_counts(jp, x, top_k, factor, groups) -> tuple[int, int]:
    """The assignments the reference's ``moe_apply`` drops, and the tokens
    whose first expert is their group's commonest first expert, from its
    own ``_route`` and ``_capacity`` and the cumsum numbering."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    tg = xt.shape[0] // groups
    cap = jmoe._capacity(tg, top_k, E, factor)
    dropped = first_top = 0
    for g in range(groups):
        _, experts = jmoe._route(jp["router"]["kernel"], xt[g * tg:(g + 1) * tg], top_k)
        oh = jax.nn.one_hot(experts.reshape(-1), E, dtype=jnp.int32)
        pos = ((jnp.cumsum(oh, axis=0) - 1) * oh).sum(-1)
        dropped += int((pos >= cap).sum())
        first_top += int(np.bincount(np.asarray(experts[:, 0]), minlength=E).max())
    return dropped, first_top


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [1.0, 8.0])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_apply_matches_reference(groups, factor):
    """64 tokens (B 2, S 32): outputs, the aux loss and the dropped count;
    factor 1.0 drops assignments at every grouping, 8.0 none."""
    jp, layer = _layer(seed=groups)
    x = np.random.default_rng(groups).standard_normal((2, SEQ, D)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=K, capacity_factor=factor,
                              groups=groups)
    layer.stats = {}
    y, aux = moe.moe_apply(layer, _t(x), top_k=K, capacity_factor=factor, groups=groups)
    assert y.shape == x.shape and aux.dtype == torch.float32
    _close(y, jy, **LAYER_TOL)
    _close(aux, jaux, **LAYER_TOL)
    want, first_top = _jax_counts(jp, x, K, factor, groups)
    assert int(layer.stats["dropped"]) == want and layer.stats["assignments"] == 2 * SEQ * K
    assert int(layer.stats["first_top"]) == first_top
    assert (want > 0) == (factor == 1.0)


@pytest.mark.parametrize("groups,factor", [(1, 8.0), (2, 1.0)])
def test_moe_gradients_match_reference(groups, factor):
    """The gradients of ``sum(y * w) + 3 aux`` w.r.t. x and all four
    tensors against ``jax.grad``, with and without drops."""
    jp, layer = _layer(seed=7)
    r = np.random.default_rng(8)
    x = r.standard_normal((2, SEQ, D)).astype(np.float32)
    w = r.standard_normal((2, SEQ, D)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, top_k=K, capacity_factor=factor, groups=groups)
        return jnp.sum(y * w) + 3.0 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    layer.requires_grad_(True)
    y, aux = moe.moe_apply(layer, tx, top_k=K, capacity_factor=factor, groups=groups)
    ((y * _t(w)).sum() + 3.0 * aux).backward()
    grad_tol = dict(rtol=1e-5, atol=1e-5)
    _close(tx.grad, jgx, **grad_tol)
    _close(layer.router.weight.grad.t(), jgp["router"]["kernel"], **grad_tol)
    for name in ("w_gate", "w_up", "w_out"):
        _close(getattr(layer, name).grad, jgp[name], **grad_tol)


def test_moe_reference_matches_reference():
    """The dense oracle against the reference's, and ``moe_apply`` at a
    capacity where nothing drops against it."""
    jp, layer = _layer(seed=3)
    x = np.random.default_rng(3).standard_normal((3, 20, D)).astype(np.float32)
    want = jmoe.moe_reference(jp, jnp.asarray(x), top_k=K)
    got = moe.moe_reference(layer, _t(x), top_k=K)
    _close(got, want, **LAYER_TOL)
    layer.stats = {}
    y, _ = moe.moe_apply(layer, _t(x), top_k=K, capacity_factor=E / K)
    assert int(layer.stats["dropped"]) == 0
    _close(y, want, **LAYER_TOL)


def test_top_k_orders_ties_like_lax_top_k():
    """Equal probabilities keep the lower expert first, as ``jax.lax.top_k``
    does: exact ties in rows of 8 and of 384 (kimi-k2's experts)."""
    r = np.random.default_rng(0)
    for e in (8, 384):
        p = np.round(r.uniform(size=(64, e)) * 4) / 4  # 5 distinct values: many ties
        p[0] = 0.5
        jv, ji = jax.lax.top_k(jnp.asarray(p, jnp.float32), 8)
        tv, ti = moe._top_k(torch.from_numpy(p.astype(np.float32)), 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_capacity_matches_reference():
    for tg in (1, 7, 8, 64, 256, 4096):
        for k, e in ((2, 4), (4, 16), (8, 384)):
            for f in (1.0, 1.25, 4.0, 48.0):
                assert moe._capacity(tg, k, e, f) == jmoe._capacity(tg, k, e, f)


# ---------------------------------------------------------------------------
# the MoE configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_moe_config_is_a_copy(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(jget(arch, reduced))
    assert arch in ARCH_NAMES
    full = get_config(arch)
    assert (full.num_heads // full.num_kv_heads, full.resolved_head_dim) == \
        {"dbrx-132b": (6, 128), "kimi-k2-1t-a32b": (8, 112)}[arch]


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch):
    """S 32, B 4, two MoE groups, remat on (the checkpointed layer returns
    its aux too): the loss with its ``0.01 * aux`` term, ``ce_loss``,
    ``moe_aux`` and every parameter's gradient (the router's and the
    experts' included)."""
    jcfg, cfg, jparams, params = _pair(arch, seed=1, attn_impl="dense", remat=True)
    r = np.random.default_rng(3)
    x = r.integers(1, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)
    tgt = r.integers(0, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(x), "targets": jnp.asarray(tgt)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jb, moe_groups=2), has_aux=True)(jparams)
    params.requires_grad_(True)
    loss, m = tf.loss_fn(cfg, params, {"tokens": _t(x), "targets": _t(tgt)}, moe_groups=2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(m["ce_loss"].item(), float(jm["ce_loss"]), **TOL)
    np.testing.assert_allclose(m["moe_aux"].item(), float(jm["moe_aux"]), **TOL)
    assert m["moe_aux"].item() > 1.0  # two layers' aux, each near 1 when balanced
    grads = interop.to_reference(params, {n: p.grad for n, p in params.named_parameters()})
    _tree_close(jax.tree.map(lambda t: t.numpy(), grads), jgrads)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_step_then_decode(arch):
    """``prefill_step`` on 2 prompts of 16, then 6 lockstep
    ``decode_step``s fed back greedily: logits at every step, the cache."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2, attn_impl="pallas")
    x = np.random.default_rng(6).integers(1, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jlog, jcache = jtf.prefill_step(jcfg, jparams, {"tokens": jnp.asarray(x)})
    tlog, tcache = tf.prefill_step(cfg, params, {"tokens": _t(x)})
    _close(tlog, jlog)
    for _ in range(6):
        nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jlog, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        tlog, tcache = tf.decode_step(cfg, params, tcache, _t(nxt))
        _close(tlog, jlog)
    for p in range(cfg.period):
        for kv in ("k", "v"):
            _close(tcache[f"pos{p}"][kv], jcache[f"pos{p}"][kv])
    assert int(tcache["len"]) == 22


@pytest.mark.parametrize("arch", MOE)
def test_prefill_chunks_then_paged_decode(arch):
    """A 24-token prompt in chunks of 16 and 8 into the pool, then 4 paged
    decode steps of a batch of 2 (the second lane free, on the sentinel
    block: its filler token takes capacity as the reference's does)."""
    jcfg, cfg, jparams, params = _pair(arch, seed=3, attn_impl="pallas",
                                       capacity_factor=1.0)
    nb, blk = 12, 8
    shape = (cfg.repeats, nb, blk, cfg.num_kv_heads, cfg.resolved_head_dim)
    jpages = {"pos0": {kv: jnp.zeros(shape, jnp.float32) for kv in ("k", "v")}}
    tpages = tf.init_pages(cfg, nb, blk, device="cpu")
    table = np.asarray([5, 2, 9, 4], np.int32)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    jrow = {"len": jnp.zeros((1,), jnp.int32)}
    trow = {"len": torch.zeros(1, dtype=torch.int32)}
    off = 0
    for c in (16, 8):
        nbp_real = off // blk
        nbp = 1 << (nbp_real - 1).bit_length() if nbp_real else 0
        ptab = np.zeros((nbp,), np.int32)
        ptab[:nbp_real] = table[:nbp_real]
        wtab = table[nbp_real:(off + c) // blk]
        chunk = prompt[:, off:off + c]
        jlog, jrow, jpages = jtf.prefill_chunk(
            jcfg, jparams, jrow, jpages, {"tokens": jnp.asarray(chunk)}, jnp.int32(off),
            jnp.asarray(ptab), jnp.asarray(wtab))
        tlog, trow, tpages = tf.prefill_chunk(
            cfg, params, trow, tpages, {"tokens": _t(chunk)}, off, _t(ptab), _t(wtab))
        _close(tlog, jlog)
        off += c
    tables = np.zeros((2, 4), np.int32)
    tables[0] = table
    jcache = {"len": jnp.asarray([24, 3], jnp.int32)}
    tcache = {"len": torch.tensor([24, 3], dtype=torch.int32)}
    tok = int(np.argmax(np.asarray(jlog)[0, -1]))
    for _ in range(4):
        toks = np.asarray([[tok], [7]], np.int32)
        jlog, jcache, jpages = jtf.decode_step(
            jcfg, jparams, jcache, jnp.asarray(toks), pages=jpages, tables=jnp.asarray(tables))
        tlog, tcache, tpages = tf.decode_step(cfg, params, tcache, _t(toks), pages=tpages,
                                              tables=_t(tables))
        _close(tlog[:1], np.asarray(jlog)[:1])
        tok = int(np.argmax(np.asarray(jlog)[0, -1]))
        assert tok == int(tlog[0, -1].argmax())
    live = sorted(set(table.tolist()))
    for kv in ("k", "v"):
        _close(tpages["pos0"][kv][:, live], np.asarray(jpages["pos0"][kv])[:, live])


def _trace(cfg, seed=5):
    """Chunking, a prefix shared by two prompts and a repeat of a whole
    prompt (a full-prompt hit)."""
    r = np.random.default_rng(seed)
    shared = r.integers(1, cfg.vocab_size, size=20)
    first = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    second = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    prompts = [first, r.integers(1, cfg.vocab_size, size=7), second,
               r.integers(1, cfg.vocab_size, size=45), first.copy()]
    return [(p.astype(np.int32), n) for p, n in zip(prompts, (9, 5, 12, 6, 8))]


@pytest.mark.parametrize("arch", MOE)
def test_engine_matches_reference_engine(arch):
    """Identical greedy tokens and ServeStats, and every prompt's first
    logits (the engines' prompt caches hold them) within 1e-5."""
    jcfg, cfg, jparams, params = _pair(arch, seed=1)
    kw = dict(max_slots=2, max_seq=64, prefill_chunk=8, block_size=8, prompt_granule=8)
    reqs = _trace(cfg)
    jeng = JServeEngine(jcfg, jparams, attn_impl="pallas", **kw)
    jout = jeng.generate([JRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    teng = ServeEngine(cfg, params, device="cpu", **kw)
    tout = teng.generate([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    assert [o.tokens.tolist() for o in tout] == [o.tokens.tolist() for o in jout]
    js, ts = jeng.stats.as_dict(), teng.stats.as_dict()
    for key in ("prefills", "prefill_chunks", "shared_prefill_hits", "shared_blocks",
                "peak_blocks", "slot_steps", "steps", "tokens", "buckets", "resizes",
                "retired"):
        assert ts[key] == js[key], key
    assert ts["shared_prefill_hits"] == 1 and ts["shared_blocks"] > 32 // 8
    jfirst = [e["logits"] for e in jeng._prompt_cache.values()]
    tfirst = [e["logits"] for e in teng._prompt_cache.values()]
    assert len(tfirst) == len(jfirst) == 4
    for a, b in zip(tfirst, jfirst):
        _close(a, b)


def _program(pkg):
    return pkg.AdaptationProgram(
        pkg.DiveBatchPolicy(2, 8, delta=4.0, dataset_size=None, granule=2,
                            on_tick=True), 0.05, tick_every=2)


@pytest.mark.parametrize("arch", MOE)
def test_for_lm_moe_groups_matches_reference(arch):
    """``StepEngine.for_lm(moe_groups=2, attn_impl="pallas")``, sgd with
    momentum, 4 steps under a DiveBatch program ticking every 2: losses,
    the schedule and the parameters; ``ce_loss`` and ``moe_aux`` are the
    means of the loss function's metrics."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=2, moe_groups=2,
                              attn_impl="pallas")
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, moe_groups=2,
                             attn_impl="pallas")
    jstate = jinit_state(jparams, jsgd(momentum=0.9))
    tstate = init_state(params, sgd(momentum=0.9))
    stream = TokenStream(cfg.vocab_size, seed=1)
    jprog, tprog = _program(jadapt), _program(adapt)
    sched = []
    for step in range(4):
        m = jprog.batch_size
        assert tprog.batch_size == m
        sched.append(m)
        b = stream.batch(step, m, SEQ)
        jstate, jm = jeng.step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, 0.05)
        tstate, tm = teng.step(tstate, b, 0.05)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose((tm["ce_loss"] + 0.01 * tm["moe_aux"]).item(),
                                   tm["loss"].item(), rtol=1e-6)
        if step % 2 == 1:
            jsig, jstate = jadapt.read_signals(jstate, "moment", reset=True, batch_size=m)
            tsig, tstate = adapt.read_signals(tstate, "moment", reset=True, batch_size=m)
            np.testing.assert_allclose(tsig.diversity, jsig.diversity, rtol=1e-4)
            clock = dict(epoch=step // 2, step=step + 1, boundary="tick")
            assert jprog.observe(jsig, jadapt.Clock(**clock)).batch_size == \
                tprog.observe(tsig, adapt.Clock(**clock)).batch_size
    assert len(set(sched)) > 1, sched  # the program resized the batch
    assert teng.stats.buckets == jeng.stats.buckets
    _tree_close(interop.params_to_numpy(tstate.params, cfg), jstate.params,
                rtol=0, atol=2e-4)


def test_gram_tier_steps_on_dbrx_match_reference():
    """3 sgd steps of the gram tier on reduced dbrx (probes on the attention
    layers; the MoE FFNs unprobed in 2 groups, their aux in the loss):
    losses, ``sq_norm_sum`` and the parameters."""
    jcfg, cfg, jparams, params = _pair("dbrx-132b", seed=5)
    jcfg = jcfg.replace(scan_layers=False)
    jstep = jax.jit(jmake_train_step(
        jcfg, jsgd(), 1, psn_interpret=True, estimator="gram", moe_groups=2,
        probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b, 2),
        probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, SEQ)))
    tstep = make_train_step(
        cfg, sgd(), 1, estimator="gram", moe_groups=2,
        probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b, 2),
        probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
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
    _tree_close(interop.params_to_numpy(tstate.params, cfg), jstate.params,
                rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("arch", MOE)
def test_persample_sq_norms_gram_matches_reference(arch):
    """The per-sample norms over the attention layers (the MoE FFNs run
    unprobed, in 2 groups) against the reference's, its psgn kernels in
    interpret mode; the zero-probe loss carries the aux term."""
    jcfg, cfg, jparams, params = _pair(arch, seed=4)
    jcfg = jcfg.replace(scan_layers=False)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(4, SEQ))
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)}
    tb = {"tokens": _t(toks), "targets": _t(toks)}
    got = probes.persample_sq_norms_gram(cfg, params, tb, moe_groups=2)
    want = jprobes.persample_sq_norms_gram(jcfg, jparams, jb, moe_groups=2)
    assert bool((got > 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    pr = probes.probe_specs(cfg, 4, SEQ, device="cpu")
    assert sorted(pr) == sorted(jprobes.probe_specs(jcfg, 4, SEQ))
    assert not any(".gate" in n or ".down" in n for n in pr)
    loss, _ = probes.loss_with_probes(cfg, params, pr, tb, moe_groups=2)
    ref, _ = tf.loss_fn(cfg.replace(attn_impl="dense"), params, tb, moe_groups=2)
    assert loss.item() == ref.item()


@pytest.mark.parametrize("arch", MOE)
def test_coverage_matches_reference(arch):
    """The expert tensors count in the total and are not covered: the
    full-width and reduced fractions equal the reference's."""
    for reduced in (False, True):
        assert probes.coverage(get_config(arch, reduced)) == \
            jprobes.coverage(jget(arch, reduced))
    assert probes.coverage(get_config(arch)) < 0.05


# ---------------------------------------------------------------------------
# the float32 router in a bf16 model
# ---------------------------------------------------------------------------


def _routers(model) -> dict:
    return {n: p.dtype for n, p in model.named_parameters() if "router" in n}


def test_router_stays_float32_in_a_bf16_model(tmp_path):
    """``init_params``, ``params_from_jax`` and a checkpoint of a bf16
    reduced dbrx: the router stays float32, everything else bf16, and the
    checkpoint's paths, shapes and dtypes are the reference's."""
    arch = "dbrx-132b"
    cfg = get_config(arch, reduced=True).replace(param_dtype="bfloat16",
                                                 compute_dtype="bfloat16")
    jcfg = jget(arch, reduced=True).replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    model = tf.init_params(cfg, device="cpu")
    assert set(_routers(model).values()) == {torch.float32} and len(_routers(model)) == 2
    assert {p.dtype for n, p in model.named_parameters() if "router" not in n} == \
        {torch.bfloat16}
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert set(_routers(carried).values()) == {torch.float32}
    np.testing.assert_array_equal(
        carried.blocks[1].ffn.router.weight.t().numpy(),
        np.asarray(jparams["pos0"]["ffn"]["router"]["kernel"][1]))
    # a checkpoint of the port's state has the reference's paths and dtypes
    state = init_state(carried, sgd(momentum=0.9))
    save_pytree(str(tmp_path / "port"), interop.reference_state(state))
    jsave(str(tmp_path / "ref"), jinit_state(jparams, jsgd(momentum=0.9)))
    meta = {d: json.load(open(tmp_path / d / "meta.json"))["index"] for d in ("port", "ref")}
    assert meta["port"] == meta["ref"]
    assert meta["port"]["params/pos0/ffn/router/kernel"]["dtype"] == "float32"
    fresh = init_state(tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
                       sgd(momentum=0.9))
    ref = load_pytree(str(tmp_path / "port"), interop.reference_state(fresh, target=True))
    fresh = interop.load_reference_state(fresh, params=ref.params, opt_state=ref.opt_state,
                                         div_state=ref.div_state, step=int(ref.step))
    assert set(_routers(fresh.params).values()) == {torch.float32}
    assert all(torch.equal(a, b) for a, b in zip(fresh.params.parameters(),
                                                 carried.parameters()))


def test_ep_moe_impl_under_a_local_plan_matches_reference():
    """``moe_impl="ep"`` without a rank plan runs ``moe_apply``: with no
    plan (as the reference does) and under a local mesh's plan (one
    process: no expert ranks to route to) the loss is the default
    implementation's to the bit and the reference's within 1e-5; the
    explicit all-to-all over expert ranks is ``tests/test_torch_moe_ep.py``
    and ``tests/test_torch_sharded.py``."""
    jcfg, cfg, jparams, params = _pair("kimi-k2-1t-a32b", seed=0)
    toks = torch.randint(1, cfg.vocab_size, (2, 8))
    batch = {"tokens": toks, "targets": toks}
    ep = cfg.replace(moe_impl="ep")
    base = tf.loss_fn(cfg, params, batch)[0].item()
    assert tf.loss_fn(ep, params, batch)[0].item() == base
    plan = ShardingPlan(Mesh(np.array(["cpu"]), ("data",)), tp=None)
    with use_plan(plan):
        assert tf.loss_fn(ep, params, batch)[0].item() == base
    want = jtf.loss_fn(jcfg.replace(moe_impl="ep"), jparams,
                       {"tokens": jnp.asarray(toks.numpy()), "targets": jnp.asarray(toks.numpy())})
    np.testing.assert_allclose(base, float(want[0]), rtol=1e-5)
