"""The dense architectures of the port against the JAX reference, on the CPU.

qwen2-7b (QKV bias, n_rep 7 at full width), llama3-405b, gemma2-27b
(sliding-window 'attn_local' layers alternating with global 'attn' ones, an
attention and a final logit softcap, GELU) and internvl2-1b (an embedding
frontend in front of a dense decoder), each at the reference's own
``reduced()`` size (2 layers, d_model 64, 4/2 heads of hd 16, float32;
gemma2's window is 8), with the reference's random weights carried over by
``interop.params_from_jax`` and inputs made with numpy from a seed.  Where
the reference reaches a Pallas kernel (``attn_impl="pallas"``) it runs in
interpret mode, as its own tests run it; the port runs on the CPU, where
its kernel wrappers take their plain versions.

Covered: the training loss and its gradients on the plain ``dense`` lane
and the streaming ``flash`` lane (gemma2 at S 32 > window 8); the flash
lane's forward, lse and gradients alone; gemma2's rings across a wrap in
``prefill_chunk`` and ``decode_step`` (logits, rings and pool); the engine
against the reference engine (tokens and sharing counts); the causal
``prefill_step`` then lockstep decode on the dense cache (embeddings for
internvl2); ``init_cache`` against ``cache_specs``; the gram tier and
``for_lm`` on gemma2.  The MoE archs have their own file,
``tests/test_torch_moe.py``, and so have the Mamba archs,
``tests/test_torch_mamba_archs.py`` (their config copies are here).

Tolerance: float32 logits, losses, gradients, caches and pools within
1e-5 relative and 1e-5 absolute (other summation orders over 16-128 wide
dots); the multi-step training runs within the bounds of
``tests/test_torch_train.py``.  Discrete outputs (tokens, batch sizes,
counts, shapes) must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adapt as jadapt
from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import probes as jprobes
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import StepEngine as JStepEngine
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import adapt, interop
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import TokenStream
from repro_torch.models import attention as attn_lib
from repro_torch.models import probes
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import StepEngine, init_state, make_train_step

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ("qwen2-7b", "llama3-405b", "gemma2-27b", "internvl2-1b")
# the Mamba archs' configs (their paths: tests/test_torch_mamba_archs.py)
MAMBA = ("falcon-mamba-7b", "jamba-v0.1-52b")
# the flash lane tiled into several query and key blocks at the reduced size
FLASH = dict(attn_impl="flash", flash_q_block=8, flash_kv_block=8)


def _pair(arch: str, seed: int = 0, **extra):
    jcfg = jget(arch, reduced=True).replace(**extra)
    cfg = get_config(arch, reduced=True).replace(**extra)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _inputs(cfg, r, shape) -> np.ndarray:
    """Tokens (shape) int32, or embeddings (shape + (d_model,)) float32."""
    if cfg.input_mode == "tokens":
        return r.integers(1, cfg.vocab_size, size=shape).astype(np.int32)
    return r.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def _key(cfg) -> str:
    return "tokens" if cfg.input_mode == "tokens" else "embeddings"


def _t(a) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _tree_close(got: dict, want: dict, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _cache_close(tcache: dict, jcache: dict):
    """Every per-position leaf of a port cache against the reference's."""
    assert set(tcache) == set(jcache)
    for name, leaf in tcache.items():
        if name == "len":
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jcache["len"]))
            continue
        for kv in ("k", "v"):
            _close(leaf[kv], jcache[name][kv])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + MAMBA)
def test_config_is_a_copy(arch):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(arch, reduced)) == \
            dataclasses.asdict(jget(arch, reduced))
    assert arch in ARCH_NAMES


def test_full_width_shapes():
    """The forms the dense group puts on the card's paths."""
    heads = {a: (get_config(a).num_heads // get_config(a).num_kv_heads,
                 get_config(a).resolved_head_dim) for a in DENSE}
    assert heads == {"qwen2-7b": (7, 128), "llama3-405b": (16, 128),
                     "gemma2-27b": (2, 128), "internvl2-1b": (7, 64)}
    g = get_config("gemma2-27b")
    assert (g.pattern, g.window, g.attn_softcap, g.final_softcap) == \
        (("attn_local", "attn"), 4096, 50.0, 30.0)


# ---------------------------------------------------------------------------
# training: the loss and its gradients on both plain lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane", ["dense", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch, lane):
    """S 32: gemma2's window (8) cuts its local layers; the flash lane runs
    4 query blocks over 4 key blocks."""
    extra = FLASH if lane == "flash" else dict(attn_impl="dense")
    jcfg, cfg, jparams, params = _pair(arch, seed=1, **extra)
    r = np.random.default_rng(3)
    x = _inputs(cfg, r, (2, 32))
    tgt = r.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    jb = {_key(cfg): jnp.asarray(x), "targets": jnp.asarray(tgt)}
    jloss, jgrads = jax.value_and_grad(lambda p: jtf.loss_fn(jcfg, p, jb)[0])(jparams)
    params.requires_grad_(True)
    loss, _ = tf.loss_fn(cfg, params, {_key(cfg): _t(x), "targets": _t(tgt)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = interop.to_reference(params, {n: p.grad for n, p in params.named_parameters()})
    _tree_close(jax.tree.map(lambda t: t.numpy(), grads), jgrads)


@pytest.mark.parametrize("case", [
    dict(b=2, s=32, h=4, kv=2, hd=16, causal=True, window=8, softcap=50.0, qb=8, kb=16),
    dict(b=1, s=48, h=6, kv=2, hd=8, causal=True, window=None, softcap=20.0, qb=16, kb=8),
    dict(b=1, s=64, h=4, kv=4, hd=16, causal=False, window=5, softcap=None, qb=16, kb=16),
], ids=["window-softcap", "softcap-ragged-blocks", "noncausal-window"])
def test_flash_lane_matches_reference(case):
    """``models/attention.py::flash_attention`` against the reference's XLA
    flash lane: the output, the lse and the three gradients."""
    r = np.random.default_rng(case["s"])
    b, s, h, kv, hd = (case[k] for k in ("b", "s", "h", "kv", "hd"))
    q, k, v, do = (r.standard_normal(sh).astype(np.float32) for sh in
                   ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    args = (case["causal"], case["window"], case["softcap"], case["qb"], case["kb"])
    jout, jlse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *args)
    jgrads = jax.grad(lambda *x: jnp.sum(jattn.flash_attention(*x, *args) * do),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = attn_lib._FlashAttention.apply(tq, tk, tv, *args)
    (out * torch.from_numpy(do)).sum().backward()
    _close(out, jout)
    _close(lse, jlse)
    for t, g in zip((tq, tk, tv), jgrads):
        _close(t.grad, g)
    with pytest.raises(ValueError, match="must tile"):
        attn_lib.flash_attention(tq[:, :s - 1], tk, tv, *args)


# ---------------------------------------------------------------------------
# serving: gemma2's rings across a wrap, the engine
# ---------------------------------------------------------------------------

NB, BLK = 16, 8


def test_gemma2_ring_prefill_chunks_then_decode_across_a_wrap():
    """A 40-token prompt in chunks of 16, 16 and 8 (the ring of 8 takes
    each chunk's tail), then 12 decode steps (the ring wraps at every 8th):
    logits at every call, the rings and the pool's written blocks."""
    jcfg, cfg, jparams, params = _pair("gemma2-27b", seed=4, attn_impl="pallas")
    r = np.random.default_rng(4)
    shape = (cfg.repeats, NB, BLK, cfg.num_kv_heads, cfg.resolved_head_dim)
    noise = {kv: r.standard_normal(shape).astype(np.float32) for kv in ("k", "v")}
    jpages = {"pos1": {kv: jnp.asarray(a) for kv, a in noise.items()}}
    tpages = tf.init_pages(cfg, NB, BLK, device="cpu")
    for kv, a in noise.items():
        tpages["pos1"][kv].copy_(torch.from_numpy(a))
    table = np.asarray([9, 2, 14, 5, 11, 7, 3], np.int32)
    prompt = _inputs(cfg, r, (1, 40))
    jrow = jtf.init_cache(jcfg, 1, 64, skip=jtf.paged_positions(jcfg))
    trow = tf.init_cache(cfg, 1, 64, skip=tf.paged_positions(cfg), device="cpu")
    assert trow["pos0"]["k"].shape == (1, 1, 8, 2, 16) and "pos1" not in trow
    jrow["len"] = jnp.zeros((1,), jnp.int32)
    trow["len"] = torch.zeros(1, dtype=torch.int32)
    off = 0
    for c in (16, 16, 8):
        nbp_real = off // BLK
        nbp = 1 << (nbp_real - 1).bit_length() if nbp_real else 0
        ptab = np.zeros((nbp,), np.int32)
        ptab[:nbp_real] = table[:nbp_real]
        wtab = table[nbp_real:(off + c) // BLK]
        chunk = prompt[:, off:off + c]
        jlog, jrow, jpages = jtf.prefill_chunk(
            jcfg, jparams, jrow, jpages, {"tokens": jnp.asarray(chunk)}, jnp.int32(off),
            jnp.asarray(ptab), jnp.asarray(wtab))
        tlog, trow, tpages = tf.prefill_chunk(
            cfg, params, trow, tpages, {"tokens": _t(chunk)}, off, _t(ptab), _t(wtab))
        _close(tlog, jlog)
        _cache_close(trow, jrow)
        off += c
    tables = np.zeros((1, 8), np.int32)
    tables[0, :7] = table
    jcache, tcache = jrow, trow
    for _ in range(12):
        tok = int(np.argmax(np.asarray(jlog)[0, -1]))
        assert tok == int(tlog[0, -1].argmax())
        jlog, jcache, jpages = jtf.decode_step(
            jcfg, jparams, jcache, jnp.asarray([[tok]], jnp.int32), pages=jpages,
            tables=jnp.asarray(tables))
        tlog, tcache, tpages = tf.decode_step(
            cfg, params, tcache, torch.tensor([[tok]]), pages=tpages,
            tables=_t(tables))
        _close(tlog, jlog)
    _cache_close(tcache, jcache)
    assert int(tcache["len"][0]) == 52
    live = sorted(set(table.tolist()))  # the sentinel and spare blocks hold noise
    for kv in ("k", "v"):
        _close(tpages["pos1"][kv][:, live], np.asarray(jpages["pos1"][kv])[:, live])


def _trace(cfg, seed=5):
    """Chunking, a prefix shared by two prompts (a partial match) and a
    repeat of a whole prompt (a full-prompt hit); gemma2's prompts pad past
    its window, so its rings wrap in every chunked prefill."""
    r = np.random.default_rng(seed)
    shared = r.integers(1, cfg.vocab_size, size=20)
    first = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    second = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    prompts = [first, r.integers(1, cfg.vocab_size, size=7), second,
               r.integers(1, cfg.vocab_size, size=45), first.copy()]
    return [(p.astype(np.int32), n) for p, n in zip(prompts, (9, 5, 12, 6, 8))]


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2-7b"])
def test_engine_matches_reference_engine(arch):
    """Identical greedy tokens and ServeStats.  gemma2 has rings, so it
    adopts prefix blocks only on the full-prompt hit (the reference's
    ``_row_trivial`` gate); qwen2 adopts the shared prefix too."""
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
    assert ts["shared_prefill_hits"] == 1
    full_hit_blocks = 32 // 8  # the repeated prompt's padded blocks
    if arch == "gemma2-27b":
        assert ts["shared_blocks"] == full_hit_blocks
    else:
        assert ts["shared_blocks"] > full_hit_blocks


def test_engine_refuses_an_embedding_input_config():
    _, cfg, _, params = _pair("internvl2-1b")
    with pytest.raises(ValueError, match="prefill_step and decode_step"):
        ServeEngine(cfg, params, device="cpu")


# ---------------------------------------------------------------------------
# the causal prefill_step and the dense cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lane", ["pallas", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_step_then_dense_decode(arch, lane):
    """``prefill_step`` on 2 prompts of 16 (gemma2's ring keeps the last 8
    keys), then 6 lockstep ``decode_step``s on its cache (a scalar ``len``;
    tokens fed back greedily, internvl2 fed embeddings): logits at every
    step, and the cache at the end."""
    extra = FLASH if lane == "flash" else dict(attn_impl="pallas")
    jcfg, cfg, jparams, params = _pair(arch, seed=2, **extra)
    r = np.random.default_rng(6)
    x = _inputs(cfg, r, (2, 16))
    jlog, jcache = jtf.prefill_step(jcfg, jparams, {_key(cfg): jnp.asarray(x)})
    tlog, tcache = tf.prefill_step(cfg, params, {_key(cfg): _t(x)})
    assert tlog.shape == (2, 1, cfg.vocab_size) and tcache["len"].dim() == 0
    _close(tlog, jlog)
    _cache_close(tcache, jcache)
    for _ in range(6):
        if cfg.input_mode == "tokens":
            nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
            np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(), nxt[:, 0])
        else:
            nxt = _inputs(cfg, r, (2, 1))
        jlog, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        tlog, tcache = tf.decode_step(cfg, params, tcache, _t(nxt))
        _close(tlog, jlog)
    _cache_close(tcache, jcache)
    assert int(tcache["len"]) == 22


@pytest.mark.parametrize("arch", DENSE)
def test_init_cache_matches_cache_specs(arch):
    jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    for skip in ((), jtf.paged_positions(jcfg)):
        assert tf.paged_positions(cfg) == jtf.paged_positions(jcfg)
        want = jax.eval_shape(lambda: jtf.init_cache(jcfg, 3, 20, skip=skip))
        got = tf.init_cache(cfg, 3, 20, skip=skip, device="cpu")
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype)
    # full width: the shapes the reference's decode cell holds
    specs = jtf.cache_specs(jget(arch), 2, 8192)
    full = get_config(arch)
    for name, leaf in specs.items():
        if name != "len":
            p = int(name[3:])
            assert leaf["k"].shape == (full.repeats, 2, tf._cache_len_for(full, p, 8192),
                                       full.num_kv_heads, full.resolved_head_dim)


# ---------------------------------------------------------------------------
# training on gemma2: the gram tier and for_lm
# ---------------------------------------------------------------------------

SEQ = 32


def test_gram_tier_steps_on_gemma2_match_reference():
    """3 sgd steps of the gram tier on reduced gemma2 (S 32 past the window
    of 8, both softcaps): losses, ``sq_norm_sum`` and the parameters."""
    jcfg, cfg, jparams, params = _pair("gemma2-27b", seed=5)
    jcfg = jcfg.replace(scan_layers=False)
    jstep = jax.jit(jmake_train_step(
        jcfg, jsgd(), 1, psn_interpret=True, estimator="gram",
        probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b),
        probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, SEQ)))
    tstep = make_train_step(
        cfg, sgd(), 1, estimator="gram",
        probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
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


def test_for_lm_on_gemma2_matches_reference():
    """``StepEngine.for_lm(attn_impl="pallas")`` with remat, sgd with
    momentum: 3 steps at one microbatch then 3 at two, the signals read at
    each half and fed to a DiveBatch program: losses, decisions and
    parameters."""
    jcfg, cfg, jparams, params = _pair("gemma2-27b", seed=2, remat=True)
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=2, attn_impl="pallas")
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, attn_impl="pallas")
    jstate = jinit_state(jparams, jsgd(momentum=0.9))
    tstate = init_state(params, sgd(momentum=0.9))
    stream = TokenStream(cfg.vocab_size, seed=1)

    def program(pkg):
        return pkg.AdaptationProgram(
            pkg.DiveBatchPolicy(2, 8, delta=0.5, dataset_size=None, granule=2,
                                on_tick=True), 0.05, tick_every=3)

    jprog, tprog = program(jadapt), program(adapt)
    for step in range(6):
        m = 2 if step < 3 else 4
        b = stream.batch(step, m, SEQ)
        jstate, jm = jeng.step(jstate, {k: jnp.asarray(v) for k, v in b.items()}, 0.05)
        tstate, tm = teng.step(tstate, b, 0.05)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        if step in (2, 5):
            jsig, jstate = jadapt.read_signals(jstate, "moment", reset=True, batch_size=m)
            tsig, tstate = adapt.read_signals(tstate, "moment", reset=True, batch_size=m)
            np.testing.assert_allclose(tsig.diversity, jsig.diversity, rtol=1e-4)
            clock = dict(epoch=step // 3, step=step + 1, boundary="tick")
            assert jprog.observe(jsig, jadapt.Clock(**clock)).batch_size == \
                tprog.observe(tsig, adapt.Clock(**clock)).batch_size
    _tree_close(interop.params_to_numpy(tstate.params, cfg), jstate.params,
                rtol=0, atol=2e-4)
