"""The Mamba architectures of the port against the JAX reference, on the CPU.

falcon-mamba-7b (attention-free: Mamba mixers, no FFN) and jamba-v0.1-52b
(a period of 8: seven Mamba layers and an attention layer at position 4,
dense SwiGLU FFNs at even positions and MoE FFNs at odd ones), each at the
reference's own ``reduced()`` size (falcon-mamba 2 layers, jamba 8; d_model
64, d_state 16, ``ssm_chunk`` 16, jamba's 4/2 heads of hd 16 and 4
experts, float32), with the reference's random weights carried over by
``interop.params_from_jax`` and inputs made with numpy from a seed.  Where
the reference reaches a Pallas kernel (jamba's attention, ``attn_impl=
"pallas"``; its gram tier) it runs in interpret mode; the port runs on the
CPU, where its kernel wrappers take their plain versions.

Covered: ``loss_fn`` and its gradients (remat on: the layer and each chunk
checkpointed); ``prefill_step`` then lockstep ``decode_step``;
``prefill_chunk`` with C dividing ``ssm_chunk`` and not (``sc = C``), then
paged decode; jamba's MoE at capacity 1.0; ``ServeEngine`` against the
reference engine with whole-prompt and chunked prefill and a full-prompt
hit; the reference's hybrid serving tests (``tests/test_serve_paged.py``)
and its O(1) SSM state (``tests/test_serve_long.py``); ``for_lm`` on the
moment tier, the gram tier on jamba, ``coverage`` and ``loss_with_probes``;
the Mamba leaves of a bf16 model through ``params_from_jax``,
``params_to_numpy`` and a checkpoint.

Tolerance: float32 logits, losses, gradients, caches and states within
1e-5 relative and absolute (other summation orders: the doubling scan, the
16-128 wide dots); the multi-step training runs within the bounds of
``tests/test_torch_moe.py``.  Discrete outputs (tokens, batch sizes,
counts, shapes) must match exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import adapt as jadapt
from repro.ckpt import save_pytree as jsave
from repro.configs import get_config as jget
from repro.configs.base import ModelConfig as JModelConfig
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
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenStream
from repro_torch.models import probes
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import padded_prompt_len
from repro_torch.train import StepEngine, init_state, make_train_step
from repro_torch.utils import pytree as ptu

torch.set_num_threads(2)

MAMBA = ("falcon-mamba-7b", "jamba-v0.1-52b")
TOL = dict(rtol=1e-5, atol=1e-5)
SEQ = 32


def _pair(arch: str, seed: int = 0, **extra):
    jcfg = jget(arch, reduced=True).replace(**extra)
    cfg = get_config(arch, reduced=True).replace(**extra)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _t(a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _tree_close(got: dict, want: dict, **tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _state_close(tstate: dict, jstate: dict):
    """Every per-position leaf (k/v, or Mamba h/conv) and ``len``."""
    assert set(tstate) == set(jstate)
    for name, leaf in tstate.items():
        if name == "len":
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jstate["len"]))
            continue
        assert set(leaf) == set(jstate[name])
        for key, t in leaf.items():
            _close(t, jstate[name][key])


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MAMBA)
def test_loss_and_grads_match_reference(arch):
    """S 32 (two scan chunks of 16), B 4, remat on (each layer and each
    chunk step checkpointed), jamba's MoE in two groups: the loss,
    ``ce_loss``, ``moe_aux`` and every parameter's gradient (``A_log``,
    ``D`` and the conv taps included)."""
    jcfg, cfg, jparams, params = _pair(arch, seed=1, attn_impl="dense", remat=True)
    groups = 2 if cfg.num_experts else 1
    r = np.random.default_rng(3)
    x = r.integers(1, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)
    tgt = r.integers(0, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(x), "targets": jnp.asarray(tgt)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jb, moe_groups=groups), has_aux=True)(jparams)
    params.requires_grad_(True)
    loss, m = tf.loss_fn(cfg, params, {"tokens": _t(x), "targets": _t(tgt)},
                         moe_groups=groups)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(m["ce_loss"].item(), float(jm["ce_loss"]), **TOL)
    np.testing.assert_allclose(m["moe_aux"].item(), float(jm["moe_aux"]), **TOL)
    grads = interop.to_reference(params, {n: p.grad for n, p in params.named_parameters()})
    _tree_close(jax.tree.map(lambda t: t.numpy(), grads), jgrads)


def test_jamba_moe_drops_and_aux_match_reference():
    """Reduced jamba at capacity 1.0 (B 4, S 32, 2 groups): the loss and
    ``moe_aux`` equal the reference's while every MoE layer (the odd
    positions) drops assignments; the Mamba layers' FFNs run as any."""
    jcfg, cfg, jparams, params = _pair("jamba-v0.1-52b", seed=2, attn_impl="dense",
                                       capacity_factor=1.0)
    x = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(4, SEQ)).astype(np.int32)
    jb = {"tokens": jnp.asarray(x), "targets": jnp.asarray(x)}
    jloss, jm = jtf.loss_fn(jcfg, jparams, jb, moe_groups=2)
    moes = [blk.ffn for blk in params.blocks if blk.ffn is not None and hasattr(blk.ffn, "stats")]
    assert len(moes) == 4 and all(blk.mamba is not None for blk in params.blocks[1::2])
    for layer in moes:
        layer.stats = {}
    loss, m = tf.loss_fn(cfg, params, {"tokens": _t(x), "targets": _t(x)}, moe_groups=2)
    dropped = [int(layer.stats["dropped"]) for layer in moes]
    for layer in moes:
        layer.stats = None
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(m["moe_aux"].item(), float(jm["moe_aux"]), **TOL)
    assert min(dropped) > 0, dropped


@pytest.mark.parametrize("arch", MAMBA)
def test_prefill_step_then_decode(arch):
    """``prefill_step`` on 2 prompts of 32 (two scan chunks), then 6
    lockstep ``decode_step``s fed back greedily: logits at every step and
    the whole cache (Mamba ``h`` and conv tails, jamba's dense k/v)."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2, attn_impl="pallas")
    x = np.random.default_rng(6).integers(1, cfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    jlog, jcache = jtf.prefill_step(jcfg, jparams, {"tokens": jnp.asarray(x)})
    tlog, tcache = tf.prefill_step(cfg, params, {"tokens": _t(x)})
    _close(tlog, jlog)
    _state_close(tcache, jcache)
    for _ in range(6):
        nxt = np.argmax(np.asarray(jlog)[:, -1], axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(), nxt[:, 0])
        jlog, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        tlog, tcache = tf.decode_step(cfg, params, tcache, _t(nxt))
        _close(tlog, jlog)
    _state_close(tcache, jcache)
    assert int(tcache["len"]) == SEQ + 6
    assert tcache["pos0"]["h"].dtype == torch.float32


def _row(pkg, cfg, batch: int):
    """A zero per-request row (the rings and Mamba states) of ``pkg``."""
    if pkg is tf:
        row = tf.init_cache(cfg, batch, 64, skip=tf.paged_positions(cfg), device="cpu")
        row["len"] = torch.zeros(batch, dtype=torch.int32)
        return row
    row = jtf.init_cache(cfg, batch, 64, skip=jtf.paged_positions(cfg))
    row["len"] = jnp.zeros((batch,), jnp.int32)
    return row


@pytest.mark.parametrize("arch", MAMBA)
@pytest.mark.parametrize("chunks", [(16, 8), (24, 8)])
def test_prefill_chunks_then_paged_decode(arch, chunks):
    """A 24-token prompt in chunks of 16 then 8 (each dividing or equal to
    its scan chunk) and of 24 then 8 (24 does not divide ssm_chunk 16's
    split: one scan of 24), each resuming from the row's state; then 4
    paged decode steps of a batch of 2 (lane 1 free, at its own
    position): logits, the row's states and the pool."""
    jcfg, cfg, jparams, params = _pair(arch, seed=3, attn_impl="pallas")
    nb, blk = 12, 8
    jpages = jtf.init_pages(jcfg, nb, blk)
    tpages = tf.init_pages(cfg, nb, blk, device="cpu")
    assert set(tpages) == set(jpages) == ({"pos4"} if cfg.period == 8 else set())
    table = np.asarray([5, 2, 9, 4], np.int32)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(1, 32)).astype(np.int32)
    jrow, trow = _row(jtf, jcfg, 1), _row(tf, cfg, 1)
    off = 0
    for c in chunks:
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
        _state_close(trow, jrow)
        off += c
    # the batch of 2: lane 0 holds the prompt's row, lane 1 a zero state
    jcache, tcache = _row(jtf, jcfg, 2), _row(tf, cfg, 2)
    for name in tcache:
        if name == "len":
            continue
        for key in tcache[name]:
            tcache[name][key][:, :1] = trow[name][key]
            jcache[name][key] = jcache[name][key].at[:, :1].set(jrow[name][key])
    jcache["len"] = jnp.asarray([off, 3], jnp.int32)
    tcache["len"] = torch.tensor([off, 3], dtype=torch.int32)
    tables = np.zeros((2, 5), np.int32)
    tables[0, :4] = table
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
    _state_close(tcache, jcache)
    live = sorted(set(table.tolist()))
    for name in tpages:
        for kv in ("k", "v"):
            _close(tpages[name][kv][:, live], np.asarray(jpages[name][kv])[:, live])


def test_init_cache_matches_reference_and_is_o1():
    """The reference's per-slot state shapes and dtypes for both archs, and
    the reference's ``TestSSMDecodeLong``: a Mamba stack's state bytes do
    not grow with the context (16 tokens or 524288)."""
    for arch in MAMBA:
        jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
        skip = tf.paged_positions(cfg)
        assert skip == jtf.paged_positions(jcfg)
        tc = tf.init_cache(cfg, 3, 40, skip=skip, device="meta")
        jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, 3, 40, skip=skip))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tc) == \
            jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), jc)
    cfg = ModelConfig(name="t", family="ssm", num_layers=2, d_model=32, num_heads=0,
                      num_kv_heads=0, d_ff=0, vocab_size=61, pattern=("mamba",),
                      param_dtype="float32", compute_dtype="float32", xent_chunk=8,
                      ssm_chunk=8, remat=False)

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for leaf in cache.values()
                   for t in (leaf.values() if isinstance(leaf, dict) else [leaf]))

    small = tf.init_cache(cfg, 1, 16, device="meta")
    huge = tf.init_cache(cfg, 1, 1 << 19, device="meta")
    assert nbytes(small) == nbytes(huge) == 4 + 2 * (64 * 16 * 4 + 3 * 64 * 4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _trace(cfg, seed=5):
    """Chunking, a prefix shared by two prompts (not adopted: a Mamba
    state is not in the pool) and a repeat of a whole prompt (a
    full-prompt hit)."""
    r = np.random.default_rng(seed)
    shared = r.integers(1, cfg.vocab_size, size=20)
    first = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    second = np.concatenate([shared, r.integers(1, cfg.vocab_size, size=10)])
    prompts = [first, r.integers(1, cfg.vocab_size, size=7), second,
               r.integers(1, cfg.vocab_size, size=45), first.copy()]
    return [(p.astype(np.int32), n) for p, n in zip(prompts, (9, 5, 12, 6, 8))]


@pytest.mark.parametrize("arch", MAMBA)
def test_engine_matches_reference_engine(arch):
    """Whole-prompt and 8-token chunked prefill: identical greedy tokens
    and ServeStats, the full-prompt hit replaying the cached row, every
    prompt's first logits within 1e-5; both prefill modes give the same
    tokens."""
    jcfg, cfg, jparams, params = _pair(arch, seed=1)
    reqs = _trace(cfg)
    outs = []
    for chunk in (0, 8):
        kw = dict(max_slots=2, max_seq=64, prefill_chunk=chunk, block_size=8,
                  prompt_granule=8)
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
        assert ts["shared_prefill_hits"] == 1 and ts["shared_blocks"] == 4
        jfirst = [e["logits"] for e in jeng._prompt_cache.values()]
        tfirst = [e["logits"] for e in teng._prompt_cache.values()]
        assert len(tfirst) == len(jfirst) == 4
        for a, b in zip(tfirst, jfirst):
            _close(a, b)
        outs.append([o.tokens.tolist() for o in tout])
    assert outs[0] == outs[1]


HYBRID = dict(name="t", family="dense", num_layers=3, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=61, pattern=("attn", "attn_local", "mamba"),
              window=6, ssm_chunk=8, param_dtype="float32", compute_dtype="float32",
              xent_chunk=8, remat=False)
MAX_SEQ, GRANULE = 64, 8


def _hybrid():
    jcfg, cfg = JModelConfig(**HYBRID), ModelConfig(**HYBRID)
    jparams = jtf.init_params(jcfg, jax.random.key(4))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def _reqs(lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, HYBRID["vocab_size"], size=n).astype(np.int32), m)
            for n, m in zip(lens, max_new)]


def _decode_oracle(pkg, cfg, params, prompt, max_new):
    """Token-by-token ``decode_step`` from an empty cache over the padded
    prompt, then greedy (the reference test's oracle, in ``pkg``)."""
    plen = padded_prompt_len(len(prompt), GRANULE)
    padded = np.zeros(plen, np.int32)
    padded[plen - len(prompt):] = prompt
    budget = min(max_new, MAX_SEQ - len(prompt) + 1)
    if pkg is tf:
        cache = tf.init_cache(cfg, 1, MAX_SEQ, device="cpu")
        step = lambda c, t: tf.decode_step(cfg, params, c, torch.tensor([[t]]))  # noqa: E731
    else:
        cache = jtf.init_cache(cfg, 1, MAX_SEQ)
        dec = jax.jit(lambda p, c, t: jtf.decode_step(cfg, p, c, t))
        step = lambda c, t: dec(params, c, jnp.asarray([[t]], jnp.int32))  # noqa: E731
    for t in padded:
        logits, cache = step(cache, int(t))
    out = [int(np.argmax(np.asarray(logits[0, -1])))]
    while len(out) < budget:
        logits, cache = step(cache, out[-1])
        out.append(int(np.argmax(np.asarray(logits[0, -1]))))
    return out


def test_hybrid_shared_prompt_replays_ring_and_ssm_state():
    """The reference's test: a ring and a Mamba state live in the cached
    row, and a full-prompt hit replays them bit for bit (one chunk run,
    the repeat's tokens equal); both equal the decode oracle's, in the
    port and in the reference."""
    jcfg, cfg, jparams, params = _hybrid()
    (prompt, n), = _reqs([20], [6], seed=11)
    eng = ServeEngine(cfg, params, device="cpu", max_slots=2, max_seq=MAX_SEQ,
                      prompt_granule=GRANULE)
    base = eng.generate([Request(prompt=prompt, max_new_tokens=n)])[0].tokens.tolist()
    assert base == _decode_oracle(tf, cfg, params, prompt, n) == \
        _decode_oracle(jtf, jcfg, jparams, prompt, n)
    (row,) = [e["row"] for e in eng._prompt_cache.values()]
    snapshot = {k: {kk: t.clone() for kk, t in v.items()} for k, v in row.items()
                if isinstance(v, dict)}
    rep = eng.generate([Request(prompt=prompt.copy(), max_new_tokens=6)])[0]
    assert rep.tokens.tolist() == base
    assert eng.stats.shared_prefill_hits == 1
    assert eng.stats.prefill_chunks == 1
    assert all(torch.equal(row[k][kk], t) for k, v in snapshot.items() for kk, t in v.items())


def test_hybrid_chunked_prefill_matches_whole_prompt():
    """The reference's test: chunked prefill threads the ring rotations and
    the Mamba (h, conv) state across chunk boundaries, so 8-token chunks,
    the whole prompt and the decode oracle give the same tokens."""
    jcfg, cfg, jparams, params = _hybrid()
    reqs = _reqs([20, 13], [6, 8], seed=12)
    expected = [_decode_oracle(jtf, jcfg, jparams, p, n) for p, n in reqs]
    for chunk in (0, 8):
        eng = ServeEngine(cfg, params, device="cpu", max_slots=2, max_seq=MAX_SEQ,
                          prompt_granule=GRANULE, prefill_chunk=chunk)
        got = eng.generate([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
        assert [r.tokens.tolist() for r in got] == expected, f"chunk={chunk}"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _program(pkg):
    return pkg.AdaptationProgram(
        pkg.DiveBatchPolicy(2, 8, delta=4.0, dataset_size=None, granule=2,
                            on_tick=True), 0.05, tick_every=2)


@pytest.mark.parametrize("arch", MAMBA)
def test_for_lm_matches_reference(arch):
    """``StepEngine.for_lm(attn_impl="pallas")`` on the moment tier (jamba's
    MoE in 2 groups), sgd with momentum, 4 steps under a DiveBatch program
    ticking every 2: losses, the schedule, the num_micro buckets and the
    parameters."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    groups = 2 if cfg.num_experts else 1
    jeng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=2, moe_groups=groups,
                              attn_impl="pallas")
    teng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, moe_groups=groups,
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


def test_gram_tier_steps_on_jamba_match_reference():
    """3 sgd steps of the gram tier on reduced jamba (probes on the
    attention layer and the dense FFNs; the Mamba mixers and the MoE FFNs
    unprobed, the MoE in 2 groups): losses, ``sq_norm_sum`` and the
    parameters."""
    jcfg, cfg, jparams, params = _pair("jamba-v0.1-52b", seed=5)
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


@pytest.mark.parametrize("arch", MAMBA)
def test_probes_and_coverage_match_reference(arch):
    """``coverage`` at full width and reduced (falcon-mamba's is 0: no
    attention, no FFN), the probe names, ``loss_with_probes`` with zero
    probes (the Mamba mixers unprobed) against the reference's and against
    the port's ``loss_fn`` on the dense lane to the bit; on jamba the
    per-sample norms against the reference's (its psgn kernels in
    interpret mode)."""
    for reduced in (False, True):
        assert probes.coverage(get_config(arch, reduced)) == \
            jprobes.coverage(jget(arch, reduced))
    if arch == "falcon-mamba-7b":
        assert probes.coverage(get_config(arch)) == 0.0
    jcfg, cfg, jparams, params = _pair(arch, seed=4)
    jcfg = jcfg.replace(scan_layers=False)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(4, SEQ))
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)}
    tb = {"tokens": _t(toks), "targets": _t(toks)}
    pr = probes.probe_specs(cfg, 4, SEQ, device="cpu")
    jpr = jprobes.probe_specs(jcfg, 4, SEQ)
    assert {n: tuple(t.shape) for n, t in pr.items()} == {n: t.shape for n, t in jpr.items()}
    assert len(pr) == (0 if arch == "falcon-mamba-7b" else 4 + 4 * 3)
    loss, acts = probes.loss_with_probes(cfg, params, pr, tb, moe_groups=2)
    jloss, jacts = jprobes.loss_with_probes(jcfg, jparams, jpr, jb, 2)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert sorted(acts) == sorted(jacts)
    for name in acts:
        _close(acts[name], jacts[name])
    ref, _ = tf.loss_fn(cfg.replace(attn_impl="dense"), params, tb, moe_groups=2)
    assert loss.item() == ref.item()
    if pr:
        got = probes.persample_sq_norms_gram(cfg, params, tb, moe_groups=2)
        want = jprobes.persample_sq_norms_gram(jcfg, jparams, jb, moe_groups=2)
        assert bool((got > 0).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _float32_leaves(model) -> set:
    return {n.split(".", 2)[-1] for n, p in model.named_parameters() if p.dtype == torch.float32}


@pytest.mark.parametrize("arch", MAMBA)
def test_mamba_leaves_keep_float32_in_a_bf16_model(arch, tmp_path):
    """A bf16 reduced model: ``A_log`` and ``D`` stay float32 through
    ``init_params``, ``params_from_jax`` and ``params_to_numpy`` (bit for
    bit, every Mamba leaf), and a checkpoint holds the reference's paths
    and dtypes and restores them to the bit."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = get_config(arch, reduced=True).replace(**bf16)
    jcfg = jget(arch, reduced=True).replace(**bf16)
    want = {"mamba.A_log", "mamba.D"} | ({"ffn.router.weight"} if cfg.num_experts else set())
    assert _float32_leaves(tf.init_params(cfg, device="cpu")) == want
    jparams = jtf.init_params(jcfg, jax.random.key(0))
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert _float32_leaves(carried) == want
    back = interop.params_to_numpy(carried, cfg)
    jmamba = jparams["pos0"]["mamba"]
    for name, leaf in back["pos0"]["mamba"].items():
        ref = jmamba[name]
        for a, b in zip(jax.tree.leaves(leaf), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b).astype(np.float32))
    assert back["pos0"]["mamba"]["A_log"].dtype == np.float32
    state = init_state(carried, sgd(momentum=0.9))
    save_pytree(str(tmp_path / "port"), interop.reference_state(state))
    jsave(str(tmp_path / "ref"), jinit_state(jparams, jsgd(momentum=0.9)))
    meta = {d: json.load(open(tmp_path / d / "meta.json"))["index"] for d in ("port", "ref")}
    assert meta["port"] == meta["ref"]
    assert meta["port"]["params/pos0/mamba/A_log"]["dtype"] == "float32"
    assert meta["port"]["params/pos0/mamba/conv_kernel"]["dtype"] == "bfloat16"
    fresh = init_state(tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
                       sgd(momentum=0.9))
    ref = load_pytree(str(tmp_path / "port"), interop.reference_state(fresh, target=True))
    fresh = interop.load_reference_state(fresh, params=ref.params, opt_state=ref.opt_state,
                                         div_state=ref.div_state, step=int(ref.step))
    assert _float32_leaves(fresh.params) == want
    assert all(torch.equal(a, b) for a, b in zip(fresh.params.parameters(),
                                                 carried.parameters()))
    assert ptu.tree_count(fresh.params) == sum(x.size for x in jax.tree.leaves(jparams))
