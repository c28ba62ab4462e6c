"""The port's serving transformer against ``repro.models.transformer``.

Reduced Yi-6B (``get_config("yi-6b", reduced=True)``: 2 layers, float32)
with the reference's own random weights carried over by
``interop.params_from_jax``.  The reference runs its Pallas lane
(``attn_impl="pallas"``, interpret mode on the CPU); the port runs on the
CPU, where its kernels take their plain versions.  Pools are filled with the
same numpy noise in both packages, so garbage and sentinel blocks are
compared too.  Tolerance: logits and pool contents within 1e-4 absolute and
relative (float32, different summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tf

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jget("yi-6b", reduced=True).replace(attn_impl="pallas")
CFG = get_config("yi-6b", reduced=True)
JPARAMS = jtf.init_params(JCFG, jax.random.key(0))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG)
NB, BLK = 24, 8


def _pools(seed):
    """The same random pool contents for both packages."""
    r = np.random.default_rng(seed)
    shape = (CFG.repeats, NB, BLK, CFG.num_kv_heads, CFG.resolved_head_dim)
    k = r.standard_normal(shape).astype(np.float32)
    v = r.standard_normal(shape).astype(np.float32)
    jpages = {"pos0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tpages = tf.init_pages(CFG, NB, BLK, device="cpu")
    tpages["pos0"]["k"].copy_(torch.from_numpy(k))
    tpages["pos0"]["v"].copy_(torch.from_numpy(v))
    return jpages, tpages


def _same_pages(jpages, tpages):
    for name in ("k", "v"):
        np.testing.assert_allclose(tpages["pos0"][name].numpy(),
                                   np.asarray(jpages["pos0"][name]), **TOL)


def test_config_is_a_copy():
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "rope_theta", "pattern", "compute_dtype"):
        assert getattr(CFG, field) == getattr(JCFG, field)
    assert dataclasses.asdict(get_config("yi-6b")) == dataclasses.asdict(jget("yi-6b"))


def test_params_from_jax_carries_every_weight():
    """Every port weight equals its reference leaf: stacked layers unstacked,
    dense kernels transposed into (out, in)."""
    n_jax = sum(x.size for x in jax.tree.leaves(JPARAMS))
    assert sum(p.numel() for p in PARAMS.parameters()) == n_jax
    np.testing.assert_array_equal(PARAMS.lm_head.weight.numpy(),
                                  np.asarray(JPARAMS["lm_head"]["kernel"]).T)
    for r, blk in enumerate(PARAMS.blocks):
        src = JPARAMS["pos0"]
        np.testing.assert_array_equal(blk.attn.q.weight.numpy(),
                                      np.asarray(src["attn"]["q"]["kernel"][r]).T)
        np.testing.assert_array_equal(blk.ffn.w_out.weight.numpy(),
                                      np.asarray(src["ffn"]["w_out"]["kernel"][r]).T)
        np.testing.assert_array_equal(blk.norm.scale.numpy(),
                                      np.asarray(src["norm"]["scale"][r]))


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_step_matches_reference(seed):
    """Per-slot positions, a real table per live slot, an all-sentinel row
    for a free lane: logits and the written pool agree."""
    r = np.random.default_rng(seed)
    b, n_max = 4, 6
    jpages, tpages = _pools(seed)
    ids = list(range(1, NB))
    r.shuffle(ids)
    lens = np.asarray([3, 17, 40, 0], np.int32)  # slot 3 is a free lane
    tables = np.zeros((b, n_max), np.int32)
    for row, n in enumerate(lens[:3]):
        n_live = n // BLK + 1
        tables[row, :n_live] = ids[:n_live]
        ids = ids[n_live:]
    toks = r.integers(1, CFG.vocab_size, size=(b, 1)).astype(np.int32)

    jcache = jtf.init_cache(JCFG, b, 64, skip=jtf.paged_positions(JCFG))
    jcache["len"] = jnp.asarray(lens)
    jlogits, jcache, jpages = jtf.decode_step(
        JCFG, JPARAMS, jcache, jnp.asarray(toks), pages=jpages,
        tables=jnp.asarray(tables))
    tcache = tf.init_cache(CFG, b, 64, skip=tf.paged_positions(CFG), device="cpu")
    tcache["len"] = torch.from_numpy(lens)
    tlogits, tcache, tpages = tf.decode_step(
        CFG, PARAMS, tcache, torch.from_numpy(toks).long(), pages=tpages,
        tables=torch.from_numpy(tables))
    assert tlogits.shape == (b, 1, CFG.vocab_size) and tlogits.dtype == torch.float32
    # the free lane's output is garbage in both packages (it reads the
    # sentinel block); live lanes must agree
    np.testing.assert_allclose(tlogits[:3].numpy(), np.asarray(jlogits)[:3], **TOL)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    # every pool block except the sentinel (which the free lane scribbles on)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpages["pos0"][name][:, 1:].numpy(),
                                   np.asarray(jpages["pos0"][name])[:, 1:], **TOL)


@pytest.mark.parametrize("offset,nbp_real", [(0, 0), (16, 2), (24, 3)])
def test_prefill_chunk_matches_reference(offset, nbp_real):
    """A chunk at ``offset`` over a prior table padded to a pow2 length with
    sentinel entries: logits and the pool after the chunk's write agree."""
    r = np.random.default_rng(offset)
    jpages, tpages = _pools(100 + offset)
    c = 16
    nbp = 1 << (nbp_real - 1).bit_length() if nbp_real else 0
    prior_tab = np.zeros((nbp,), np.int32)
    prior_tab[:nbp_real] = np.arange(5, 5 + nbp_real)
    write_tab = np.asarray([11, 3], np.int32)
    toks = r.integers(1, CFG.vocab_size, size=(1, c)).astype(np.int32)

    jrow = jtf.init_cache(JCFG, 1, 64, skip=jtf.paged_positions(JCFG))
    jrow["len"] = jnp.full((1,), offset, jnp.int32)
    jlogits, jrow, jpages = jtf.prefill_chunk(
        JCFG, JPARAMS, jrow, jpages, {"tokens": jnp.asarray(toks)},
        jnp.int32(offset), jnp.asarray(prior_tab), jnp.asarray(write_tab))
    trow = {"len": torch.full((1,), offset, dtype=torch.int32)}
    tlogits, trow, tpages = tf.prefill_chunk(
        CFG, PARAMS, trow, tpages, {"tokens": torch.from_numpy(toks).long()},
        offset, torch.from_numpy(prior_tab), torch.from_numpy(write_tab))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert int(trow["len"][0]) == int(jrow["len"][0]) == offset + c
    _same_pages(jpages, tpages)


def test_prefill_then_decode_trajectory():
    """Two chunks then four decode steps of one request, tokens fed back
    greedily from each package's own logits: identical tokens, logits within
    tolerance at every step."""
    r = np.random.default_rng(9)
    jpages, tpages = _pools(9)
    prompt = r.integers(1, CFG.vocab_size, size=(1, 16)).astype(np.int32)
    table = np.asarray([7, 2, 19, 4], np.int32)
    jrow = {"len": jnp.zeros((1,), jnp.int32)}
    trow = {"len": torch.zeros(1, dtype=torch.int32)}
    for i in range(2):
        chunk = prompt[:, 8 * i:8 * i + 8]
        ptab = table[:i]
        wtab = table[i:i + 1]
        jlog, jrow, jpages = jtf.prefill_chunk(
            JCFG, JPARAMS, jrow, jpages, {"tokens": jnp.asarray(chunk)},
            jnp.int32(8 * i), jnp.asarray(ptab), jnp.asarray(wtab))
        tlog, trow, tpages = tf.prefill_chunk(
            CFG, PARAMS, trow, tpages, {"tokens": torch.from_numpy(chunk).long()},
            8 * i, torch.from_numpy(ptab), torch.from_numpy(wtab))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tables = np.zeros((1, 4), np.int32)
    tables[0] = table
    jcache = {"len": jnp.asarray([16], jnp.int32)}
    tcache = {"len": torch.tensor([16], dtype=torch.int32)}
    for _ in range(4):
        tok = int(np.argmax(np.asarray(jlog)[0, -1]))
        assert tok == int(tlog[0, -1].argmax())
        jlog, jcache, jpages = jtf.decode_step(
            JCFG, JPARAMS, jcache, jnp.asarray([[tok]], jnp.int32),
            pages=jpages, tables=jnp.asarray(tables))
        tlog, tcache, tpages = tf.decode_step(
            CFG, PARAMS, tcache, torch.tensor([[tok]]), pages=tpages,
            tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _same_pages(jpages, tpages)


def test_init_params_distributions_and_seed():
    cfg = CFG.replace(d_model=128, d_ff=256, vocab_size=512)
    a = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert pa.dtype == torch.float32 and not pa.requires_grad
    w = a.blocks[0].ffn.w_out.weight  # N(0, 1/d_ff)
    assert abs(w.std().item() * 256 ** 0.5 - 1) < 0.05
    assert abs(a.embed.weight.std().item() / 0.02 - 1) < 0.05
    assert torch.equal(a.final_norm.scale, torch.ones(128))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tf.init_params(CFG)


@pytest.mark.parametrize("pattern,kind", [(("attn", "attn_local"), "attn_local"),
                                          (("attn", "mamba"), "mamba")])
def test_unported_mixers_raise(pattern, kind):
    cfg = CFG.replace(pattern=pattern, window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue C"):
        tf.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue C"):
        tf.init_cache(cfg, 1, 16, skip=tf.paged_positions(cfg), device="cpu")
