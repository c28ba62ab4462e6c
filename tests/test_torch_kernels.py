"""The port's kernel wrappers against the JAX reference, on the CPU.

On the CPU the wrappers in ``repro_torch.kernels.attention`` run their plain
versions (``repro_torch.kernels.ref``); here they are held against the
reference Pallas kernels in interpret mode and against
``repro.kernels.ref``, over the cases of ``tests/test_kernels.py``
(``test_chunk_kernel_property``, ``test_paged_decode_kernel_property``,
``test_paged_decode_matches_xla_gather_on_real_pool``).  Inputs are made
with numpy from a seed and handed to both packages.  Tolerance: 2e-5
absolute and relative in float32 (the two sum in different orders).  The
plain attention lanes of ``repro_torch.models.attention`` are held against
``repro.models.attention`` the same way.

The per-sample gradient-norm wrappers (``repro_torch.kernels.psgn``) and
their dispatch (``repro_torch.kernels.ops``) are held against the
reference's ``psgn_direct`` / ``psgn_gram`` / ``psgn_fused`` (interpret mode)
and ``ref.psgn_ref`` over the shapes of ``tests/test_kernels.py``: 1e-5
relative, float32 and bf16 inputs alike (bf16 values are exact in float32,
so only the summation order differs).  Method choice and the tree's
grouping must match exactly.

The int8 quantisation (``repro_torch.kernels.quant``) is held against the
reference's ``ref.quantize_int8_ref`` (run op by op) and its
``quantize_int8`` (interpret mode, ``block_rows=32``).  Codes and scales
must be EQUAL to the plain reference, which divides by 127 as the source
says.  Against the interpret-mode kernel the scales are held to one float32
ulp, because XLA compiles ``absmax / 127.0`` inside a jit as ``absmax *
float32(1/127)`` (the compiled HLO multiplies by 0.00787401572), one ulp
off the division in a few percent of rows; its codes must be EQUAL to the
port's arithmetic run with the kernel's own scales (so the scale is the
only difference), and equal to the port's wherever the scales agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import attention as jk
from repro.kernels import ops as jops
from repro.kernels import psgn as jpsgn
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.serve.blocks import BlockPool as JBlockPool
from repro_torch import kernels as tkernels
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import psgn as tpsgn
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _qkv(r, b, sq, sk, h, kv, hd):
    return (r.standard_normal((b, sq, h, hd)).astype(np.float32),
            r.standard_normal((b, sk, kv, hd)).astype(np.float32),
            r.standard_normal((b, sk, kv, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _chunk_case(seed):
    r = np.random.default_rng(seed)
    c = int(r.integers(1, 24))
    prior = int(r.integers(0, 40))
    off = int(r.integers(0, 30))
    q, k, v = _qkv(r, 1, c, prior + c, 4, 2, 16)
    q_pos = (off + np.arange(c)).astype(np.int32)
    k_pos = np.concatenate([np.arange(prior), q_pos]).astype(np.int32)
    k_valid = np.concatenate([np.arange(prior) < off, np.ones(c, bool)])
    return q, k, v, q_pos, k_pos, k_valid


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    window=st.sampled_from([None, 6]),
    softcap=st.sampled_from([None, 15.0]),
)
def test_chunk_attention_matches_reference(seed, window, softcap):
    """Explicit absolute positions + garbage key rows: the port equals the
    interpret-mode Pallas kernel and the reference oracle."""
    case = _chunk_case(seed)
    got = tk.chunk_attention(*_t(*case), window=window, softcap=softcap)
    want_kernel = jk.chunk_attention(*_j(*case), window=window, softcap=softcap,
                                     q_block=8, kv_block=8, interpret=True)
    want_ref = jref.attention_ref(*_j(*case), causal=True, window=window,
                                  softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == case[0].shape
    _close(got, want_kernel)
    _close(got, want_ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_attention_lse_matches_streaming_statistic(seed):
    """``chunk_attention_fwd``'s lse is the reference kernel's lse (its
    second output, trimmed of the padded query rows)."""
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(seed)
    _, lse = tk.chunk_attention_fwd(*_t(q, k, v, q_pos, k_pos, k_valid))
    _, want = jk._flash_forward(*_j(q, k, v, q_pos, k_pos, k_valid.astype(np.int32)),
                                True, None, None, 8, 8, True)
    _close(lse, np.asarray(want)[:, :, :q.shape[1]])


def _paged_case(seed):
    r = np.random.default_rng(seed)
    b, blk, n_max, kv, h, hd = 3, 8, 4, 2, 4, 16
    nb = n_max * b + 1
    pool_k = r.standard_normal((nb, blk, kv, hd)).astype(np.float32)
    pool_v = r.standard_normal((nb, blk, kv, hd)).astype(np.float32)
    tables = np.zeros((b, n_max), np.int32)
    lengths = np.zeros((b,), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)
    for row in range(b):
        length = int(r.integers(1, n_max * blk + 1))
        lengths[row] = length
        n_live = -(-length // blk)
        tables[row, :n_live] = ids[:n_live]
        ids = ids[n_live:]
    q = r.standard_normal((b, 1, h, hd)).astype(np.float32)
    return q, pool_k, pool_v, tables, lengths


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10_000),
    softcap=st.sampled_from([None, 10.0]),
)
def test_paged_decode_matches_reference(seed, softcap):
    """Random tables (sentinel 0 in dead entries) and ragged lengths: the
    port equals the interpret-mode fused kernel and the gather oracle."""
    case = _paged_case(seed)
    got = tk.paged_decode_attention(*_t(*case), softcap=softcap)
    want_kernel = jk.paged_decode_attention(*_j(*case), softcap=softcap,
                                            interpret=True)
    want_ref = jref.paged_decode_ref(*_j(*case), softcap=softcap)
    _close(got, want_kernel)
    _close(got, want_ref)


def test_paged_decode_on_real_pool_matches_xla_gather():
    """A table carved by the REFERENCE BlockPool (holes, sentinel entries,
    out-of-order ids): the port's decode equals the reference kernel and the
    reference decode_attention on the gathered context."""
    r = np.random.default_rng(33)
    blk, n_max = 4, 6
    pool = JBlockPool(num_blocks=16, block_size=blk)
    churn = [pool.alloc() for _ in range(5)]
    for bid in churn[::2]:
        pool.release(bid)
    rows = []
    for length in (3, 9, 24, 1):
        n_live = -(-length // blk)
        tab = [pool.alloc() for _ in range(n_live)]
        rows.append((length, tab + [0] * (n_max - n_live)))
    tables = np.asarray([t for _, t in rows], np.int32)
    lengths = np.asarray([n for n, _ in rows], np.int32)
    b, kv, h, hd = len(rows), 2, 4, 8
    pool_k = r.standard_normal((16, blk, kv, hd)).astype(np.float32)
    pool_v = r.standard_normal((16, blk, kv, hd)).astype(np.float32)
    q = r.standard_normal((b, 1, h, hd)).astype(np.float32)
    got = tk.paged_decode_attention(*_t(q, pool_k, pool_v, tables, lengths))
    jq, jpk, jpv, jt, jl = _j(q, pool_k, pool_v, tables, lengths)
    gk = jnp.take(jpk, jt, axis=0).reshape(b, -1, kv, hd)
    gv = jnp.take(jpv, jt, axis=0).reshape(b, -1, kv, hd)
    _close(got, jattn.decode_attention(jq, gk, gv, jl, softcap=None, window=None))
    _close(got, jk.paged_decode_attention(jq, jpk, jpv, jt, jl, interpret=True))


def test_wrappers_keep_the_input_dtype_on_cpu():
    case = _chunk_case(4)
    q, k, v, q_pos, k_pos, k_valid = _t(*case)
    out = tk.chunk_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             q_pos, k_pos, k_valid)
    assert out.dtype == torch.bfloat16
    dec = tk.paged_decode_attention(*[x.bfloat16() if x.is_floating_point() else x
                                      for x in _t(*_paged_case(4))])
    assert dec.dtype == torch.bfloat16


def test_cpu_path_launches_nothing():
    """The launch counts move only where a kernel launches: the CPU path
    never does."""
    tkernels.reset_launch_counts()
    tk.chunk_attention(*_t(*_chunk_case(5)))
    tk.paged_decode_attention(*_t(*_paged_case(5)))
    q, k, v = (t.requires_grad_(True) for t in _t(*_qkv(np.random.default_rng(5),
                                                       1, 9, 9, 4, 2, 16)))
    tk.flash_attention(q, k, v).sum().backward()
    x, d = _t(*_psgn_inputs(np.random.default_rng(5), (2, 2, 12, 6, 5), np.float32))
    tpsgn.psgn_direct(x[0], d[0])
    tpsgn.psgn_gram(x[0], d[0])
    tpsgn.psgn_fused(x, d)
    tpsgn.psgn_split([x[0, 0]])
    tquant.quantize_int8(x[0, 0])
    assert tkernels.launch_counts() == {
        "chunk_attention": 0, "paged_decode_attention": 0, "flash_dq": 0,
        "flash_dkv": 0, "psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0,
        "psgn_split": 0, "quantize_int8": 0}


def test_wrappers_refuse_other_devices_and_bad_shapes():
    """A tensor neither on the CPU nor on a card has no path: the wrapper
    raises instead of picking one.  Mismatched shapes raise everywhere."""
    q, k, v, q_pos, k_pos, k_valid = _t(*_chunk_case(6))
    meta = [x.to("meta") for x in (q, k, v, q_pos, k_pos, k_valid)]
    with pytest.raises(ValueError, match="no path for device"):
        tk.chunk_attention(*meta)
    with pytest.raises(ValueError, match="chunk_attention"):
        tk.chunk_attention(q, k[:, :-1], v, q_pos, k_pos, k_valid)
    with pytest.raises(ValueError, match="window"):
        tk.chunk_attention(q, k, v, q_pos, k_pos, k_valid, window=0)
    pq, pk, pv, tables, lengths = _t(*_paged_case(6))
    with pytest.raises(ValueError, match="no path for device"):
        tk.paged_decode_attention(*[x.to("meta") for x in (pq, pk, pv, tables, lengths)])
    with pytest.raises(ValueError, match="tables"):
        tk.paged_decode_attention(pq, pk, pv, tables[:1], lengths)


def test_build_needs_nvcc_and_targets_sm90a(monkeypatch, tmp_path):
    """The build command compiles one source for sm_90a from csrc/ only,
    into a content-hashed library; without nvcc it raises a clear error."""
    monkeypatch.setattr(_build, "_nvcc_candidates", lambda: [str(tmp_path / "nvcc")])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    for name in _build.SIGNATURES:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + ".")
        cmd = _build.command(name, path)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1] == str(_build.CSRC / f"{name}.cu")
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("window,softcap", [(None, None), (3, 20.0)])
def test_plain_attention_lanes_match_reference(window, softcap):
    """``models/attention.py``: dense, chunk and decode attention equal the
    reference lanes in float32."""
    r = np.random.default_rng(7)
    q, k, v = _qkv(r, 2, 11, 11, 4, 2, 8)
    _close(tattn.attention(*_t(q, k, v), window=window, softcap=softcap),
           jattn.attention(*_j(q, k, v), window=window, softcap=softcap))
    cq, ck, cv, q_pos, k_pos, k_valid = _chunk_case(8)
    _close(tattn.chunk_attention(*_t(cq, ck, cv, q_pos, k_pos, k_valid),
                                 window=window, softcap=softcap),
           jattn.chunk_attention(*_j(cq, ck, cv, q_pos, k_pos, k_valid),
                                 window=window, softcap=softcap))
    dq = q[:, :1]
    n = np.asarray([5, 11], np.int32)
    _close(tattn.decode_attention(*_t(dq, k, v, n), softcap=softcap, window=window),
           jattn.decode_attention(*_j(dq, k, v, n), softcap=softcap, window=window))


def test_plain_versions_equal_the_oracle_module():
    """The wrapper's CPU path is ``kernels/ref.py`` itself."""
    case = _t(*_chunk_case(9))
    torch.testing.assert_close(tk.chunk_attention(*case),
                               tref.attention_ref(*case), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash attention with its recompute backward (the training path)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, h, kv, hd, window, softcap
    (1, 16, 2, 2, 16, None, None),   # one block, n_rep 1
    (2, 37, 4, 1, 32, None, None),   # ragged S, GQA n_rep 4
    (1, 45, 4, 2, 16, None, 20.0),   # softcap
    (1, 50, 4, 2, 16, 7, None),      # sliding window
    (1, 64, 2, 1, 32, 20, 15.0),     # window across blocks + softcap
]


def _jax_flash_vjp(q, k, v, dout, window, softcap):
    """The reference Pallas flash kernel (interpret mode, 16-blocks) and its
    custom_vjp backward."""
    import jax

    def f(q_, k_, v_):
        return jk.flash_attention(q_, k_, v_, True, window, softcap, 16, 16, True)

    out, vjp = jax.vjp(f, *_j(q, k, v))
    return (out, *vjp(jnp.asarray(dout)))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_and_grads_match_reference(case):
    """``flash_attention`` forward and its dq, dk, dv (autograd through the
    plain versions on the CPU) against the reference kernel through
    ``jax.vjp``: ragged S, GQA, softcap and window, atol 1e-5."""
    b, s, h, kv, hd, window, softcap = case
    r = np.random.default_rng(s + h)
    q, k, v = _qkv(r, b, s, s, h, kv, hd)
    dout = r.standard_normal(q.shape).astype(np.float32)
    tq, tk_, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = tk.flash_attention(tq, tk_, tv, True, window, softcap)
    out.backward(torch.from_numpy(dout))
    want = _jax_flash_vjp(q, k, v, dout, window, softcap)
    for got, exp in zip((out.detach(), tq.grad, tk_.grad, tv.grad), want):
        assert got.shape == exp.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES[1:3])
def test_flash_backward_wrappers_match_reference_passes(case):
    """The dq and dk/dv wrappers' CPU paths, fed the forward's lse and
    ``delta = rowsum(dout * out)``, equal the reference's ``_flash_backward``
    (its two Pallas passes plus the n_rep fold)."""
    b, s, h, kv, hd, window, softcap = case
    r = np.random.default_rng(11 * s)
    q, k, v = _qkv(r, b, s, s, h, kv, hd)
    dout = r.standard_normal(q.shape).astype(np.float32)
    tq, tkk, tv, tdo = _t(q, k, v, dout)
    pos = torch.arange(s)
    out, lse = tk.chunk_attention_fwd(tq, tkk, tv, pos, pos, torch.ones(s, dtype=torch.bool),
                                      window=window, softcap=softcap)
    delta = tref.flash_delta(out, tdo)
    dq = tk.flash_dq(tq, tkk, tv, tdo, lse, delta, window=window, softcap=softcap)
    dk, dv = tk.flash_dkv(tq, tkk, tv, tdo, lse, delta, window=window, softcap=softcap)
    jout, jlse = jk._flash_forward(
        *_j(q, k, v), jnp.arange(s), jnp.arange(s), jnp.ones((s,), jnp.int32), True,
        window, softcap, 16, 16, True)
    want = jk._flash_backward(*_j(q, k, v), jout, jlse, jnp.asarray(dout), True, window,
                              softcap, 16, 16, True)
    for got, exp in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)
    # and the plain backward is those two wrappers together
    for got, exp in zip(tref.flash_backward_ref(tq, tkk, tv, out, lse, tdo, window=window,
                                                softcap=softcap), (dq, dk, dv)):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)


def test_flash_attention_refuses_what_it_has_no_kernel_for():
    q, k, v = _t(*_qkv(np.random.default_rng(1), 1, 8, 8, 2, 2, 16))
    with pytest.raises(NotImplementedError, match="non-causal"):
        tk.flash_attention(q, k, v, causal=False)
    with pytest.raises(ValueError, match="Sk == Sq"):
        tk.flash_attention(q, k[:, :-1], v[:, :-1])
    stat = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse and delta"):
        tk.flash_dq(q, k, v, q, stat[:, :1], stat)
    with pytest.raises(ValueError, match="no path for device"):
        tk.flash_dkv(*[x.to("meta") for x in (q, k, v, q, stat, stat)])


# ---------------------------------------------------------------------------
# per-sample gradient norms (the gram tier's kernels)
# ---------------------------------------------------------------------------

# the sweep of tests/test_kernels.py (B, S, Din, Dout), ragged ones included
PSGN_SHAPES = [(2, 64, 32, 48), (3, 128, 16, 96), (1, 37, 19, 23), (2, 256, 128, 128),
               (4, 33, 7, 130)]
PSGN_DTYPES = {"f32": (np.float32, np.float32), "bf16": ("bfloat16", "bfloat16"),
               "bf16-x-f32-delta": ("bfloat16", np.float32)}
PSGN_TOL = dict(rtol=1e-5, atol=0)


def _psgn_inputs(r, shape, dtype):
    """float32 numpy x (..., S, Din) and delta (..., S, Dout) for the shape
    (..., S, Din, Dout); values exact in ``dtype``."""
    *lead, s, d_in, d_out = shape
    x = r.standard_normal((*lead, s, d_in)).astype(np.float32)
    d = r.standard_normal((*lead, s, d_out)).astype(np.float32)
    if dtype == "bfloat16":  # round once; both packages get the same values
        x, d = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, d))
    return x, d


def _both(x, d, dtypes):
    """(torch, jax) pairs of x and delta in the named dtypes."""
    tdt = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
    jdt = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}
    tx, td = (torch.from_numpy(a).to(tdt[dt]) for a, dt in zip((x, d), dtypes))
    jx, jd = (jnp.asarray(a, jdt[dt]) for a, dt in zip((x, d), dtypes))
    return (tx, td), (jx, jd)


def _close_rel(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **PSGN_TOL)


@pytest.mark.parametrize("dtypes", list(PSGN_DTYPES), ids=list(PSGN_DTYPES))
@pytest.mark.parametrize("shape", PSGN_SHAPES)
def test_psgn_direct_and_gram_match_reference(shape, dtypes):
    """Both wrappers (CPU path) against the reference kernels in interpret
    mode, at the ops dispatch's block sizes, and against ``ref.psgn_ref``."""
    dts = PSGN_DTYPES[dtypes]
    x, d = _psgn_inputs(np.random.default_rng(sum(shape)), shape, dts[0])
    (tx, td), (jx, jd) = _both(x, d, dts)
    want = np.asarray(jref.psgn_ref(jx, jd))
    for method, fn in (("direct", tpsgn.psgn_direct), ("gram", tpsgn.psgn_gram)):
        got = fn(tx, td)
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        _close_rel(got, want)
        _close_rel(got, jops.persample_sq_norm(jx, jd, method=method, interpret=True))


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_psgn_fused_matches_reference_kernel(dtypes):
    """One fused call over L stacked layers against the reference's fused
    kernel (interpret) and the sum of per-layer oracles; the CPU path is
    ``ref.psgn_fused_ref``."""
    dts = PSGN_DTYPES[dtypes]
    x, d = _psgn_inputs(np.random.default_rng(11), (3, 4, 24, 10, 6), dts[0])
    (tx, td), (jx, jd) = _both(x, d, dts)
    got = tpsgn.psgn_fused(tx, td)
    _close_rel(got, jpsgn.psgn_fused(jx, jd, block_i=8, block_j=8, block_s=16,
                                     interpret=True))
    _close_rel(got, sum(np.asarray(jref.psgn_ref(jx[i], jd[i])) for i in range(3)))
    torch.testing.assert_close(got, tref.psgn_fused_ref(tx, td), rtol=0, atol=0)


def test_psgn_gram_identity_refs_agree():
    x, d = _t(*_psgn_inputs(np.random.default_rng(3), (2, 50, 12, 20), np.float32))
    torch.testing.assert_close(tref.psgn_gram_ref(x, d), tref.psgn_ref(x, d),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", range(12))
def test_psgn_property_random_shapes(case):
    """The reference's property sweep: random (B, S, Din, Dout) and dtype,
    both factorisations against the reference oracle."""
    r = np.random.default_rng(1000 + case)
    shape = (int(r.integers(1, 5)), int(r.integers(1, 97)), int(r.integers(1, 90)),
             int(r.integers(1, 90)))
    dts = PSGN_DTYPES[("f32", "bf16")[case % 2]]
    (tx, td), (jx, jd) = _both(*_psgn_inputs(r, shape, dts[0]), dts)
    want = np.asarray(jref.psgn_ref(jx, jd))
    _close_rel(tpsgn.psgn_direct(tx, td), want)
    _close_rel(tpsgn.psgn_gram(tx, td), want)


def test_choose_method_matches_reference_exactly():
    """The FLOP-count dispatch on a grid of shapes, ties included (S 2048
    at Yi-6B's q/o widths is a tie that goes to direct)."""
    for s in (1, 16, 32, 37, 512, 2048, 4096):
        for d_in in (7, 32, 64, 512, 4096, 11008):
            for d_out in (5, 32, 128, 512, 4096, 11008):
                assert tops.choose_method(s, d_in, d_out) == \
                    jops.choose_method(s, d_in, d_out), (s, d_in, d_out)
    assert tops.choose_method(2048, 4096, 4096) == "direct"
    assert tops.choose_method(2048, 4096, 512) == "direct"
    assert tops.choose_method(2048, 4096, 11008) == "gram"
    assert tops.choose_method(2048, 11008, 4096) == "gram"
    assert [tops._round_pow2(n) for n in (1, 2, 3, 37, 512, 513)] == [1, 2, 2, 32, 512, 512]


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_persample_sq_norm_dispatch_and_2d_closed_form(dtypes):
    """``ops.persample_sq_norm``: auto dispatch at a direct and a gram
    shape, both methods forced, and the 2-D closed form."""
    dts = PSGN_DTYPES[dtypes]
    r = np.random.default_rng(21)
    for shape in ((2, 40, 6, 5), (2, 8, 24, 40)):
        (tx, td), (jx, jd) = _both(*_psgn_inputs(r, shape, dts[0]), dts)
        for method in ("auto", "direct", "gram"):
            _close_rel(tops.persample_sq_norm(tx, td, method=method),
                       jops.persample_sq_norm(jx, jd, method=method, interpret=True))
    (tx, td), (jx, jd) = _both(*_psgn_inputs(r, (5, 33, 7), dts[0]), dts)
    _close_rel(tops.persample_sq_norm(tx, td), jops.persample_sq_norm(jx, jd))
    with pytest.raises(ValueError, match="unknown method"):
        tops.persample_sq_norm(tx[:, None], td[:, None], method="vmap")


@pytest.mark.parametrize("bias", [False, True])
def test_persample_sq_norm_tree_matches_reference(bias):
    """A tree of 7 layers in the gram tier's shape mix: two same-shape
    direct groups (fused), a lone direct layer, gram layers and a 2-D layer;
    the grouping exactly and the total against the reference's tree."""
    r = np.random.default_rng(5 + bias)
    b, s = 3, 16
    widths = {"a.q": (32, 32), "a.k": (32, 16), "a.o": (32, 32), "b.q": (32, 32),
              "b.k": (32, 16), "a.gate": (32, 64), "a.down": (64, 32), "lone": (9, 3)}
    acts, deltas = {}, {}
    for name, (d_in, d_out) in widths.items():
        acts[name] = r.standard_normal((b, s, d_in)).astype(np.float32)
        deltas[name] = r.standard_normal((b, s, d_out)).astype(np.float32)
    acts["flat"] = r.standard_normal((b, 12)).astype(np.float32)
    deltas["flat"] = r.standard_normal((b, 5)).astype(np.float32)
    tacts = {n: torch.from_numpy(a) for n, a in acts.items()}
    tdel = {n: torch.from_numpy(a) for n, a in deltas.items()}
    groups = tops.group_layers(tacts, tdel)
    assert [names for names in groups.values()] == [
        ["a.q", "a.o", "b.q"], ["a.k", "b.k"], ["a.gate"], ["a.down"], ["lone"], ["flat"]]
    assert [k[0] == "solo" for k in groups] == [False, False, True, True, False, True]
    got = tops.persample_sq_norm_tree(tacts, tdel, scale=3.0, bias=bias)
    want = jops.persample_sq_norm_tree(
        {n: jnp.asarray(a) for n, a in acts.items()},
        {n: jnp.asarray(a) for n, a in deltas.items()}, scale=3.0, bias=bias,
        interpret=True)
    _close_rel(got, want)


def test_psgn_wrappers_refuse_bad_shapes_and_devices():
    x, d = _t(*_psgn_inputs(np.random.default_rng(8), (2, 3, 10, 4, 6), np.float32))
    with pytest.raises(ValueError, match="agree"):
        tpsgn.psgn_direct(x[0], d[0, :, :-1])
    with pytest.raises(ValueError, match="4-D"):
        tpsgn.psgn_fused(x[0], d[0])
    with pytest.raises(ValueError, match="empty"):
        tpsgn.psgn_gram(x[0, :, :0], d[0, :, :0])
    for fn, args in ((tpsgn.psgn_direct, (x[0], d[0])), (tpsgn.psgn_gram, (x[0], d[0])),
                     (tpsgn.psgn_fused, (x, d))):
        with pytest.raises(ValueError, match="no path for device"):
            fn(*[a.to("meta") for a in args])


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtypes", [(BF16, BF16), (F32, F32), (BF16, F32), (F32, BF16)],
                         ids=["bf16", "f32", "bf16-f32", "f32-bf16"])
@pytest.mark.parametrize("widths", [(8, 8), (136, 4096), (4096, 11008), (19, 8),
                                    (8, 19), (4096, 4100)])
def test_psgn_route_plan(dtypes, widths):
    """The tensor cores take bf16 x and delta whose widths are multiples of
    8; direct with a float32 operand at such widths takes the split route
    (3 term pairs with one float32 operand, 6 with two) on the same tiles;
    anything else takes the FMA kernels, with their 128 x 128 tiles."""
    d_in, d_out = widths
    widths8 = d_in % 8 == 0 and d_out % 8 == 0
    tc = dtypes == (BF16, BF16) and widths8
    direct = tpsgn.plan("direct", *dtypes, 300, d_in, d_out, n_layers=3)
    gram = tpsgn.plan("gram", *dtypes, 300, d_in, d_out)
    want_direct = "tc" if tc else ("split" if widths8 else "fma")
    assert (direct.route, gram.route) == (want_direct, "tc" if tc else "fma")
    ceil = lambda n, t: -(-n // t)  # noqa: E731
    pairs = {(BF16, BF16): 1, (BF16, F32): 3, (F32, BF16): 3, (F32, F32): 6}[dtypes]
    if widths8:
        assert direct == (want_direct, (128, 256), 3 * ceil(d_in, 128) * ceil(d_out, 256),
                          pairs)
    else:
        assert direct == ("fma", (128, 128), 3 * ceil(d_in, 128) * ceil(d_out, 128), 1)
    if tc:
        assert gram == ("tc", (64, 128), 2 * 3 * 4 // 2, 1)  # 3 tiles of S: 6 pairs, 2 halves
    else:
        assert gram == ("fma", (128, 128), 3 * 4 // 2, 1)


@pytest.mark.parametrize("dtypes, want", [
    ((BF16, BF16), ((0, 0),)),
    ((BF16, F32), ((0, 0), (0, 1), (0, 2))),
    ((F32, BF16), ((0, 0), (1, 0), (2, 0))),
    ((F32, F32), ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))),
])
def test_split_pairs(dtypes, want):
    """The term pairs the split route sums: every pair of a bf16 operand's
    one term with a float32 operand's three, and with two float32 operands
    the six with i + j <= 2."""
    assert tpsgn.split_pairs(*dtypes) == want
    assert tpsgn.plan("direct", *dtypes, 64, 8, 8).pairs == len(want)


@pytest.mark.parametrize("s, d_in, d_out, n_layers, want_direct, want_gram", [
    (1, 8, 8, 1, 1, 2),                # one position: one tile, one half-pair each
    (2048, 4096, 4096, 16, 16 * 32 * 16, 16 * 17),  # the q/o group; 136 pairs
    (2048, 4096, 512, 16, 16 * 32 * 2, 16 * 17),    # the k/v group
    (2049, 4104, 264, 3, 3 * 33 * 2, 17 * 18),      # ragged S and both widths
])
def test_psgn_tc_partial_counts(s, d_in, d_out, n_layers, want_direct, want_gram):
    assert tpsgn.plan("direct", BF16, BF16, s, d_in, d_out, n_layers).n_partials == want_direct
    assert tpsgn.plan("gram", BF16, BF16, s, d_in, d_out).n_partials == want_gram
    with pytest.raises(ValueError, match="unknown kind"):
        tpsgn.plan("fused", BF16, BF16, s, d_in, d_out)


def _split_values(case: str) -> torch.Tensor:
    """float32 values for the split's cases."""
    r = np.random.default_rng(len(case))
    if case == "random":  # normals over 2^-100 .. 2^100
        v = r.standard_normal(4096) * np.exp2(r.uniform(-100, 100, 4096))
    elif case == "powers of two":
        e = np.arange(-149, 128, dtype=np.float64)
        v = np.concatenate([np.exp2(e), -np.exp2(e)])
    elif case == "edges":  # +-0, FLT_MAX, the least normal, 1 and its neighbours
        f = np.finfo(np.float32)
        v = np.array([0.0, -0.0, f.max, -f.max, f.tiny, -f.tiny, 1.0,
                      np.nextafter(np.float32(1), np.float32(2)),
                      np.nextafter(np.float32(1), np.float32(0)), f.max / 3])
    else:  # "subnormals": every bit pattern class below the least normal
        bits = np.concatenate([r.integers(1, 1 << 23, 2000), r.integers(1, 1 << 7, 100) << 16,
                               np.arange(1, 64)])
        v = bits.astype(np.uint32).view(np.float32) * np.where(r.random(bits.size) < 0.5, 1, -1)
    return torch.from_numpy(np.asarray(v, np.float32))


@pytest.mark.parametrize("case", ["random", "powers of two", "edges", "subnormals"])
def test_split_bf16_terms_sum_to_the_value(case):
    """hi + mid + lo equals v bit for bit wherever v is a multiple of 2^-133,
    bf16's least subnormal (every |v| >= 2^-110, and the subnormals whose low
    16 bits are 0); below that it is v cut toward zero to such a multiple.
    Each term is v's or a remainder's top 16 bits, so |mid| < 2^-7 |hi| and
    |lo| < 2^-14 |hi|; the wrapper's CPU path stacks the plain version."""
    v = _split_values(case)
    t = tref.split_bf16(v)
    assert t.dtype == torch.bfloat16 and t.shape == (3, *v.shape)
    total = (t[0].float() + t[1].float()) + t[2].float()  # hi + mid is exact
    exact = (v.double() / 2 ** -133).frac() == 0
    assert (v.abs()[~exact] < 2 ** -110).all()
    assert torch.equal(total[exact], v[exact])
    cut = torch.trunc(v.double()[~exact] / 2 ** -133) * 2 ** -133
    assert torch.equal(total[~exact].double(), cut)
    assert torch.equal(t[0].view(torch.int16), (v.view(torch.int32) >> 16).to(torch.int16))
    big = v.abs() >= 2 ** -110
    assert (t[1].float().abs() < 2 ** -7 * t[0].float().abs())[big & (t[1] != 0)].all()
    assert (t[2].float().abs() < 2 ** -14 * t[0].float().abs())[big & (t[2] != 0)].all()
    assert torch.isfinite(t.float()).all()
    torch.testing.assert_close(tpsgn.psgn_split([v, -v]), torch.stack(
        [t, tref.split_bf16(-v)], 1), rtol=0, atol=0)


def test_split_bf16_non_finite_values():
    """inf, -inf and NaN map to (v, 0, 0): an infinity stays one (never inf -
    inf), a NaN stays a NaN, with its quiet bit set (a NaN whose payload is
    in its low 16 bits would otherwise cut to an infinity)."""
    v = torch.tensor([np.inf, -np.inf, np.nan, 1.5], dtype=torch.float32)
    v = torch.cat([v, torch.tensor([0x7F800001, 0xFF800001 - (1 << 32)],
                                   dtype=torch.int32).view(torch.float32)])
    t = tref.split_bf16(v)
    assert t[0, 0].item() == np.inf and t[0, 1].item() == -np.inf
    assert torch.isnan(t[0, [2, 4, 5]].float()).all()
    assert t[0, 3].item() == 1.5
    assert not t[1:, [0, 1, 2, 4, 5]].float().any()
    assert (t[0, [4, 5]].view(torch.int16) & 0x40).all()


def _split_route_emulation(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The split route's arithmetic in plain torch: each float32 operand of
    (L, B, S, .) split into bf16 terms, the products of ``split_pairs``'
    term pairs summed in one float32 product per layer (bf16 products are
    exact in float32), squared, summed over the layers."""
    terms = [tref.split_bf16(t) if t.dtype == torch.float32 else t[None] for t in (x, d)]
    total = torch.zeros(x.shape[1])
    for layer in range(x.shape[0]):
        g = sum(torch.einsum("bsi,bsj->bij", terms[0][i, layer].float(),
                             terms[1][j, layer].float())
                for i, j in tpsgn.split_pairs(x.dtype, d.dtype))
        total = total + g.square().sum((1, 2))
    return total


@pytest.mark.parametrize("dtypes", ["bf16-f32", "f32-bf16", "f32-f32"])
@pytest.mark.parametrize("shape", [(1, 2, 64, 32, 48), (3, 2, 37, 24, 16),
                                   (2, 3, 130, 16, 40)])
def test_split_route_emulation_matches_reference(shape, dtypes):
    """The split route's arithmetic against the reference's psgn_direct (L =
    1) and psgn_fused (interpret mode) and ``ref.psgn_ref``, 1e-5 relative,
    for each dtype pair: the pairs the f32 x f32 route leaves out are below
    2^-21 of |x||d| each."""
    names = {"bf16": "bfloat16", "f32": np.float32}
    dts = tuple(names[n] for n in dtypes.split("-"))
    r = np.random.default_rng(sum(shape))
    *lead, s_, d_in, d_out = shape
    x = r.standard_normal((*lead, s_, d_in)).astype(np.float32)
    d = r.standard_normal((*lead, s_, d_out)).astype(np.float32)
    (tx, td), (jx, jd) = _both(x, d, dts)
    got = _split_route_emulation(tx, td)
    want = sum(np.asarray(jref.psgn_ref(jx[i], jd[i]), np.float64) for i in range(shape[0]))
    _close_rel(got, want)
    _close_rel(got, jpsgn.psgn_fused(jx, jd, block_i=8, block_j=8, block_s=16,
                                     interpret=True))
    _close_rel(_split_route_emulation(tx[:1], td[:1]),
               jpsgn.psgn_direct(jx[0], jd[0], block_i=8, block_j=8, block_s=16,
                                 interpret=True))
    assert tpsgn.plan("direct", tx.dtype, td.dtype, s_, d_in, d_out, shape[0]).route == "split"


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_psgn_fused_layers_plain_matches_stacked_and_reference(dtypes):
    """The layer-table entry's CPU path (the layers stacked into the plain
    version) gives the stacked call's bits, and the reference tree's value
    for the same group; it counts no launch."""
    dts = PSGN_DTYPES[dtypes]
    x, d = _psgn_inputs(np.random.default_rng(13), (3, 2, 16, 24, 16), dts[0])
    (tx, td), (jx, jd) = _both(x, d, dts)
    tkernels.reset_launch_counts()
    got = tpsgn.psgn_fused_layers(list(tx), list(td))
    torch.testing.assert_close(got, tpsgn.psgn_fused(tx, td), rtol=0, atol=0)
    names = [f"l{i}.q" for i in range(3)]
    want = jops.persample_sq_norm_tree(dict(zip(names, jx)), dict(zip(names, jd)),
                                       interpret=True)
    _close_rel(got, want)
    _close_rel(tops.persample_sq_norm_tree(dict(zip(names, tx)), dict(zip(names, td))), want)
    assert not any(tkernels.launch_counts().values())
    assert tkernels.route_counts() == {
        **{n: {"tc": 0, "fma": 0} for n in ("chunk_attention", "flash_dq", "flash_dkv",
                                            "psgn_gram")},
        "psgn_direct": {"tc": 0, "split": 0, "fma": 0},
        "psgn_fused": {"tc": 0, "split": 0, "fma": 0}}
    with pytest.raises(ValueError, match="differ"):
        tpsgn.psgn_fused_layers([tx[0], tx[1][:, :8]], [td[0], td[1][:, :8]])
    with pytest.raises(ValueError, match="activations"):
        tpsgn.psgn_fused_layers([tx[0]], [])


# ---------------------------------------------------------------------------
# int8 quantisation
# ---------------------------------------------------------------------------


def _quant_input(case: str) -> np.ndarray:
    """float32 (R, C) inputs for the quantisation cases."""
    r = np.random.default_rng(len(case))
    if case == "ragged rows":  # R not a multiple of the 32-row block
        return r.standard_normal((45, 64)).astype(np.float32) * 3
    if case == "C 1":
        return r.standard_normal((7, 1)).astype(np.float32)
    if case == "ragged C":
        return r.standard_normal((33, 129)).astype(np.float32)
    if case == "one element":
        return np.array([[-2.5]], np.float32)
    if case == "zero row":
        x = r.standard_normal((5, 40)).astype(np.float32)
        x[2] = 0.0
        return x
    if case == "ties":  # absmax 127 -> scale exactly 1: every x.5 is a tie
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]],
                     np.float32)
        return np.concatenate([x, 2 * x, x / 4])
    if case == "negative max":  # the absmax of each row is a negative entry
        x = r.uniform(-1, 1, (6, 50)).astype(np.float32)
        x[np.arange(6), r.integers(0, 50, 6)] = -np.arange(2, 8, dtype=np.float32)
        return x
    if case == "rows at 32768":  # the card's one-pass design's longest row
        return r.standard_normal((2, 32768)).astype(np.float32)
    if case == "long ragged rows":  # the card's two-pass design, a ragged last chunk
        x = r.standard_normal((2, 40001)).astype(np.float32)
        x[1, 39999] = -7.0
        return x
    if case == "NaN and inf rows":  # NaN or infinite scales, every code 0
        x = r.standard_normal((5, 40)).astype(np.float32)
        x[0, 7], x[1, 39], x[2, 20] = np.nan, np.inf, -np.inf
        x[3, [1, 30]] = np.inf, np.nan
        return x
    raise KeyError(case)


QUANT_CASES = ["ragged rows", "C 1", "ragged C", "one element", "zero row", "ties",
               "negative max", "rows at 32768", "long ragged rows", "NaN and inf rows"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantize_int8_matches_reference(case, dtype):
    """Codes and scales equal to the Pallas kernel (interpret, 32-row
    blocks) and to the reference's plain version; dequantised values equal."""
    x32 = _quant_input(case)
    if dtype == "bfloat16":  # values on the bf16 grid, the same in both
        tx = torch.from_numpy(x32).to(torch.bfloat16)
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    else:
        tx, jx = torch.from_numpy(x32), jnp.asarray(x32)
    q, s = tquant.quantize_int8(tx, block_rows=32)
    jq, js = jquant.quantize_int8(jx, block_rows=32, interpret=True)
    rq, rs = jref.quantize_int8_ref(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == tx.shape and s.shape == (tx.shape[0],)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    js, jq = np.asarray(js), np.asarray(jq)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(s.numpy()[~fin], js[~fin])  # NaN and inf alike
    assert np.all(np.abs(s.numpy() - js)[fin] <= np.spacing(js[fin])), (s.numpy(), js)
    same = s.numpy() == js
    np.testing.assert_array_equal(q.numpy()[same], jq[same])
    with_js = torch.round(tx.float() / torch.from_numpy(js)[:, None]).clamp(-127, 127)
    np.testing.assert_array_equal(with_js.to(torch.int8).numpy(), jq)
    np.testing.assert_array_equal(
        tquant.dequantize_int8(q, s).numpy(),
        np.asarray(jref.dequantize_int8_ref(rq, rs)))
    if case == "ties":
        assert q[0, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 126]  # half to even
    if case == "NaN and inf rows":
        assert np.isnan(s[[0, 3]].numpy()).all() and np.isposinf(s[[1, 2]].numpy()).all()
        assert not q[:4].any() and np.isfinite(s[4].item())


def test_compiled_reference_scale_is_the_reciprocal_product():
    """Where the interpret-mode scales differ from the division, they are
    the compiled product ``absmax * float32(1/127)``: the port's plain
    version keeps the division the source writes."""
    x = (np.random.default_rng(0).standard_normal((2000, 64)) * 3).astype(np.float32)
    _, js = jquant.quantize_int8(jnp.asarray(x), block_rows=32, interpret=True)
    absmax = np.maximum(np.abs(x).max(1), np.float32(1e-12))
    np.testing.assert_array_equal(np.asarray(js), absmax * (np.float32(1) / np.float32(127)))
    _, s = tquant.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), absmax / np.float32(127))
    assert (s.numpy() != np.asarray(js)).sum() > 0


def test_quantize_int8_ops_exports_and_refusals():
    assert tops.quantize_int8 is tquant.quantize_int8
    assert tops.dequantize_int8 is tquant.dequantize_int8
    with pytest.raises(ValueError, match="2-D"):
        tquant.quantize_int8(torch.zeros(4))
    with pytest.raises(ValueError, match="empty"):
        tquant.quantize_int8(torch.zeros(0, 3))
    with pytest.raises(ValueError, match="no path for device"):
        tquant.quantize_int8(torch.zeros(2, 3, device="meta"))
    assert "quant_int8" in _build.SIGNATURES
