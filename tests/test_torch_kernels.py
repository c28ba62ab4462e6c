"""The port's serving-kernel wrappers against the JAX reference, on the CPU.

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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import attention as jk
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.serve.blocks import BlockPool as JBlockPool
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tk
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
    tk.reset_launch_counts()
    tk.chunk_attention(*_t(*_chunk_case(5)))
    tk.paged_decode_attention(*_t(*_paged_case(5)))
    assert tk.launch_counts() == {"chunk_attention": 0, "paged_decode_attention": 0}


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
