"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each kernel is held against its plain PyTorch version on the same inputs on
the card: float32 at 1e-4 (the kernel sums in another order), bfloat16 at
2e-2 against the plain version computed in float32 from the same bf16
inputs (the kernel rounds p to bf16 before the PV product and the output to
bf16).  The flash backward kernels write float32 dq, dk and dv from bf16
inputs, rounding at the same points as their plain version, so their bf16
cases are held at 2e-3 absolute: the measured error at the training shape
is 5e-4, and 2e-2 would be as large as a typical dq.  The per-sample
gradient-norm kernels write float32 from float32 or bf16 inputs, whose
products are exact in float32, on either route (tensor cores for bf16 at
widths that are multiples of 8, FMA kernels otherwise): they are held at
1e-4 relative (the largest difference seen is 4e-6), the routes against
each other too.  The int8 quantisation kernel must match its
plain version BIT FOR BIT (codes and scales, a NaN scale in the same
rows): its arithmetic is one IEEE division, round half to even and a max,
in no order that matters.  The pod-path Trainer on the card is held
against the CPU over one epoch with losses and parameters within 1e-5:
no code flips in that epoch on an H100, and a code that landed on the
neighbouring value would move a step by one quantum.  TF32 is off.  Whether a card is present is
decided inside the ``cuda`` fixture, so every worker collects the same
tests; without a Hopper card they skip.

Run on the card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ref
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import psgn, quant
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (atol, rtol) of the flash backward's float32 outputs, by input dtype
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built for sm_90a)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper card (capability >= 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=tol, rtol=tol)


def _chunk_case(r, dev, dtype, b, c, prior, off, h, kv, hd):
    sk = prior + c
    q = torch.from_numpy(r.standard_normal((b, c, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    q_pos = off + torch.arange(c, device=dev, dtype=torch.int32)
    k_pos = torch.cat([torch.arange(prior, device=dev, dtype=torch.int32), q_pos])
    k_valid = torch.cat([torch.arange(prior, device=dev) < off,
                         torch.ones(c, dtype=torch.bool, device=dev)])
    return q, k, v, q_pos, k_pos, k_valid


def test_kernels_build(cuda):
    info = _build.build_all()
    assert set(info) == set(_build.SIGNATURES)
    for name in _build.SIGNATURES:
        assert _build.library_path(name).exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, c, prior, off, h, kv, hd, window, softcap
    (1, 16, 0, 0, 4, 4, 32, None, None),     # n_rep 1, no prior
    (2, 23, 37, 20, 8, 1, 64, None, 30.0),   # n_rep 8, ragged C and Sk, softcap
    (1, 40, 48, 48, 4, 2, 128, 6, None),     # window
    (1, 9, 5, 300, 8, 2, 128, None, None),   # positions past the array bounds
])
def test_chunk_kernel_matches_plain(cuda, dtype, case):
    b, c, prior, off, h, kv, hd, window, softcap = case
    r = np.random.default_rng(c * 31 + prior)
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(r, cuda, dtype, b, c, prior, off, h, kv, hd)
    got, lse = kattn.chunk_attention_fwd(q, k, v, q_pos, k_pos, k_valid,
                                         window=window, softcap=softcap)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref_lse(q, k, v, q_pos, k_pos, k_valid,
                                           window=window, softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)
    _close(lse, want_lse, torch.float32 if dtype == torch.float32 else dtype)


def test_chunk_kernel_padding_rows(cuda):
    """Query rows at position -(2**30) are padding: finite output, the same
    as the plain version (the mean of v over the real keys)."""
    r = np.random.default_rng(5)
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(r, cuda, torch.float32,
                                                 1, 12, 16, 8, 4, 2, 64)
    q_pos[-3:] = -(2 ** 30)
    got = kattn.chunk_attention(q, k, v, q_pos, k_pos, k_valid)
    want = ref.attention_ref(q, k, v, q_pos, k_pos, k_valid)
    assert torch.isfinite(got).all()
    _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 10.0])
def test_paged_decode_kernel_matches_plain(cuda, dtype, softcap):
    r = np.random.default_rng(11)
    b, blk, n_max, kv, h, hd = 8, 16, 12, 4, 32, 128
    nb = n_max * b + 1
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    tables = np.zeros((b, n_max), np.int32)
    lengths = np.zeros((b,), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)  # out-of-order pool ids
    for row in range(b):
        length = int(r.integers(1, n_max * blk + 1))
        lengths[row] = length
        n_live = -(-length // blk)
        tables[row, :n_live] = ids[:n_live]  # dead entries stay at sentinel 0
        ids = ids[n_live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    tables_t = torch.from_numpy(tables).to(cuda)
    lengths_t = torch.from_numpy(lengths).to(cuda)
    got = kattn.paged_decode_attention(q, pool_k, pool_v, tables_t, lengths_t,
                                       softcap=softcap)
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(q, pool_k, pool_v, tables_t, lengths_t, softcap=softcap)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_split_edges(cuda, dtype):
    """The decode kernel split over the context (``decode_plan``: 9 splits at
    B 8, KV 4 on 132 SMs) at its edges: lengths 1 and one block, on a split
    boundary (288: 18 entries in shares of 2) and a token either side, a full
    table, and free lanes whose tables are all sentinel with lengths that
    kept counting (one past the table).  Within TOL of the plain version,
    finite, and the same bits over 20 launches."""
    r = np.random.default_rng(12)
    blk, n_max, kv, h, hd = 16, 192, 4, 32, 128
    lens = [1, blk, 287, 288, 289, n_max * blk, 37, 5000]
    b, nb = len(lens), 2048
    tables = np.zeros((b, n_max), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)
    for row, n in enumerate(lens[:6]):
        live = -(-n // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    args = (q, pool_k, pool_v, torch.from_numpy(tables).to(cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))
    kernels.reset_launch_counts()
    outs = [kattn.paged_decode_attention(*args) for _ in range(20)]
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kattn.paged_decode_attention.splits == kattn.decode_plan(b, kv, n_max, blk, sms) > 1
    assert kattn.paged_decode_attention.launches == 20
    assert torch.isfinite(outs[0]).all()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _close(outs[0], ref.paged_decode_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [24, 80])
def test_paged_decode_at_other_head_dims(cuda, dtype, hd):
    """Head dims whose column pairs do not divide the block (each thread's
    outputs over several columns), one (hd 24 in bf16) with an odd count of
    16-byte chunks a row: within TOL of the plain version over 3 splits."""
    r = np.random.default_rng(hd)
    b, blk, n_max, kv, h = 3, 16, 5, 2, 4
    nb = 1 + b * n_max
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    tables = torch.arange(1, nb, dtype=torch.int32, device=cuda).reshape(b, n_max)
    lengths = torch.tensor([1, 40, n_max * blk], dtype=torch.int32, device=cuda)
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    got = kattn.paged_decode_attention(q, pool_k, pool_v, tables, lengths, softcap=5.0)
    torch.cuda.synchronize()
    assert kattn.paged_decode_attention.splits > 1
    _close(got, ref.paged_decode_ref(q, pool_k, pool_v, tables, lengths, softcap=5.0), dtype)


def test_launch_counters_and_refusals(cuda):
    r = np.random.default_rng(2)
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(r, cuda, torch.float32,
                                                 1, 8, 8, 8, 4, 2, 32)
    kernels.reset_launch_counts()
    kattn.chunk_attention(q, k, v, q_pos, k_pos, k_valid)
    assert kernels.launch_counts() == {"chunk_attention": 1, "paged_decode_attention": 0,
                                       "flash_dq": 0, "flash_dkv": 0, "psgn_direct": 0,
                                       "psgn_gram": 0, "psgn_fused": 0, "psgn_split": 0,
                                       "quantize_int8": 0}
    bad = torch.zeros((1, 8, 4, 48), device=cuda)  # no head-dim-48 instance
    with pytest.raises(ValueError, match="head dim"):
        kattn.chunk_attention(bad, bad[:, :, :2], bad[:, :, :2], q_pos,
                              q_pos, torch.ones(8, dtype=torch.bool, device=cuda))
    assert kattn.chunk_attention.launches == 1


def _flash_case(r, dev, dtype, b, s, h, kv, hd, window, softcap, causal=True):
    """Inputs of one flash backward: q, k, v, dout and the card forward's
    out and lse (the pairing the training path uses)."""
    q = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    dout = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    out, lse = kattn.chunk_attention_fwd(q, k, v, pos, pos, torch.ones_like(pos),
                                         window=window, softcap=softcap, causal=causal)
    return q, k, v, dout, out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, s, h, kv, hd, window, softcap
    (1, 16, 4, 4, 32, None, None),      # a single tile, n_rep 1
    (2, 37, 8, 1, 64, None, 30.0),      # ragged S, n_rep 8, softcap
    (1, 300, 8, 2, 128, None, None),    # ragged S over 10 tiles
    (1, 100, 4, 2, 128, 6, None),       # sliding window
    (1, 70, 8, 8, 64, 40, 20.0),        # window across tiles + softcap
])
def test_flash_backward_kernels_match_plain(cuda, dtype, case):
    b, s, h, kv, hd, window, softcap = case
    r = np.random.default_rng(s * 7 + h)
    q, k, v, dout, out, lse = _flash_case(r, cuda, dtype, b, s, h, kv, hd, window,
                                          softcap)
    delta = ref.flash_delta(out, dout)
    kernels.reset_launch_counts()
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, window=window, softcap=softcap)
    dk, dv = kattn.flash_dkv(q, k, v, dout, lse, delta, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert kattn.flash_dq.launches == 1 and kattn.flash_dkv.launches == 1
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, window=window,
                                  softcap=softcap)
    atol, rtol = FLASH_TOL[dtype]
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and got.shape == exp.shape
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # b, s, h, kv, hd, window, softcap, causal
    (2, 37, 4, 4, 80, None, None, False),     # ragged S, n_rep 1
    (1, 300, 8, 2, 80, None, 30.0, False),    # n_rep 4 over 10 tiles, softcap
    (1, 150, 4, 1, 112, 40, None, False),     # one-sided window across tiles
    (2, 70, 8, 2, 112, None, 20.0, False),    # n_rep 4, softcap
    (1, 129, 4, 4, 64, 30, None, False),      # non-causal at a tensor-core head dim
    (1, 100, 4, 2, 80, 20, 15.0, True),       # causal hd 80, window + softcap
    (1, 65, 4, 4, 112, None, None, True),     # causal hd 112
])
def test_noncausal_kernels_match_plain(cuda, dtype, case):
    """The chunk forward, dq and dk/dv without causality (and causal at the
    head dims 80 and 112) against their plain versions: out and lse at TOL,
    dq, dk and dv at FLASH_TOL; every launch on the route ``attention_plan``
    names for its kernel (in bf16 at hd 64 and above all three on the
    tensor cores)."""
    b, s, h, kv, hd, window, softcap, causal = case
    r = np.random.default_rng(s * 5 + hd)
    kernels.reset_launch_counts()
    q, k, v, dout, out, lse = _flash_case(r, cuda, dtype, b, s, h, kv, hd, window,
                                          softcap, causal)
    pos = torch.arange(s, device=cuda)
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, torch.ones_like(pos),
                                               causal=causal, window=window,
                                               softcap=softcap)
    _close(out, want_out, dtype)
    _close(lse, want_lse, dtype)
    delta = ref.flash_delta(out, dout)
    kw = dict(window=window, softcap=softcap, causal=causal)
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = kattn.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    routes = kernels.route_counts()
    plan = kattn.attention_plan(dtype, hd, causal)
    assert all(routes[n] == {"tc": 0, "fma": 0, plan[n]: 1} for n in kattn.ROUTED)
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
    atol, rtol = FLASH_TOL[dtype]
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and got.shape == exp.shape
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [80, 112])
def test_fma_forward_and_dkv_in_bf16_match_plain(cuda, hd, causal):
    """The bf16 FMA forward and dk/dv at the head dims the tensor cores now
    take, launched directly (the private launchers, which count nothing),
    against their plain versions: out and lse at TOL, dk and dv at
    FLASH_TOL.  They stay the comparison the tensor-core kernels are timed
    against."""
    b, s, h, kv = 2, 129, 8, 2
    r = np.random.default_rng(hd + causal)
    q, k, v, dout = (torch.from_numpy(r.standard_normal(shape)).to(cuda, torch.bfloat16)
                     for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                                   (b, s, h, hd)))
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    ones = torch.ones_like(pos)
    kernels.reset_launch_counts()
    out, lse = kattn._chunk_launch("chunk_attention", q, k, v, pos, pos, ones, 40, 20.0,
                                   causal)
    delta = ref.flash_delta(out, dout)
    dk = torch.empty(k.shape, dtype=torch.float32, device=cuda)
    dv = torch.empty_like(dk)
    kattn._backward_launch("flash_dkv", q, k, v, dout, lse, delta, (dk, dv), 40, 20.0, causal,
                           "flash_dkv")
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values())
    kw = dict(window=40, softcap=20.0, causal=causal)
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, ones, **kw)
    _close(out, want_out, torch.bfloat16)
    _close(lse, want_lse, torch.bfloat16)
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    for got, exp in zip((dk, dv), want[1:]):
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", [
    # b, s, h, kv, hd, window, softcap, causal
    (2, 37, 4, 4, 80, None, None, False),     # n_rep 1, ragged S
    (1, 300, 8, 2, 80, 70, 30.0, False),      # n_rep 4, window + softcap
    (2, 129, 4, 4, 112, None, 20.0, False),   # n_rep 1, softcap
    (1, 300, 8, 2, 112, 50, None, False),     # n_rep 4, window across tiles
    (1, 129, 8, 2, 64, None, None, False),
    (2, 300, 4, 4, 64, 40, 15.0, False),
    (1, 129, 4, 4, 128, 30, None, False),
    (2, 37, 8, 2, 128, None, 30.0, False),
    (1, 300, 4, 4, 80, None, None, True),     # causal hd 80, n_rep 1
    (2, 129, 8, 2, 80, 40, 20.0, True),
    (1, 37, 4, 4, 112, None, 30.0, True),
    (1, 300, 8, 2, 112, 70, None, True),
    (2, 1024, 4, 4, 80, None, None, False),   # hubert's sequence, 4 heads
])
def test_tc_forward_and_dkv_at_new_forms(cuda, case):
    """The tensor-core chunk forward and dk/dv without causality at hd 64,
    80, 112 and 128 and with it at 80 and 112, n_rep 1 and 4, ragged S,
    windows and softcaps, against their plain versions (out and lse at TOL,
    dq, dk and dv at FLASH_TOL), each on the route its plan names (all three
    on the tensor cores), and dk/dv the same bits on two runs."""
    b, s, h, kv, hd, window, softcap, causal = case
    r = np.random.default_rng(s * 11 + hd + causal)
    kernels.reset_launch_counts()
    q, k, v, dout, out, lse = _flash_case(r, cuda, torch.bfloat16, b, s, h, kv, hd, window,
                                          softcap, causal)
    kw = dict(window=window, softcap=softcap, causal=causal)
    pos = torch.arange(s, device=cuda)
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, torch.ones_like(pos), **kw)
    _close(out, want_out, torch.bfloat16)
    _close(lse, want_lse, torch.bfloat16)
    delta = ref.flash_delta(out, dout)
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, **kw)
    runs = [kattn.flash_dkv(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    routes = kernels.route_counts()
    assert routes["chunk_attention"] == {"tc": 1, "fma": 0}
    assert routes["flash_dkv"] == {"tc": 2, "fma": 0}
    assert routes["flash_dq"] == {"tc": 1, "fma": 0}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    for got, exp in zip((dq, *runs[0]), want):
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", [
    # b, s, h, kv, hd, window, softcap, causal: a tp rank's heads
    (2, 512, 16, 2, 128, None, None, True),    # Yi-6B at T 2 (32/4 heads)
    (2, 512, 2, 1, 128, None, None, True),     # Yi-6B at T 16 (the KV head shared by 4)
    (1, 512, 16, 8, 128, 128, 50.0, True),     # gemma2-27b at T 2, window and softcap
    (2, 512, 8, 8, 80, None, None, False),     # hubert-xlarge at T 2, non-causal
], ids=["yi-t2", "yi-t16", "gemma2-t2", "hubert-t2"])
def test_flash_kernels_at_the_tensor_parallel_head_counts(cuda, case):
    """The chunk forward, dq and dk/dv in bf16 at the head counts a tensor-
    parallel rank of the full configs runs, against their plain versions
    (out and lse at TOL, dq, dk and dv at FLASH_TOL), all three on the
    tensor cores."""
    b, s, h, kv, hd, window, softcap, causal = case
    r = np.random.default_rng(s + h * 3 + kv)
    kernels.reset_launch_counts()
    q, k, v, dout, out, lse = _flash_case(r, cuda, torch.bfloat16, b, s, h, kv, hd, window,
                                          softcap, causal)
    kw = dict(window=window, softcap=softcap, causal=causal)
    pos = torch.arange(s, device=cuda)
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, torch.ones_like(pos), **kw)
    _close(out, want_out, torch.bfloat16)
    _close(lse, want_lse, torch.bfloat16)
    delta = ref.flash_delta(out, dout)
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = kattn.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(kernels.route_counts()[n] == {"tc": 1, "fma": 0} for n in kattn.ROUTED)
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    for got, exp in zip((dq, dk, dv), want):
        assert got.shape == exp.shape
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [80, 112])
def test_tc_chunk_forward_with_sentinel_keys_and_padded_rows(cuda, hd, causal):
    """A prefill chunk on the tensor cores at hd 80 and 112: a sentinel-padded
    prior table, 5 padded query rows, a window, n_rep 4; out and lse against
    the plain version at TOL, a padded row the mean of v over every key, and
    the same bits on a second run."""
    r = np.random.default_rng(hd * 3 + causal)
    args = list(_chunk_case(r, cuda, torch.bfloat16, 2, 70, 128, 90, 8, 2, hd))
    args[3][-5:] = -(2 ** 30)
    kernels.reset_launch_counts()
    runs = [kattn.chunk_attention_fwd(*args, window=30, causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.route_counts()["chunk_attention"] == {"tc": 2, "fma": 0}
    want, want_lse = ref.attention_ref_lse(*args, window=30, causal=causal)
    _close(runs[0][0], want, torch.bfloat16)
    _close(runs[0][1], want_lse, torch.bfloat16)
    assert (runs[0][1][:, :, -5:] < -1e29).all()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_16_on_the_fma_kernels(cuda, dtype, causal):
    """hd 16 (every reference ``reduced()`` config's head dim) on the FMA
    kernels: the chunk forward, dq and dk/dv against their plain versions
    (TOL, FLASH_TOL), with a window and a softcap, n_rep 2, ragged S."""
    b, s, h, kv, hd = 2, 45, 4, 2, 16
    r = np.random.default_rng(16 + causal)
    kernels.reset_launch_counts()
    q, k, v, dout, out, lse = _flash_case(r, cuda, dtype, b, s, h, kv, hd, 20, 15.0, causal)
    kw = dict(window=20, softcap=15.0, causal=causal)
    pos = torch.arange(s, device=cuda)
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, torch.ones_like(pos), **kw)
    _close(out, want_out, dtype)
    _close(lse, want_lse, dtype)
    delta = ref.flash_delta(out, dout)
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = kattn.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(kernels.route_counts()[n] == {"tc": 0, "fma": 1} for n in kattn.ROUTED)
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
    atol, rtol = FLASH_TOL[dtype]
    for got, exp in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


def test_noncausal_flash_attention_autograd_on_card_matches_cpu(cuda):
    """The autograd function without causality at hd 80 (hubert-xlarge's
    head dim): forward and the two backward kernels against the same
    function on the CPU, float32."""
    r = np.random.default_rng(5)
    arrays = [r.standard_normal(shape).astype(np.float32)
              for shape in ((2, 53, 4, 80), (2, 53, 4, 80), (2, 53, 4, 80))]
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays)
        out = kattn.flash_attention(q, k, v, False, None, None)
        out.square().sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)] + [out.detach().cpu()]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        _close(got, want, torch.float32)


def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    """The autograd function: forward kernel, then the two backward kernels,
    against the same function on the CPU (plain versions), float32."""
    r = np.random.default_rng(3)
    arrays = [r.standard_normal(shape).astype(np.float32)
              for shape in ((2, 45, 8, 64), (2, 45, 2, 64), (2, 45, 2, 64))]
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays)
        out = kattn.flash_attention(q, k, v, True, None, 15.0)
        out.square().sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)] + [out.detach().cpu()]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        _close(got, want, torch.float32)


def _autograd_on(dev, arrays, dtype, weights=None):
    """out, dq, dk, dv (float32, on the CPU) of ``sum(out**2)``, or of
    ``sum(out * weights)``, through ``flash_attention`` (softcap 15) on
    ``dev``."""
    q, k, v = (torch.from_numpy(a).to(dev, dtype).requires_grad_(True) for a in arrays)
    out = kattn.flash_attention(q, k, v, True, None, 15.0)
    if weights is None:
        out.float().square().sum().backward()
    else:
        out.backward(torch.from_numpy(weights).to(dev, dtype))
    return [x.float().cpu() for x in (out.detach(), q.grad, k.grad, v.grad)]


def test_flash_attention_autograd_repeated_on_card(cuda):
    """The float32 autograd case above 50 times in one process: out, dq, dk
    and dv within 1e-4 of the CPU every time, and the same bits every
    time."""
    r = np.random.default_rng(3)
    arrays = [r.standard_normal(shape).astype(np.float32)
              for shape in ((2, 45, 8, 64), (2, 45, 2, 64), (2, 45, 2, 64))]
    want = _autograd_on("cpu", arrays, torch.float32)
    first = None
    for _ in range(50):
        got = _autograd_on(cuda, arrays, torch.float32)
        for g, w in zip(got, want):
            _close(g, w, torch.float32)
        first = first or got
        assert all(torch.equal(a, b) for a, b in zip(got, first))


def test_flash_attention_autograd_bf16_on_card_matches_cpu(cuda):
    """The autograd function in bf16 (forward, dq and dk/dv on the tensor
    cores) against the same function on the CPU, under the
    loss ``sum(out * w)``: both devices backpropagate the same bf16 output
    gradient (``sum(out**2)`` would feed each its own rounding of out)."""
    r = np.random.default_rng(4)
    arrays = [r.standard_normal(shape).astype(np.float32)
              for shape in ((2, 130, 8, 128), (2, 130, 2, 128), (2, 130, 2, 128),
                            (2, 130, 8, 128))]
    w = arrays.pop()
    kernels.reset_launch_counts()
    got = _autograd_on(cuda, arrays, torch.bfloat16, w)
    assert kernels.route_counts()["chunk_attention"] == {"tc": 1, "fma": 0}
    assert kernels.route_counts()["flash_dkv"] == {"tc": 1, "fma": 0}
    assert kernels.route_counts()["flash_dq"] == {"tc": 1, "fma": 0}
    assert kernels.launch_counts()["flash_dq"] == 1
    for g, want in zip(got, _autograd_on("cpu", arrays, torch.bfloat16, w)):
        _close(g, want, torch.bfloat16)


@pytest.mark.parametrize("case", [
    # b, c, prior, off, h, kv, hd, window, softcap, padded rows
    (2, 45, 256, 200, 8, 2, 128, 50, 30.0, 0),    # C < 64, window across tiles
    (1, 70, 640, 100, 4, 4, 64, None, None, 0),   # sentinel-only tail tiles
    (1, 37, 32, 20, 8, 1, 128, 6, None, 5),       # padded rows, n_rep 8
    (2, 300, 640, 500, 32, 4, 128, 200, 20.0, 7),  # 128-row blocks, ragged
])
def test_chunk_tc_kernel_at_its_edges(cuda, case):
    """The tensor-core chunk forward against its plain version (out and lse
    at 2e-2) where it skips key tiles by position, on the tc route, and the
    same bits on a second run."""
    b, c, prior, off, h, kv, hd, window, softcap, pad = case
    r = np.random.default_rng(c + prior)
    args = list(_chunk_case(r, cuda, torch.bfloat16, b, c, prior, off, h, kv, hd))
    if pad:
        args[3][-pad:] = -(2 ** 30)
    kernels.reset_launch_counts()
    runs = [kattn.chunk_attention_fwd(*args, window=window, softcap=softcap) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.route_counts()["chunk_attention"] == {"tc": 2, "fma": 0}
    want, want_lse = ref.attention_ref_lse(*args, window=window, softcap=softcap)
    _close(runs[0][0], want, torch.bfloat16)
    _close(runs[0][1], want_lse, torch.bfloat16)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("hd", [64, 128])
def test_chunk_tc_kernel_shuffled_keys_and_a_row_without_keys(cuda, hd):
    """Keys out of position order at positions past the array bounds, and a
    live row whose window holds only invalid keys (it takes the mean of v
    over all keys, lse -1e30)."""
    r = np.random.default_rng(hd)
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(r, cuda, torch.bfloat16, 2, 90, 300, 250,
                                                 8, 2, hd)
    k_valid[300 + 20:300 + 23] = False  # row 22 sees only these within window 3
    perm = torch.from_numpy(r.permutation(k.shape[1])).to(cuda)
    k, v = k[:, perm].contiguous(), v[:, perm].contiguous()
    k_pos, k_valid = k_pos[perm] + 7000, k_valid[perm]
    q_pos = q_pos + 7000
    got, lse = kattn.chunk_attention_fwd(q, k, v, q_pos, k_pos, k_valid, window=3)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref_lse(q, k, v, q_pos, k_pos, k_valid, window=3)
    _close(got, want, torch.bfloat16)
    _close(lse, want_lse, torch.bfloat16)
    assert (lse[:, :, 22] < -1e29).all()


def test_chunk_tc_kernel_counts_the_key_tiles_it_visits(cuda):
    """Causal self-attention at S 512, 2 heads: too few blocks for 128-row
    ones to fill the card, so 64-row blocks, 8 a head, which list the
    128-key tiles up to their last row's (1, 1, 2, 2, 3, 3, 4, 4 of 4), as
    the kernel's own counters show; a reset zeroes them."""
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 512, n, 64))).to(cuda, torch.bfloat16)
               for n in (2, 1, 1))
    pos = torch.arange(512, device=cuda, dtype=torch.int32)
    kattn.tc_key_tiles(reset=True)
    kattn.chunk_attention_fwd(q, k, v, pos, pos, torch.ones_like(pos))
    assert kattn.tc_key_tiles(reset=True) == (2 * 20, 2 * 32)
    assert kattn.tc_key_tiles() == (0, 0)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.float32, 128, "fma"), (torch.bfloat16, 32, "fma"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc")])
def test_attention_routes_on_card(cuda, dtype, hd, route):
    """The chunk forward, dq and dk/dv launch the library their plan names,
    and dq and dk/dv give the same bits on a second run (no atomics on
    either route)."""
    r = np.random.default_rng(hd)
    q, k, v, dout, out, lse = _flash_case(r, cuda, dtype, 1, 150, 8, 2, hd, None, 10.0)
    delta = ref.flash_delta(out, dout)
    kernels.reset_launch_counts()
    dqs = [kattn.flash_dq(q, k, v, dout, lse, delta, softcap=10.0) for _ in range(2)]
    runs = [kattn.flash_dkv(q, k, v, dout, lse, delta, softcap=10.0) for _ in range(2)]
    pos = torch.arange(150, device=cuda, dtype=torch.int32)
    kattn.chunk_attention_fwd(q, k, v, pos, pos, torch.ones_like(pos))
    torch.cuda.synchronize()
    other = "fma" if route == "tc" else "tc"
    assert kernels.route_counts()["flash_dkv"] == {route: 2, other: 0}
    assert kernels.route_counts()["flash_dq"] == {route: 2, other: 0}
    assert kernels.route_counts()["chunk_attention"] == {route: 1, other: 0}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(*dqs)
    want = ref.flash_backward_ref(q, k, v, out, lse, dout, softcap=10.0)
    atol, rtol = FLASH_TOL[dtype]
    for got, exp in zip((dqs[0], *runs[0]), want):
        torch.testing.assert_close(got.cpu(), exp.float().cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", [
    # s, hd, n_rep, window, softcap
    *((s, hd, n_rep, None, None) for s in (1, 63, 64, 65, 129, 300)
      for hd, n_rep in ((64, 1), (128, 2), (128, 8))),
    (300, 128, 2, 70, None),   # a window across tiles
    (200, 64, 8, None, 20.0),  # softcap
    (150, 128, 4, 40, 20.0),   # both
])
def test_flash_dq_tc_at_its_edges(cuda, case):
    """dq on the tensor cores (bf16) against its plain version at 2e-3: a
    single row, ragged and whole 64-row tiles, 128-row blocks whose second
    warpgroup has no row, n_rep 1, 2 and 8, a window, a softcap; the tc route
    only, and the same bits on a second run."""
    s, hd, n_rep, window, softcap = case
    kv = 8 // n_rep if n_rep < 8 else 1
    r = np.random.default_rng(s * 3 + hd + n_rep)
    q, k, v, dout, out, lse = _flash_case(r, cuda, torch.bfloat16, 2, s, kv * n_rep, kv, hd,
                                          window, softcap)
    delta = ref.flash_delta(out, dout)
    kernels.reset_launch_counts()
    runs = [kattn.flash_dq(q, k, v, dout, lse, delta, window=window, softcap=softcap)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.route_counts()["flash_dq"] == {"tc": 2, "fma": 0}
    assert torch.equal(runs[0], runs[1])
    want = ref.flash_grads_ref(q, k, v, lse, delta, dout, window=window, softcap=softcap)[0]
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(runs[0].cpu(), want.float().cpu(), atol=atol, rtol=rtol)


# (s, hd, n_rep, window, softcap) for dq on the tensor cores at every head
# dim and either causality: ragged S 77 and 1000, n_rep 1, 2 and 8, windows
# across tiles (one-sided without causality), softcaps
DQ_TC_FORMS = [(s, hd, n_rep, window, softcap)
               for hd in (64, 80, 112, 128)
               for s, n_rep, window, softcap in ((77, 1, None, None), (1000, 2, None, 20.0),
                                                 (77, 8, 30, None), (1000, 1, 300, 30.0))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", DQ_TC_FORMS)
def test_flash_dq_tc_at_every_form(cuda, case, causal):
    """dq on the tensor cores (bf16) at hd 64, 80, 112 and 128, causal or
    not, against its plain version at FLASH_TOL and against the FMA dq
    (``csrc/flash_dq.cu``, launched directly) at the same call at
    FLASH_TOL; the tc route only, and the same bits on a second run."""
    s, hd, n_rep, window, softcap = case
    kv = 8 // n_rep if n_rep < 8 else 1
    r = np.random.default_rng(s * 3 + hd + n_rep + causal)
    q, k, v, dout, out, lse = _flash_case(r, cuda, torch.bfloat16, 1, s, kv * n_rep, kv, hd,
                                          window, softcap, causal)
    delta = ref.flash_delta(out, dout)
    kw = dict(window=window, softcap=softcap, causal=causal)
    kernels.reset_launch_counts()
    runs = [kattn.flash_dq(q, k, v, dout, lse, delta, **kw) for _ in range(2)]
    fma = torch.empty_like(runs[0])
    kattn._backward_launch("flash_dq", q, k, v, dout, lse, delta, (fma,), window, softcap,
                           causal, "flash_dq")
    torch.cuda.synchronize()
    assert kernels.route_counts()["flash_dq"] == {"tc": 2, "fma": 0}
    assert torch.equal(runs[0], runs[1])
    want = ref.flash_grads_ref(q, k, v, lse, delta, dout, **kw)[0]
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(runs[0].cpu(), want.float().cpu(), atol=atol, rtol=rtol)
    torch.testing.assert_close(fma.cpu(), want.float().cpu(), atol=atol, rtol=rtol)
    torch.testing.assert_close(runs[0].cpu(), fma.cpu(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal", [True, False])
def test_chunk_forward_above_the_tc_key_cap(cuda, causal):
    """A bf16 chunk forward over 65537 keys (hd 128, a 16-row query chunk at
    the end of the context), past what the tensor-core kernel's tile list
    holds, is planned onto the FMA kernel and matches its plain version
    instead of raising."""
    sk, c, h, kv, hd = kattn.TC_MAX_KEYS + 1, 16, 4, 2, 128
    r = np.random.default_rng(sk)
    q = torch.from_numpy(r.standard_normal((1, c, h, hd))).to(cuda, torch.bfloat16)
    k = torch.from_numpy(r.standard_normal((1, sk, kv, hd))).to(cuda, torch.bfloat16)
    v = torch.from_numpy(r.standard_normal((1, sk, kv, hd))).to(cuda, torch.bfloat16)
    k_pos = torch.arange(sk, device=cuda)
    q_pos = k_pos[-c:]
    valid = torch.ones(sk, dtype=torch.bool, device=cuda)
    kernels.reset_launch_counts()
    out, lse = kattn.chunk_attention_fwd(q, k, v, q_pos, k_pos, valid, causal=causal)
    torch.cuda.synchronize()
    assert kernels.route_counts()["chunk_attention"] == {"tc": 0, "fma": 1}
    want_out, want_lse = ref.attention_ref_lse(q, k, v, q_pos, k_pos, valid, causal=causal)
    _close(out, want_out, torch.bfloat16)
    _close(lse, want_lse, torch.bfloat16)


def test_flash_backward_refusals(cuda):
    r = np.random.default_rng(8)
    q, k, v, dout, out, lse = _flash_case(r, cuda, torch.float32, 1, 8, 4, 2, 32,
                                          None, None)
    delta = ref.flash_delta(out, dout)
    kernels.reset_launch_counts()
    half = [t.half() for t in (q, k, v, dout)]
    with pytest.raises(TypeError, match="dtype"):
        kattn.flash_dq(*half, lse, delta)
    with pytest.raises(TypeError, match="dtype"):
        kattn.flash_dkv(*half, lse, delta)
    bad = torch.zeros((1, 8, 4, 48), device=cuda)  # no head-dim-48 instance
    stat = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kattn.flash_dq(bad, bad[:, :, :2], bad[:, :, :2], bad, stat, stat)
    with pytest.raises(ValueError, match="head dim"):
        kattn.flash_dkv(bad, bad[:, :, :2], bad[:, :, :2], bad, stat, stat)
    with pytest.raises(ValueError, match="Queue B 2"):
        kattn.flash_dq(bad, bad[:, :, :2], bad[:, :, :2], bad, stat, stat, causal=False)
    assert kattn.flash_dq.launches == 0 and kattn.flash_dkv.launches == 0
    # the non-causal form, once refused here, runs on the FMA kernels
    got = kattn.flash_attention(q, k, v, causal=False)
    pos = torch.arange(8, device=cuda)
    _close(got, ref.attention_ref(q, k, v, pos, pos, torch.ones_like(pos), causal=False),
           torch.float32)
    assert kernels.route_counts()["chunk_attention"] == {"tc": 0, "fma": 1}


def test_engine_on_card_matches_cpu(cuda):
    """Reduced Yi-6B in float32 with identical weights: the card (kernels)
    and the CPU (plain versions) give the same greedy tokens."""
    cfg = get_config("yi-6b", reduced=True).replace(d_model=256, num_heads=4,
                                                    num_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    cpu_params = tf.init_params(cfg, gen, "cpu")
    card_params = tf.init_params(cfg, torch.Generator(device=cuda), cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=8) for n in (5, 30, 17)]
    kw = dict(max_slots=4, max_seq=64, prefill_chunk=16, block_size=8)
    kernels.reset_launch_counts()
    out_card = ServeEngine(cfg, card_params, device=cuda, **kw).generate(reqs)
    counts = kernels.launch_counts()
    out_cpu = ServeEngine(cfg, cpu_params, device="cpu", **kw).generate(reqs)
    assert [o.tokens.tolist() for o in out_card] == [o.tokens.tolist() for o in out_cpu]
    assert counts["chunk_attention"] > 0 and counts["paged_decode_attention"] > 0


@pytest.mark.parametrize("b", [1, 2, 4])
def test_paged_decode_at_the_rank_row_counts(cuda, b):
    """Paged decode at a rank's share of a bucket on a rank rung (B 1, 2, 4)
    at Yi-6B's serving shape (32/4 heads of hd 128, bf16, block 16, 192
    table entries, ragged lengths): within TOL of the plain version; the
    split count ``decode_plan`` picks for each B is printed."""
    r = np.random.default_rng(40 + b)
    blk, n_max, kv, h, hd, dtype = 16, 192, 4, 32, 128, torch.bfloat16
    nb = 1 + b * n_max
    ids = list(range(1, nb))
    r.shuffle(ids)
    tables = np.zeros((b, n_max), np.int32)
    lens = r.integers(1, n_max * blk + 1, size=b).astype(np.int32)
    for row, n in enumerate(lens):
        live = -(-int(n) // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    args = (q, pool_k, pool_v, torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda))
    got = kattn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = kattn.paged_decode_attention.splits
    print(f"B {b}: decode_plan {splits} splits")
    assert splits == kattn.decode_plan(b, kv, n_max, blk, sms)
    _close(got, ref.paged_decode_ref(*args), dtype)


def test_local_ladder_engine_on_card_matches_cpu(cuda):
    """Reduced Yi-6B (float32) served on ``elastic=MeshLadder()``, eight
    virtual devices of the card, gives the same greedy tokens, rungs and
    reshards as the same ladder over eight CPU entries."""
    from repro_torch.elastic import MeshLadder

    cfg = get_config("yi-6b", reduced=True).replace(d_model=256, num_heads=4,
                                                    num_kv_heads=2)
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = tf.init_params(cfg, torch.Generator(device=cuda), cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=m) for n, m in ((5, 20), (30, 8), (17, 8), (9, 6), (3, 6))]
    kw = dict(max_slots=8, max_seq=64, prefill_chunk=16, block_size=8)
    card = ServeEngine(cfg, card_params, elastic=MeshLadder(granule=1), **kw)
    cpu = ServeEngine(cfg, cpu_params, elastic=MeshLadder(["cpu"] * 8, granule=1), **kw)
    assert card.device.type == "cuda"
    out_card, out_cpu = card.generate(reqs), cpu.generate(reqs)
    assert [o.tokens.tolist() for o in out_card] == [o.tokens.tolist() for o in out_cpu]
    assert card.stats.rungs == cpu.stats.rungs and card.stats.reshards == cpu.stats.reshards
    assert len(set(card.stats.rungs)) >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1024, 6144])
def test_chunk_kernel_over_a_ring_gathered_prior(cuda, dtype, offset):
    """gemma2's local prefill: a 256-row chunk over a 4096-key ring read in
    chronological order (positions ``offset - 4096 ..``, the negative ones
    invalid) then the chunk's own keys, window 4096, softcap 50, 32/16 heads
    of hd 128; at offset 6144 the window cuts every row's oldest keys."""
    r = np.random.default_rng(offset)
    c, s_c, h, kv, hd = 256, 4096, 32, 16, 128
    q = torch.from_numpy(r.standard_normal((1, c, h, hd))).to(cuda, dtype)
    k = torch.from_numpy(r.standard_normal((1, s_c + c, kv, hd))).to(cuda, dtype)
    v = torch.from_numpy(r.standard_normal((1, s_c + c, kv, hd))).to(cuda, dtype)
    q_pos = offset + torch.arange(c, dtype=torch.int32, device=cuda)
    prior = offset - s_c + torch.arange(s_c, dtype=torch.int32, device=cuda)
    k_pos = torch.cat([prior, q_pos])
    k_valid = torch.cat([(prior >= 0).to(torch.int32),
                         torch.ones(c, dtype=torch.int32, device=cuda)])
    kernels.reset_launch_counts()
    got = kattn.chunk_attention(q, k, v, q_pos, k_pos, k_valid, window=4096, softcap=50.0)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, q_pos, k_pos, k_valid, window=4096, softcap=50.0)
    _close(got, want, dtype)
    route = "tc" if dtype == torch.bfloat16 else "fma"
    assert kernels.route_counts()["chunk_attention"][route] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(32, 16), (28, 4), (128, 8)],
                         ids=["n_rep2", "n_rep7", "n_rep16"])
def test_paged_decode_softcap_at_the_dense_group_sizes(cuda, dtype, h, kv):
    """Softcap 50 at hd 128 with gemma2's n_rep 2, qwen2's 7 and llama3's
    16 (n_rep * hd = 2048, the kernel's ``DECODE_MAX_GROUP``)."""
    r = np.random.default_rng(h)
    b, blk, n_max, hd = 4, 16, 40, 128
    nb = n_max * b + 1
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    lengths = np.asarray([1, 300, n_max * blk, 77], np.int32)
    tables = np.zeros((b, n_max), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)
    for row, n in enumerate(lengths):
        live = -(-int(n) // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    args = (q, pool_k, pool_v, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(lengths).to(cuda))
    got = kattn.paged_decode_attention(*args, softcap=50.0)
    torch.cuda.synchronize()
    _close(got, ref.paged_decode_ref(*args, softcap=50.0), dtype)


def test_gemma2_engine_on_card_matches_cpu(cuda):
    """Reduced gemma2 (window 8, both softcaps) in float32 with identical
    weights: the card (kernels) and the CPU (plain versions) give the same
    greedy tokens, rings wrapping in prefill and decode, a full-prompt hit
    replaying its cached rings."""
    cfg = get_config("gemma2-27b", reduced=True)
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = tf.build(cfg, cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 30, 17)]
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts + [prompts[1]]]
    kw = dict(max_slots=2, max_seq=64, prefill_chunk=16, block_size=8)
    kernels.reset_launch_counts()
    card = ServeEngine(cfg, card_params, device=cuda, **kw)
    out_card = card.generate(reqs)
    counts = kernels.launch_counts()
    cpu = ServeEngine(cfg, cpu_params, device="cpu", **kw)
    out_cpu = cpu.generate(reqs)
    assert [o.tokens.tolist() for o in out_card] == [o.tokens.tolist() for o in out_cpu]
    assert card.stats.shared_prefill_hits == cpu.stats.shared_prefill_hits == 1
    assert counts["chunk_attention"] == 2 * card.stats.prefill_chunks
    assert counts["paged_decode_attention"] == card.stats.steps


def test_training_on_card_matches_cpu(cuda):
    """Reduced Yi-6B (hd 64, remat on) in float32 with identical weights:
    4 steps of ``StepEngine.for_lm(attn_impl="pallas")`` with a tick-fired
    DiveBatch program on the card (kernels) and on the CPU (plain
    versions) give the same losses, parameters and batch schedule."""
    from repro_torch.launch import train_lm

    cfg = get_config("yi-6b", reduced=True).replace(d_model=256, num_heads=4,
                                                    num_kv_heads=2, remat=True)
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card_params = tf.build(cfg, cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    outs, counts = {}, {}
    for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
        program = train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        kernels.reset_launch_counts()
        outs[dev] = train_lm.train(cfg, params, program, steps=4, seq_len=32,
                                   micro_batch=2, log=lambda line: None)
        counts[dev] = kernels.launch_counts()
    np.testing.assert_allclose([r["loss"] for r in outs["cuda"]["records"]],
                               [r["loss"] for r in outs["cpu"]["records"]], rtol=1e-4)
    for a, b in zip(card_params.parameters(), cpu_params.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4)
    assert ([r["batch"] for r in outs["cuda"]["records"]]
            == [r["batch"] for r in outs["cpu"]["records"]])
    n_micro = sum(r["num_micro"] for r in outs["cuda"]["records"])
    assert counts["cuda"] == {"chunk_attention": 2 * 2 * n_micro,
                              "paged_decode_attention": 0,
                              "flash_dq": 2 * n_micro, "flash_dkv": 2 * n_micro,
                              "psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0,
                              "psgn_split": 0, "quantize_int8": 0}
    assert not any(counts["cpu"].values())


# (B, S, Din, Dout): ragged widths and S, one position, a tile edge, and the
# slice's k/v width at a short S
PSGN_CASES = [(2, 64, 32, 48), (1, 37, 19, 23), (4, 33, 7, 130), (1, 300, 130, 260),
              (3, 1, 5, 9), (2, 128, 128, 128), (1, 200, 512, 64)]
PSGN_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32)]


def _psgn_pair(r, dev, shape, dtypes):
    *lead, s, d_in, d_out = shape
    x = torch.from_numpy(r.standard_normal((*lead, s, d_in))).to(dev, dtypes[0])
    d = torch.from_numpy(r.standard_normal((*lead, s, d_out))).to(dev, dtypes[1])
    return x, d


@pytest.mark.parametrize("dtypes", PSGN_DTYPES, ids=["f32", "bf16", "bf16-f32"])
@pytest.mark.parametrize("shape", PSGN_CASES)
def test_psgn_kernels_match_plain(cuda, shape, dtypes):
    """direct, gram and fused (3 stacked layers) against their plain versions
    on the same inputs, each one launch; two runs give the same bits."""
    r = np.random.default_rng(sum(shape))
    x, d = _psgn_pair(r, cuda, shape, dtypes)
    xs, ds = _psgn_pair(r, cuda, (3, *shape), dtypes)
    kernels.reset_launch_counts()
    got = {"direct": psgn.psgn_direct(x, d), "gram": psgn.psgn_gram(x, d),
           "fused": psgn.psgn_fused(xs, ds)}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["psgn_direct"], counts["psgn_gram"], counts["psgn_fused"]) == (1, 1, 1)
    want = {"direct": ref.psgn_ref(x, d), "gram": ref.psgn_gram_ref(x, d),
            "fused": ref.psgn_fused_ref(xs, ds)}
    for name, val in got.items():
        assert val.dtype == torch.float32 and val.shape == (shape[0],)
        torch.testing.assert_close(val.cpu(), want[name].cpu(), rtol=1e-4, atol=0)
    assert torch.equal(psgn.psgn_gram(x, d), got["gram"])
    assert torch.equal(psgn.psgn_fused(xs, ds), got["fused"])


def test_psgn_kernels_at_the_slice_shapes(cuda):
    """Yi-6B's gram-tier launches at S 2048, bf16: the fused k/v group (16
    layers, 4096 -> 512) and the gram gate/up layer (4096 -> 11008)."""
    r = np.random.default_rng(1)
    xs, ds = _psgn_pair(r, cuda, (16, 2, 2048, 4096, 512), (torch.bfloat16,) * 2)
    torch.testing.assert_close(psgn.psgn_fused(xs, ds).cpu(),
                               ref.psgn_fused_ref(xs, ds).cpu(), rtol=1e-4, atol=0)
    del xs, ds
    x, d = _psgn_pair(r, cuda, (2, 2048, 4096, 11008), (torch.bfloat16,) * 2)
    torch.testing.assert_close(psgn.psgn_gram(x, d).cpu(), ref.psgn_ref(x, d).cpu(),
                               rtol=1e-4, atol=0)


def test_psgn_refusals(cuda):
    r = np.random.default_rng(3)
    x, d = _psgn_pair(r, cuda, (2, 16, 8, 8), (torch.float32,) * 2)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        psgn.psgn_direct(x.half(), d)
    with pytest.raises(TypeError, match="dtype"):
        psgn.psgn_gram(x, d.half())
    with pytest.raises(ValueError, match="contiguous"):
        psgn.psgn_direct(x.transpose(0, 1), d.transpose(0, 1))
    with pytest.raises(ValueError, match="4-D"):
        psgn.psgn_fused(x, d)
    assert not any(kernels.launch_counts().values())


# (L, B, S, Din, Dout) on the tensor-core route (bf16, widths multiples of
# 8): S of 1, 37, 300 and 2049 (a 64-position stage, a 128-position tile
# and their ragged ends), widths 8, 136, 264 and 4104 (one box, ragged
# 128- and 256-wide tiles), L 1 and 3
PSGN_TC_CASES = [(1, 2, 1, 8, 8), (3, 2, 37, 136, 264), (1, 1, 300, 264, 136),
                 (3, 1, 2049, 8, 4104), (1, 2, 2049, 4104, 264), (3, 2, 300, 4104, 8)]


@pytest.mark.parametrize("case", PSGN_TC_CASES)
def test_psgn_tensor_core_route_at_ragged_edges(cuda, case):
    """direct, gram, fused (stacked) and the layer table against their plain
    versions within 1e-4 relative, every launch on the tensor-core route;
    a second run gives the same bits."""
    n_l, *shape = case
    r = np.random.default_rng(sum(case))
    xs, ds = _psgn_pair(r, cuda, (n_l, *shape), (torch.bfloat16,) * 2)
    x, d = xs[0], ds[0]
    kernels.reset_launch_counts()
    runs = [{"direct": psgn.psgn_direct(x, d), "gram": psgn.psgn_gram(x, d),
             "fused": psgn.psgn_fused(xs, ds),
             "layers": psgn.psgn_fused_layers(list(xs), list(ds))} for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.route_counts() == {"chunk_attention": {"tc": 0, "fma": 0},
                                      "flash_dq": {"tc": 0, "fma": 0},
                                      "flash_dkv": {"tc": 0, "fma": 0},
                                      "psgn_direct": {"tc": 2, "split": 0, "fma": 0},
                                      "psgn_gram": {"tc": 2, "split": 0, "fma": 0},
                                      "psgn_fused": {"tc": 4, "split": 0, "fma": 0}}
    want = {"direct": ref.psgn_ref(x, d), "gram": ref.psgn_gram_ref(x, d),
            "fused": ref.psgn_fused_ref(xs, ds), "layers": ref.psgn_fused_ref(xs, ds)}
    for name, val in runs[0].items():
        assert val.dtype == torch.float32 and val.shape == (shape[0],)
        torch.testing.assert_close(val.cpu(), want[name].cpu(), rtol=1e-4, atol=0)
        assert torch.equal(val, runs[1][name]), name


def _fma_direct(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The float32 FMA direct kernel (``csrc/psgn_direct.cu``) on stacked
    (L, B, S, .) x and d, whatever route ``plan`` would give them."""
    n_l, b, s, d_in = x.shape
    d_out = d.shape[-1]
    n_partials = n_l * -(-d_in // psgn.TILE) * -(-d_out // psgn.TILE)
    return psgn._fma_launch("psgn_direct", x, d, (n_l, b, s, d_in, d_out), n_partials)


def _fma_gram(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The float32 FMA gram kernel (``csrc/psgn_gram.cu``) on (B, S, .) x and
    d, whatever route ``plan`` would give them."""
    n_t = -(-x.shape[1] // psgn.TILE)
    return psgn._fma_launch("psgn_gram", x, d, (*x.shape, d.shape[-1]), n_t * (n_t + 1) // 2)


@pytest.mark.parametrize("shape", [(2, 300, 136, 264), (1, 2049, 264, 4104)])
def test_psgn_routes_agree(cuda, shape):
    """The same bf16 values through every route: as bf16 (tensor cores),
    with delta cast to float32 (direct, gram and fused on the split route)
    and through the FMA direct and gram kernels, within 1e-4 relative.  bf16
    values split into (v, 0, 0), so the split route here is the tensor-core
    product plus zero products."""
    r = np.random.default_rng(sum(shape))
    xs, ds = _psgn_pair(r, cuda, (3, *shape), (torch.bfloat16,) * 2)
    ds32 = ds.float()
    kernels.reset_launch_counts()
    for fn, x, d, d32 in ((psgn.psgn_direct, xs[0], ds[0], ds32[0]),
                          (psgn.psgn_gram, xs[0], ds[0], ds32[0]),
                          (psgn.psgn_fused, xs, ds, ds32)):
        torch.testing.assert_close(fn(x, d).cpu(), fn(x, d32).cpu(), rtol=1e-4, atol=0)
    assert kernels.route_counts() == {
        "chunk_attention": {"tc": 0, "fma": 0}, "flash_dq": {"tc": 0, "fma": 0},
        "flash_dkv": {"tc": 0, "fma": 0},
        **{name: {"tc": 1, "split": 1, "fma": 0}
           for name in ("psgn_direct", "psgn_gram", "psgn_fused")}}
    torch.testing.assert_close(psgn.psgn_fused(xs, ds32).cpu(), _fma_direct(xs, ds32).cpu(),
                               rtol=1e-4, atol=0)
    torch.testing.assert_close(psgn.psgn_gram(xs[0], ds32[0]).cpu(),
                               _fma_gram(xs[0].float(), ds32[0]).cpu(), rtol=1e-4, atol=0)


# (L, B, S, Din, Dout) on the split route: L 1, 3 and 16, ragged S (a
# 64-position stage's and a 128-position tile's ends), widths up to 4104
PSGN_SPLIT_CASES = [(1, 2, 37, 136, 264), (3, 1, 300, 264, 136), (3, 2, 2049, 8, 4104),
                    (16, 2, 129, 136, 64), (1, 1, 2049, 4104, 264)]
PSGN_SPLIT_DTYPES = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
                     (torch.float32, torch.float32)]


@pytest.mark.parametrize("dtypes", PSGN_SPLIT_DTYPES, ids=["bf16-f32", "f32-bf16", "f32-f32"])
@pytest.mark.parametrize("case", PSGN_SPLIT_CASES)
def test_psgn_split_route_against_fma(cuda, case, dtypes):
    """direct (L 1) or fused (stacked) and the layer table on the split
    route, against the FMA direct kernel on the same float32 values and
    against the plain version, within 1e-4 relative: every float32 operand
    split once per call, the same bits on a second run and through the
    table."""
    n_l, *shape = case
    r = np.random.default_rng(sum(case))
    xs, ds = _psgn_pair(r, cuda, (n_l, *shape), dtypes)
    kernels.reset_launch_counts()
    runs = [psgn.psgn_direct(xs[0], ds[0]) if n_l == 1 else psgn.psgn_fused(xs, ds)
            for _ in range(2)]
    table = psgn.psgn_fused_layers(list(xs), list(ds))
    torch.cuda.synchronize()
    routes = kernels.route_counts()
    direct = 2 if n_l == 1 else 0
    assert routes["psgn_direct"] == {"tc": 0, "split": direct, "fma": 0}
    assert routes["psgn_fused"] == {"tc": 0, "split": 3 - direct, "fma": 0}
    n_f32 = sum(dt == torch.float32 for dt in dtypes)
    assert kernels.launch_counts()["psgn_split"] == 3 * n_f32
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], table)
    want = ref.psgn_fused_ref(xs, ds).cpu()
    torch.testing.assert_close(runs[0].cpu(), want, rtol=1e-4, atol=0)
    torch.testing.assert_close(runs[0].cpu(), _fma_direct(xs.float(), ds.float()).cpu(),
                               rtol=1e-4, atol=0)


# (B, S, Din, Dout) for gram on the split route: ragged S (a 128-position
# tile's end, one position), widths up to 4104
PSGN_GRAM_SPLIT_CASES = [(2, 37, 136, 264), (1, 300, 264, 136), (3, 1, 8, 16),
                         (1, 2049, 4104, 264)]


@pytest.mark.parametrize("dtypes", PSGN_SPLIT_DTYPES, ids=["bf16-f32", "f32-bf16", "f32-f32"])
@pytest.mark.parametrize("shape", PSGN_GRAM_SPLIT_CASES)
def test_psgn_gram_split_route(cuda, shape, dtypes):
    """gram on the split route (each float32 operand split once, its Gram
    summed over 6 term pairs on the tensor cores) against the split
    route's plain version, the float32 plain Gram and the FMA gram kernel
    on the same values, within 1e-4 relative; the same bits on a second
    run."""
    r = np.random.default_rng(sum(shape) + 17)
    x, d = _psgn_pair(r, cuda, shape, dtypes)
    kernels.reset_launch_counts()
    runs = [psgn.psgn_gram(x, d) for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.route_counts()["psgn_gram"] == {"tc": 0, "split": 2, "fma": 0}
    n_f32 = sum(dt == torch.float32 for dt in dtypes)
    assert kernels.launch_counts()["psgn_split"] == 2 * n_f32
    assert torch.equal(runs[0], runs[1])
    for want in (ref.psgn_gram_split_ref(x, d), ref.psgn_gram_ref(x, d),
                 _fma_gram(x.float(), d.float())):
        torch.testing.assert_close(runs[0].cpu(), want.cpu(), rtol=1e-4, atol=0)


def test_psgn_split_kernel_matches_plain_bit_for_bit(cuda):
    """The split kernel against ``ref.split_bf16`` (on the card and on the
    CPU) bit for bit: random values over 2^-100 .. 2^100, every power of
    two, +-0, FLT_MAX, subnormals, inf, -inf and NaNs; 70 tensors in one
    call (two launches of the 64-source table)."""
    r = np.random.default_rng(7)
    f = np.finfo(np.float32)
    special = np.concatenate([np.exp2(np.arange(-149, 128.0)), [0.0, -0.0, f.max, -f.max,
                                                               np.inf, -np.inf, np.nan]])
    sub = r.integers(1, 1 << 23, 1000).astype(np.uint32).view(np.float32)
    n = 4096
    vals = [np.resize(np.concatenate([special, sub, -sub]), n).astype(np.float32)]
    vals += [(r.standard_normal(n) * np.exp2(r.uniform(-100, 100, n))).astype(np.float32)
             for _ in range(69)]
    xs = [torch.from_numpy(v).to(cuda) for v in vals]
    xs[1] = torch.tensor([0x7F800001, 0x7FC00000, 0xFF800123 - (1 << 32), 0x7F80FFFF] * (n // 4),
                         dtype=torch.int32).view(torch.float32).to(cuda)  # NaN payloads
    kernels.reset_launch_counts()
    got = psgn.psgn_split(xs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["psgn_split"] == 1
    assert got.shape == (3, 70, n) and got.dtype == torch.bfloat16
    for i, x in enumerate(xs):
        want = ref.split_bf16(x)
        assert torch.equal(got[:, i].view(torch.int16), want.view(torch.int16)), i
        assert torch.equal(want.cpu().view(torch.int16),
                           ref.split_bf16(x.cpu()).view(torch.int16)), i
    with pytest.raises(ValueError, match="multiple of 8"):
        psgn.psgn_split([xs[2][:12]])
    assert kernels.launch_counts()["psgn_split"] == 1


@pytest.mark.parametrize("n_l", [2, 40])
def test_psgn_layer_table_matches_stacked_launch(cuda, n_l):
    """``psgn_fused_layers`` (one TMA map per layer, 32 layers per launch:
    40 takes two) gives the same bits as ``psgn_fused`` on the stacked
    layers, and as ``persample_sq_norm_tree``'s group."""
    from repro_torch.kernels import ops
    r = np.random.default_rng(n_l)
    xs, ds = _psgn_pair(r, cuda, (n_l, 2, 100, 136, 64), (torch.bfloat16,) * 2)
    stacked = psgn.psgn_fused(xs, ds)
    table = psgn.psgn_fused_layers(list(xs), list(ds))
    tree = ops.persample_sq_norm_tree({f"l{i}": xs[i] for i in range(n_l)},
                                      {f"l{i}": ds[i] for i in range(n_l)})
    assert torch.equal(stacked, table) and torch.equal(stacked, tree)
    torch.testing.assert_close(stacked.cpu(), ref.psgn_fused_ref(xs, ds).cpu(),
                               rtol=1e-4, atol=0)


@pytest.mark.parametrize("tier", ["gram", "exact"])
def test_gram_tier_training_on_card_matches_cpu(cuda, tier):
    """Reduced Yi-6B (hd 64, d_ff 1024) in float32 with identical weights at
    S 128, where every layer takes the dispatch Yi-6B takes at S 2048: 4
    steps of a hand-built engine on the gram tier (or the exact tier's
    kernel path, which adds the bias terms), the kernel attention lane in
    the main pass, with a tick-fired DiveBatch program reading that tier's
    signals, on the card (kernels) and on the CPU (plain versions).  Losses,
    Delta and parameters within 1e-4, one batch schedule, and the card's
    psgn launches per microbatch exactly 2 fused and 3 * layers gram, all
    on the split route, each splitting its x and delta once."""
    from repro_torch.launch import train_lm
    from repro_torch.models import probes
    from repro_torch.optim import sgd
    from repro_torch.train import StepEngine, lm_bucket_of, make_train_step

    cfg = get_config("yi-6b", reduced=True).replace(d_model=256, num_heads=4,
                                                    num_kv_heads=2, d_ff=1024,
                                                    remat=True, attn_impl="pallas")
    seq = 128
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card_params = tf.build(cfg, cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    outs, counts = {}, {}
    for dev, params in (("cuda", card_params), ("cpu", cpu_params)):
        opt = sgd(momentum=0.9)
        eng = StepEngine(
            lambda n, tier, *, dev=dev, opt=opt: make_train_step(
                cfg, opt, n, estimator=tier, psn_impl="kernel",
                probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                probe_specs=lambda p, bsz: probes.probe_specs(cfg, bsz, seq, device=dev)),
            lm_bucket_of(2))
        eng.tier = tier
        program = train_lm.make_program("divebatch", m0=4, m_max=8, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        kernels.reset_launch_counts()
        outs[dev] = train_lm.train(cfg, params, program, steps=4, seq_len=seq,
                                   micro_batch=2, engine=eng, estimator=tier,
                                   log=lambda line: None)
        counts[dev] = kernels.launch_counts()
        if dev == "cuda":
            assert kernels.route_counts()["psgn_fused"]["split"] == counts[dev]["psgn_fused"]
            assert kernels.route_counts()["psgn_gram"]["split"] == counts[dev]["psgn_gram"]
    recs = {d: o["records"] for d, o in outs.items()}
    np.testing.assert_allclose([r["loss"] for r in recs["cuda"]],
                               [r["loss"] for r in recs["cpu"]], rtol=1e-4)
    np.testing.assert_allclose([r["diversity"] for r in recs["cuda"] if "diversity" in r],
                               [r["diversity"] for r in recs["cpu"] if "diversity" in r],
                               rtol=1e-4)
    for a, b in zip(card_params.parameters(), cpu_params.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-4)
    assert [r["batch"] for r in recs["cuda"]] == [r["batch"] for r in recs["cpu"]]
    n_micro = sum(r["num_micro"] for r in recs["cuda"])
    assert counts["cuda"] == {"chunk_attention": 2 * 2 * n_micro,
                              "paged_decode_attention": 0,
                              "flash_dq": 2 * n_micro, "flash_dkv": 2 * n_micro,
                              "psgn_direct": 0, "psgn_gram": 3 * 2 * n_micro,
                              "psgn_fused": 2 * n_micro,
                              "psgn_split": 2 * (2 + 3 * 2) * n_micro,
                              "quantize_int8": 0}
    assert not any(counts["cpu"].values())


def _quant_cases(r):
    """The edge cases of the CPU parity tests, on float32 values."""
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]],
                    np.float32)
    neg = r.uniform(-1, 1, (6, 50)).astype(np.float32)
    neg[np.arange(6), r.integers(0, 50, 6)] = -np.arange(2, 8, dtype=np.float32)
    zero = r.standard_normal((5, 40)).astype(np.float32)
    zero[2] = 0.0
    return {"ragged rows": r.standard_normal((300, 64)).astype(np.float32) * 3,
            "C 1": r.standard_normal((7, 1)).astype(np.float32),
            "ragged C": r.standard_normal((33, 4099)).astype(np.float32),
            "one row of 3 chunks + 5": r.standard_normal((1, 3 * 4096 + 5)).astype(np.float32),
            "one element": np.array([[-2.5]], np.float32),
            "zero row": zero, "ties": np.concatenate([ties, 2 * ties, ties / 4]),
            "negative max": neg, "NaN and inf rows": _non_finite(r)}


def _non_finite(r) -> np.ndarray:
    """Rows holding a NaN, +inf, -inf, both, and a finite row: NaN or
    infinite scales, and every code of those rows 0."""
    x = r.standard_normal((5, 4099)).astype(np.float32)
    x[0, 7], x[1, 4098], x[2, 901] = np.nan, np.inf, -np.inf
    x[3, [1, 4097]] = np.inf, np.nan
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernel_matches_plain_bit_for_bit(cuda, dtype):
    r = np.random.default_rng(5)
    for name, x32 in _quant_cases(r).items():
        x = torch.from_numpy(x32).to(cuda, dtype)
        kernels.reset_launch_counts()
        q, s = quant.quantize_int8(x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["quantize_int8"] == 1
        want_q, want_s = ref.quantize_int8(x)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(q, want_q), name
        nan = want_s.isnan()  # NaN scales in the same rows, the rest equal
        assert torch.equal(s.isnan(), nan) and torch.equal(s[~nan], want_s[~nan]), name
        q2, s2 = quant.quantize_int8(x)
        # the same bits every run
        assert torch.equal(q, q2) and torch.equal(s.view(torch.int32), s2.view(torch.int32))


def _quant_design_cases(r, dtype):
    """The kernel's two designs at their edges: the one-pass design's
    longest row (32768) and one either side, several rows of it, a view at
    an offset (no 16-byte aligned element: its units go element by element)
    and with a head before its first aligned unit, rows over the two-pass
    design (one long row with a NaN, two rows of 40000) and ragged two-pass
    rows."""
    def x(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
    flat = x(1 << 16)
    nan_row = x(1, 3 * 32768 + 5)
    nan_row[0, 70001] = float("nan")
    return {
        "one-pass design's longest row - 1 (1, 32767)": x(1, 32767),
        "one-pass design's longest row (1, 32768)": x(1, 32768),
        "two-pass design at one more (1, 32769)": x(1, 32769),
        "rows at the threshold (3, 32768)": x(3, 32768),
        "a view at 1 element (1, 65535)": flat[1:].reshape(1, -1),
        "a view at 8 elements (5, 13105)": flat[8:65533].reshape(5, -1),
        "a view at 1 element, a two-pass row (1, 65530)": flat[1:65531].reshape(1, -1),
        "two-pass row with a NaN (1, 98309)": nan_row,
        "two two-pass rows (2, 40000)": x(2, 40000),
        "ragged two-pass rows (3, 33333)": x(3, 33333),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_kernel_designs_bit_for_bit(cuda, dtype):
    """Both designs of the kernel, codes and scales bit for bit against the
    plain version, one call of its entry counted per call."""
    r = np.random.default_rng(9)
    for name, x in _quant_design_cases(r, dtype).items():
        kernels.reset_launch_counts()
        q, s = quant.quantize_int8(x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["quantize_int8"] == 1
        want_q, want_s = ref.quantize_int8(x)
        assert torch.equal(q, want_q), name
        nan = want_s.isnan()
        assert torch.equal(s.isnan(), nan) and torch.equal(s[~nan], want_s[~nan]), name


def test_quant_kernel_at_the_slice_shapes(cuda):
    """A Yi-6B gate leaf per tensor (1, 4096 * 11008) in float32 and rowwise
    (11008, 4096) in float32 and bf16."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for shape, dtype in (((1, 4096 * 11008), torch.float32),
                         ((11008, 4096), torch.float32), ((11008, 4096), torch.bfloat16)):
        x = (torch.randn(shape, generator=g, device=cuda) * 0.02).to(dtype)
        q, s = quant.quantize_int8(x)
        want_q, want_s = ref.quantize_int8(x)
        assert torch.equal(q, want_q) and torch.equal(s, want_s), (shape, dtype)


def test_quant_refusals(cuda):
    kernels.reset_launch_counts()
    q, s = quant.quantize_int8(torch.ones(2, 3))  # a CPU tensor: the plain version
    assert q.device.type == "cpu" and kernels.launch_counts()["quantize_int8"] == 0
    with pytest.raises(TypeError, match="dtype"):
        quant.quantize_int8(torch.ones(2, 3, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        quant.quantize_int8(torch.ones(3, 2, device=cuda).t())
    assert kernels.launch_counts()["quantize_int8"] == 0


def test_pod_trainer_on_card_matches_cpu(cuda):
    """Trainer + PodLadder(pods=2, granule=16) on the MLP workload of the
    reference's pod tests (n 2048, d 32, FixedPolicy(128), exact tier), one
    epoch on the cross-pod rung on [cuda]*8 and on [cpu]*8 from identical
    weights: the same rung and batches, losses and parameters within 1e-5,
    and pods x 4 leaves quantize_int8 launches per step on the card."""
    from repro_torch.adapt import AdaptationProgram, FixedPolicy
    from repro_torch.data import sigmoid_synthetic
    from repro_torch.models import small
    from repro_torch.optim import sgd
    from repro_torch.pod import PodLadder
    from repro_torch.train.loop import ModelFns, Trainer

    train, val, _ = sigmoid_synthetic(n=2048, d=32, seed=3)
    fns = ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss)
    out = {}
    for dev in ("cuda", "cpu"):
        # one CPU generator: the same weights on both devices
        params = small.mlp_init(torch.Generator().manual_seed(3), 32, device=dev)
        t = Trainer(fns, params, sgd(momentum=0.9),
                    AdaptationProgram(FixedPolicy(128, 1024, granule=16), base_lr=0.5),
                    train, val, estimator="exact", seed=3,
                    elastic=PodLadder(pods=2, devices=[dev] * 8, granule=16))
        kernels.reset_launch_counts()
        hist = t.run(1, verbose=False)
        out[dev] = (t, hist, kernels.launch_counts())
    (tc, hc, cc), (tp, hp, cp) = out["cuda"], out["cpu"]
    assert tc.rung.index == tp.rung.index == 3
    assert [h.batch_size for h in hc] == [h.batch_size for h in hp]
    assert cc["quantize_int8"] == 2 * 4 * hc[0].steps and cp["quantize_int8"] == 0
    loss_rel = max(abs(getattr(x, f) - getattr(y, f)) / abs(getattr(y, f))
                   for x, y in zip(hc, hp) for f in ("train_loss", "val_loss"))
    perr = max((a.detach().cpu() - b.detach()).abs().max().item()
               for a, b in zip(tc.params.parameters(), tp.params.parameters()))
    print(f"pod trainer card vs CPU: losses within {loss_rel:.3e} relative, "
          f"parameters within {perr:.3e}")
    # an H100 run measured 8.2e-8 and 1.2e-7: no code flipped in this epoch
    # (a flip would move a parameter by about lr x quantum / pods, ~1e-3)
    assert loss_rel <= 1e-5 and perr <= 1e-5


@pytest.mark.parametrize("host_overlap", [False, True])
def test_prefetch_on_a_side_stream(cuda, host_overlap):
    """Batches copied on a side stream (pinned, non_blocking) reach the
    consumer's stream intact, in order; the Trainer's trajectory is the
    same with each feed mode."""
    from repro_torch import data as tdata
    from repro_torch.adapt import AdaptationProgram, FixedPolicy
    from repro_torch.models import small
    from repro_torch.optim import sgd
    from repro_torch.train.loop import ModelFns, Trainer

    train, val, _ = tdata.sigmoid_synthetic(n=1024, d=16, seed=0)
    loader = tdata.EpochLoader(train, 64, epoch=0)
    got = list(tdata.prefetch(loader, put=lambda b: tdata.put_global_batch(b, cuda),
                              host_overlap=host_overlap, stream=torch.cuda.Stream(cuda)))
    want = list(loader)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(torch.equal(a[k].cpu(), torch.from_numpy(b[k])) for k in b)
    losses = {}
    for mode in (True, False, "thread"):
        params = small.logreg_init(torch.Generator().manual_seed(0), 16, device=cuda)
        t = Trainer(ModelFns(batch_loss=small.logreg_batch_loss,
                             example_loss=small.logreg_loss), params, sgd(momentum=0.9),
                    AdaptationProgram(FixedPolicy(64, 64), 0.5), train, val,
                    estimator="exact", prefetch=mode)
        losses[mode] = [h.val_loss for h in t.run(2, verbose=False)]
    assert losses[True] == losses[False] == losses["thread"]


def test_checkpoint_of_a_card_state_round_trips(cuda, tmp_path):
    """A bf16 LM state on the card goes to the reference's format and back
    into a fresh card state bit for bit; the host copy is complete when
    ``save`` returns, so a step that then updates the state in place
    (donation) does not reach an async write."""
    from repro_torch import interop
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.optim import sgd
    from repro_torch.train import init_state

    cfg = get_config("yi-6b", reduced=True).replace(param_dtype="bfloat16",
                                                    compute_dtype="bfloat16")
    state = init_state(tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda"), sgd(momentum=0.9))
    with torch.no_grad():
        for m, g in zip(state.opt_state.momentum, state.div_state.grad_sum.values()):
            m.normal_()
            g.normal_()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"state": interop.reference_state(state)})
    want = [p.detach().clone() for p in state.params.parameters()]
    with torch.no_grad():
        for p in state.params.parameters():
            p.add_(1.0)
    mgr.wait()
    fresh = init_state(tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                                      "cuda"), sgd(momentum=0.9))
    out, _ = mgr.restore({"state": interop.reference_state(fresh, target=True)})
    ref = out["state"]
    fresh = interop.load_reference_state(fresh, params=ref.params, opt_state=ref.opt_state,
                                         div_state=ref.div_state)
    for a, b in zip(fresh.params.parameters(), want):
        assert a.device.type == "cuda" and a.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(fresh.opt_state.momentum, state.opt_state.momentum):
        assert torch.equal(a, b)
    for k, g in state.div_state.grad_sum.items():
        assert torch.equal(fresh.div_state.grad_sum[k], g)


def test_resnet_on_card_matches_cpu(cuda):
    """The ResNet's forward (cuDNN convolutions, explicit "SAME" pads) and
    its exact-tier per-sample gradient norms on the card against the CPU,
    TF32 off: forward within 1e-5, norms within 1e-4 relative."""
    from repro_torch.core import diversity
    from repro_torch.data import imagelike_classification
    from repro_torch.models import resnet

    cpu = resnet.resnet_init(torch.Generator().manual_seed(0), depth=8, width=8, device="cpu")
    card = resnet.resnet_init(torch.Generator().manual_seed(0), depth=8, width=8,
                              device="cuda")
    train, _ = imagelike_classification(n=64, hw=16, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in train.get(np.arange(16)).items()}
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        torch.testing.assert_close(resnet.resnet_forward(card, on_card["x"]).cpu(),
                                   resnet.resnet_forward(cpu, batch["x"]), rtol=0, atol=1e-5)
    torch.testing.assert_close(
        diversity.persample_sq_norms(resnet.resnet_loss, card, on_card).cpu(),
        diversity.persample_sq_norms(resnet.resnet_loss, cpu, batch), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the MoE FFN (plain products on the card; no kernel of its own)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_layer_on_card_matches_cpu(cuda, arch):
    """The reduced config's MoE layer in float32 with identical weights, 2
    groups of 64 tokens, at capacity 1.0 (assignments dropped) and at the
    config's 4.0: outputs and aux within 1e-5, the dropped counts equal."""
    from repro_torch.models import moe

    cfg = get_config(arch, reduced=True)
    cpu = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts,
                       generator=torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    card = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts, device=cuda,
                        dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64, cfg.d_model))
                         .astype(np.float32))
    for factor in (1.0, cfg.capacity_factor):
        got, want = {}, {}
        card.stats, cpu.stats = got, want
        y_card, aux_card = moe.moe_apply(card, x.to(cuda), top_k=cfg.top_k,
                                         capacity_factor=factor, groups=2)
        y_cpu, aux_cpu = moe.moe_apply(cpu, x, top_k=cfg.top_k, capacity_factor=factor,
                                       groups=2)
        torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux_card.cpu(), aux_cpu, rtol=1e-5, atol=1e-5)
        assert int(got["dropped"]) == int(want["dropped"])
        assert int(got["first_top"]) == int(want["first_top"])
        assert (int(want["dropped"]) > 0) == (factor == 1.0)


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_full_width_moe_layer_matches_the_dense_oracle(cuda, arch):
    """One layer at full width in bf16 (dbrx: 16 experts of 6144 -> 10752;
    kimi-k2: 384 of 7168 -> 2048), 256 tokens, at the capacity E / top_k
    where nothing drops: ``moe_apply`` against ``moe_reference`` within
    bf16 rounding (2e-2: the two run their products at other shapes and
    round h to bf16 at other points)."""
    from repro_torch.models import moe

    cfg = get_config(arch)
    layer = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts,
                         generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((256, cfg.d_model))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    layer.stats = {}
    y, _ = moe.moe_apply(layer, x, top_k=cfg.top_k,
                         capacity_factor=cfg.num_experts / cfg.top_k)
    want = moe.moe_reference(layer, x, top_k=cfg.top_k)
    assert int(layer.stats["dropped"]) == 0
    _close(y, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_at_kimi_shape(cuda, dtype):
    """kimi-k2's decode form: 64/8 heads of hd 112 (n_rep 8, n_rep * hd =
    896), 8 slots, block 16, the table of max_seq 2048, ragged lengths and
    two free lanes on the sentinel block."""
    r = np.random.default_rng(112)
    b, blk, n_max, h, kv, hd = 8, 16, 128, 64, 8, 112
    nb = n_max * b + 1
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, dtype)
    lengths = np.asarray([1, 16, 300, 735, n_max * blk, 77, 5, 9], np.int32)
    tables = np.zeros((b, n_max), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)
    for row, n in enumerate(lengths[:6]):
        live = -(-int(n) // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, dtype)
    args = (q, pool_k, pool_v, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(lengths).to(cuda))
    got = kattn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    _close(got, ref.paged_decode_ref(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_forward_at_kimi_serving_shape(cuda, dtype):
    """kimi-k2's prefill form: a 256-row chunk over 768 valid prior tokens in
    a 64-block table, 64/8 heads of hd 112, causal (bf16 on the tensor
    cores, float32 on the FMA kernel)."""
    r = np.random.default_rng(7)
    args = _chunk_case(r, cuda, dtype, 1, 256, 1024, 768, 64, 8, 112)
    kernels.reset_launch_counts()
    got = kattn.chunk_attention(*args)
    torch.cuda.synchronize()
    _close(got, ref.attention_ref(*args), dtype)
    route = "tc" if dtype == torch.bfloat16 else "fma"
    assert kernels.route_counts()["chunk_attention"][route] == 1


# a tp rank's serving head counts (query, KV, hd, window, softcap): Yi-6B's
# 32/4 at T 2 and T 16, llama3-405b's 128/8, gemma2-27b's 32/16 (its
# softcap, and a window of 300 keys across the chunk's prior: its local
# layers' 4096 at a shorter context) and kimi-k2's 64/8 of hd 112 at T 16
TP_SERVING = {"yi T2": (16, 2, 128, None, None), "yi T16": (2, 1, 128, None, None),
              "llama3 T16": (8, 1, 128, None, None), "gemma2 T16": (2, 1, 128, 300, 50.0),
              "kimi-k2 T16": (4, 1, 112, None, None)}


@pytest.mark.parametrize("form", list(TP_SERVING))
def test_paged_decode_at_tp_serving_heads(cuda, form):
    """Paged decode at a tp rank's heads (bf16, 8 slots, block 16, the
    table of max_seq 2048, ragged lengths, a free lane on the sentinel
    block) against its plain version."""
    h, kv, hd, _, softcap = TP_SERVING[form]
    r = np.random.default_rng(h * 7 + kv)
    b, blk, n_max = 8, 16, 192
    nb = n_max * b + 1
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, torch.bfloat16)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(cuda, torch.bfloat16)
    lengths = np.asarray([1, 16, 300, 1100, n_max * blk, 77, 5, 9], np.int32)
    tables = np.zeros((b, n_max), np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)
    for row, n in enumerate(lengths[:7]):
        live = -(-int(n) // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(cuda, torch.bfloat16)
    args = (q, pool_k, pool_v, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(lengths).to(cuda))
    kernels.reset_launch_counts()
    got = kattn.paged_decode_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_decode_attention"] == 1
    _close(got, ref.paged_decode_ref(*args, softcap=softcap), torch.bfloat16)


@pytest.mark.parametrize("form", list(TP_SERVING))
def test_chunk_forward_at_tp_serving_heads(cuda, form):
    """The chunk forward at a tp rank's heads: a 256-row chunk over 768
    valid prior tokens in a 64-block table (gemma2's under its window and
    softcap), bf16 on the tensor cores, against its plain version."""
    h, kv, hd, window, softcap = TP_SERVING[form]
    r = np.random.default_rng(h * 11 + kv)
    args = _chunk_case(r, cuda, torch.bfloat16, 1, 256, 1024, 768, h, kv, hd)
    kernels.reset_launch_counts()
    got = kattn.chunk_attention(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    _close(got, ref.attention_ref(*args, window=window, softcap=softcap), torch.bfloat16)
    assert kernels.route_counts()["chunk_attention"]["tc"] == 1


# ---------------------------------------------------------------------------
# the Mamba archs (the scan in plain PyTorch on the card; no kernel of its own)
# ---------------------------------------------------------------------------


def test_jamba_engine_on_card_matches_cpu(cuda):
    """Reduced jamba (7 Mamba layers, an attention layer, MoE FFNs at odd
    positions) in float32 with identical weights, whole-prompt and chunked
    prefill: the card (kernels for its attention) and the CPU (plain
    versions) give the same greedy tokens, a full-prompt hit replaying its
    cached Mamba states; one chunk launch per prefill chunk and one paged
    decode per decode step."""
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_params = tf.build(cfg, cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 30, 17)]
    reqs = [Request(prompt=p, max_new_tokens=10) for p in prompts + [prompts[1]]]
    for chunk in (0, 16):
        kw = dict(max_slots=2, max_seq=64, prefill_chunk=chunk, block_size=8)
        kernels.reset_launch_counts()
        card = ServeEngine(cfg, card_params, device=cuda, **kw)
        out_card = card.generate(reqs)
        counts = kernels.launch_counts()
        out_cpu = ServeEngine(cfg, cpu_params, device="cpu", **kw).generate(reqs)
        assert [o.tokens.tolist() for o in out_card] == [o.tokens.tolist() for o in out_cpu]
        assert card.stats.shared_prefill_hits == 1
        assert counts["chunk_attention"] == card.stats.prefill_chunks
        assert counts["paged_decode_attention"] == card.stats.steps


def test_falcon_mamba_decode_on_card_matches_cpu(cuda):
    """Reduced falcon-mamba in float32 with identical weights:
    ``prefill_step`` on 2 prompts of 32 (two scan chunks), then 16 lockstep
    decode steps fed back greedily; logits within 1e-4 at every step, the
    Mamba states within 1e-4, and no kernel launched (no attention)."""
    cfg = get_config("falcon-mamba-7b", reduced=True)
    cpu_params = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card_params = tf.build(cfg, cuda)
    card_params.load_state_dict(cpu_params.state_dict())
    toks = torch.from_numpy(np.random.default_rng(7).integers(1, cfg.vocab_size, size=(2, 32)))
    kernels.reset_launch_counts()
    out = {}
    for dev, params in ((cuda, card_params), ("cpu", cpu_params)):
        logits, cache = tf.prefill_step(cfg, params, {"tokens": toks.to(dev)})
        steps = [logits.cpu()]
        for _ in range(16):
            # the CPU feeds back the card's tokens: one sequence on both
            src = out["cuda"][0] if "cuda" in out else steps
            nxt = src[len(steps) - 1][:, -1].argmax(-1, keepdim=True)
            logits, cache = tf.decode_step(cfg, params, cache, nxt.to(dev))
            steps.append(logits.cpu())
        out[str(dev)] = (steps, {k: v.cpu() for k, v in cache["pos0"].items()})
    (card_steps, card_state), (cpu_steps, cpu_state) = out["cuda"], out["cpu"]
    for a, b in zip(card_steps, cpu_steps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for key in ("h", "conv"):
        torch.testing.assert_close(card_state[key], cpu_state[key], rtol=1e-4, atol=1e-4)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# the exact tier: per-sample gradients through the kernels under vmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,hd,causal,route", [
    (torch.bfloat16, 128, True, "tc"), (torch.bfloat16, 80, False, "tc"),
    (torch.float32, 16, True, "fma")], ids=["tc-causal-hd128", "tc-noncausal-hd80",
                                            "fma-hd16"])
def test_flash_attention_vmap_grads_on_card_match_a_loop(cuda, dtype, hd, causal, route):
    """Per-sample gradients of ``sum(flash_attention(q, k, v) * w)`` over 3
    samples by ``vmap(grad(...))`` on the card against a loop of
    ``torch.autograd.grad`` on one sample at a time, the same kernels: the
    vmap launches the forward, dq and dk/dv once each for the fold of 3
    (the loop 3 times each), all on the route the plan names; q, dq, dk and
    dv within the kernels' tolerance (float32 1e-4, bf16 2e-2, the
    gradients cast to the inputs' type)."""
    r = np.random.default_rng(hd)

    def arr(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(cuda, dtype)

    h, kv, s = (8, 2, 150) if causal else (4, 4, 130)
    q, k, v = arr(3, 1, s, h, hd), arr(3, 1, s, kv, hd), arr(3, 1, s, kv, hd)
    w = arr(1, s, h, hd)

    def f(q_, k_, v_):
        return (kattn.flash_attention(q_, k_, v_, causal, None, 10.0) * w).float().sum()

    kernels.reset_launch_counts()
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    assert {n: kernels.route_counts()[n] for n in kattn.ROUTED} == \
        {n: {route: 1, "tc" if route == "fma" else "fma": 0} for n in kattn.ROUTED}
    kernels.reset_launch_counts()
    for i in range(3):
        leaves = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(f(*leaves), leaves)
        for g, lg in zip(got, want):
            _close(g[i], lg, dtype)
    assert {n: kernels.launch_counts()[n] for n in kattn.ROUTED} == \
        {n: 3 for n in kattn.ROUTED}


def test_exact_tier_on_card_matches_cpu(cuda):
    """Reduced Yi-6B (float32, remat on, the kernel lane: the FMA kernels at
    hd 16) takes 2 exact-tier steps of 4 sequences, per-sample gradients 2
    at a time by vmap, on the card and on the CPU from identical weights:
    losses and ``sq_norm_sum`` within 1e-4 relative, parameters within
    1e-4; on the card exactly 2 forward, 1 dq and 1 dk/dv launch per layer
    for the main pass and 1 of each per layer for each fold of 2."""
    from repro_torch.data import TokenStream
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("yi-6b", reduced=True).replace(remat=True, attn_impl="pallas")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    card = tf.build(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    example = lambda p, e: tf.loss_fn(cfg, p, {k: x[None] for k, x in e.items()})[0]  # noqa: E731
    out = {}
    for dev, model in ((cuda, card), ("cpu", cpu)):
        step = make_train_step(cfg, sgd(), 1, estimator="exact", example_loss=example,
                               psn_chunk=2)
        state = init_state(model, sgd())
        kernels.reset_launch_counts()
        losses = []
        for i in range(2):
            state, m = step(state, TokenStream(cfg.vocab_size, seed=2).batch(i, 4, 32), 0.05)
            losses.append(m["loss"].item())
        out[str(dev)] = (losses, state.div_state.sq_norm_sum.item(), kernels.launch_counts())
    (cl, cs, counts), (pl, ps, cpu_counts) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(cl, pl, rtol=1e-4)
    np.testing.assert_allclose(cs, ps, rtol=1e-4)
    for a, b in zip(card.parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-4)
    n = cfg.num_layers
    assert {k: counts[k] for k in kattn.ROUTED} == \
        {"chunk_attention": 2 * (2 * n + 2 * n), "flash_dq": 2 * (n + 2 * n),
         "flash_dkv": 2 * (n + 2 * n)}
    assert not any(cpu_counts.values())


# ---------------------------------------------------------------------------
# the sharded state's collectives at an NCCL world of one
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_world_one(cuda, tmp_path):
    """This process as the one rank of an NCCL world (a ``FileStore``), and
    the rung plan over it; the group is destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import data_plan

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        yield data_plan(dev)
    finally:
        dist.destroy_process_group()


def test_sharded_collectives_on_card_at_world_one(nccl_world_one):
    """``all_gather_dim``, ``reduce_scatter_dim``, ``all_to_all_dim0`` and
    the autograd gather on CUDA tensors of every dtype the state holds: at a
    world of one each is an identity (and so are the NCCL calls they make),
    gradients flow through the gather."""
    import torch.distributed as dist

    from repro_torch.dist import plan as dplan

    mesh = nccl_world_one.mesh
    r = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(8, 6, device="cuda", generator=r).to(dt)
          for dt in (torch.float32, torch.bfloat16)]
    for got, x in zip(dplan.all_gather_dim(xs, [0, 1], mesh, "data"), xs):
        assert torch.equal(got, x)
    for got, x in zip(dplan.reduce_scatter_dim(xs, [1, 0], mesh, "data"), xs):
        assert torch.equal(got, x)
    assert torch.equal(dplan.all_to_all_dim0(xs[0], mesh, "data"), xs[0])
    group = mesh.group("data")
    for name, out, inp in (("all_gather_into_tensor", torch.empty_like(xs[1]), xs[1]),
                           ("reduce_scatter_tensor", torch.empty_like(xs[0]), xs[0]),
                           ("all_to_all_single", torch.empty_like(xs[0]), xs[0])):
        getattr(dist, name)(out, inp, group=group)
        assert torch.equal(out, inp), name
    w = xs[0].clone().requires_grad_(True)
    whole = dplan.gather_shards([w], [[(0, ("data",))]], mesh, ("data",))[0]
    (whole * 2).sum().backward()
    assert torch.equal(w.grad, torch.full_like(w, 2.0))


def test_moe_apply_ep_on_card_matches_moe_apply(nccl_world_one):
    """``moe_apply_ep`` on the card at a world of one (every expert local,
    the all-to-alls identities) against ``moe_apply`` where nothing drops
    (capacity factor 8.0): outputs within 1e-5, bf16 within 2e-2; the aux
    loss equal."""
    from repro_torch.models import moe
    from repro_torch.models.moe_ep import moe_apply_ep

    mesh = nccl_world_one.mesh
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(3)
        layer = moe.init_moe(64, 96, 8, generator=g, device="cuda", dtype=dtype)
        x = torch.randn(2, 32, 64, device="cuda", generator=g).to(dtype)
        want, aux_want = moe.moe_apply(layer, x, top_k=2, capacity_factor=8.0)
        got, aux = moe_apply_ep(layer, x, top_k=2, capacity_factor=8.0, act="silu",
                                mesh=mesh, ep_axes=("data",))
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(aux, aux_want)
