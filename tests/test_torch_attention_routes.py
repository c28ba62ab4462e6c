"""The attention kernels' two routes and the decode split, on the CPU.

``repro_torch.kernels.attention.attention_plan`` picks, before any launch
and per kernel, the tensor-core kernels (``csrc/chunk_attention_tc.cu``,
``csrc/flash_dq_tc.cu`` and ``csrc/flash_dkv_tc.cu``: bf16 at head dims 64,
80, 112 and 128, causal or not; the forward up to ``TC_MAX_KEYS`` keys) or
the float32 FMA kernels for the chunk forward, dq and dk/dv.  Here: the
plan itself, the counters by route, that the CPU path launches and routes
nothing, that
``_build.SIGNATURES`` (and ``KEY_TILES_ARGTYPES``, the tile counter's)
declares every C entry's argument types as its source writes them, that the
plain versions the tensor-core chunk kernel is held against on the card
equal the JAX reference at the edges its tile-skipping has to get right
(keys out of position order, positions past the array bounds, a
sentinel-only tail, a live row with no attendable key, padded rows),
float32 within 2e-5, and that their softcap ``tanh`` is float64's, rounded.
Then the paged decode kernel's split over the context: ``decode_plan``'s
values, and a plain-torch emulation of the kernel's split-and-combine
arithmetic (32-token groups, online softmax per split, partials combined in
split order) against the JAX kernel in interpret mode and the JAX gather
oracle, float32 within 1e-5, at empty splits, length 1, split and pool-block
boundaries and free lanes with all-sentinel tables.
"""

import functools
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jk
from repro.kernels import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tk
from repro_torch.kernels import ref

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
ROUTED = ("chunk_attention", "flash_dq", "flash_dkv")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128])
def test_attention_plan(dtype, hd, causal):
    """Per kernel: in bf16 the chunk forward, dq and dk/dv take the tensor
    cores at hd 64, 80, 112 and 128 under either causality; float32 (which
    TF32 would take below its 1e-4), hd 16 and 32 the FMA kernels.  The
    default is causal."""
    bf = dtype == torch.bfloat16
    want = {name: "tc" if bf and hd >= 64 else "fma" for name in ROUTED}
    assert tk.attention_plan(dtype, hd, causal) == want
    assert set(want) == set(tk.ROUTED) == set(ROUTED)
    if causal:
        assert tk.attention_plan(dtype, hd) == want


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 80, 112, 128])
def test_attention_plan_above_the_key_cap(hd, causal):
    """A bf16 forward over more than ``TC_MAX_KEYS`` (65536) keys, which the
    tensor-core kernel's tile list cannot hold, is planned onto the FMA
    kernel before launch (the reference takes any key count); at the cap
    it stays on the tensor cores, and dq and dk/dv keep theirs."""
    assert tk.TC_MAX_KEYS == 65536
    at_cap = tk.attention_plan(torch.bfloat16, hd, causal, keys=tk.TC_MAX_KEYS)
    above = tk.attention_plan(torch.bfloat16, hd, causal, keys=tk.TC_MAX_KEYS + 1)
    assert at_cap == dict.fromkeys(ROUTED, "tc")
    assert above == {"chunk_attention": "fma", "flash_dq": "tc", "flash_dkv": "tc"}
    assert tk.attention_plan(torch.float32, hd, causal, keys=10 ** 6) == \
        dict.fromkeys(ROUTED, "fma")


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.bfloat16, 48, ValueError), (torch.bfloat16, 96, ValueError),
    (torch.float32, 256, ValueError), (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
])
def test_attention_plan_refuses_what_has_no_kernel(dtype, hd, err):
    """A head dim with no instance names the built ones and Queue B 2."""
    with pytest.raises(err, match="head dim|dtype"):
        tk.attention_plan(dtype, hd)
    if err is ValueError:
        with pytest.raises(ValueError, match=r"\(16, 32, 64, 80, 112, 128\).*Queue B 2"):
            tk.attention_plan(dtype, hd, causal=False)


def test_route_counts_cover_chunk_and_dkv():
    """``route_counts`` reads the chunk forward's, dq's and dk/dv's counts by
    route beside the psgn wrappers', and ``reset_launch_counts`` zeroes
    them."""
    tk.chunk_attention.routes["tc"] = 3
    tk.flash_dq.routes["tc"] = 4
    tk.flash_dq.routes["fma"] = 1
    tk.flash_dkv.routes["fma"] = 2
    routes = tkernels.route_counts()
    assert routes["chunk_attention"] == {"tc": 3, "fma": 0}
    assert routes["flash_dq"] == {"tc": 4, "fma": 1}
    assert routes["flash_dkv"] == {"tc": 0, "fma": 2}
    tkernels.reset_launch_counts()
    routes = tkernels.route_counts()
    assert set(routes) == {*ROUTED, "psgn_direct", "psgn_gram", "psgn_fused"}
    assert all(not any(v.values()) for v in routes.values())
    assert routes["psgn_direct"] == routes["psgn_fused"] == routes["psgn_gram"] == \
        {"tc": 0, "split": 0, "fma": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_launches_and_routes_nothing(dtype):
    """On the CPU the chunk forward, dq, dk/dv and the autograd function take
    the plain versions: no launch, no route counted, in either type."""
    r = np.random.default_rng(21)
    q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dtype)
                     for shape in ((1, 20, 4, 64), (1, 20, 2, 64), (1, 20, 2, 64),
                                   (1, 20, 4, 64)))
    pos = torch.arange(20)
    tkernels.reset_launch_counts()
    out, lse = tk.chunk_attention_fwd(q, k, v, pos, pos, torch.ones(20, dtype=torch.bool))
    delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
    dq = tk.flash_dq(q, k, v, dout, lse, delta)
    tk.flash_dkv(q, k, v, dout, lse, delta)
    assert dq.dtype == torch.float32 and dq.shape == q.shape
    tq = q.clone().requires_grad_(True)
    tk.flash_attention(tq, k, v).float().sum().backward()
    assert out.dtype == dtype and tq.grad.dtype == dtype
    assert not any(tkernels.launch_counts().values())
    assert not any(any(v.values()) for v in tkernels.route_counts().values())


_C_TYPES = {"int": "c_int", "float": "c_float"}


def _c_entry(name: str, entry: str = r"\w+") -> tuple[str, list[str]]:
    """(entry name, ctypes names of its parameters) of the first ``extern
    "C"`` entry of ``csrc/<name>.cu`` that returns an int (or of ``entry``)."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int ({entry})\(([^)]*)\)', src)
    assert m, f"no int-returning extern C entry in {name}.cu"
    kinds = []
    for param in m.group(2).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append("c_void_p")
        else:
            kinds.append(_C_TYPES[param.split()[0]])
    return m.group(1), kinds


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entries(name):
    """Every library's declared argtypes are its C entry's, pointer for
    pointer, int for int, float for float (ctypes would otherwise cut a
    pointer to 32 bits or pass a float as an int); the attention entries
    take ``causal`` as an int after ``window``."""
    entry, argtypes = _build.SIGNATURES[name]
    want_entry, want = _c_entry(name)
    assert entry == want_entry
    assert [t.__name__ for t in argtypes] == want


def test_key_tile_counter_entry_matches_its_declaration():
    """The tensor-core chunk library's tile-counter entry, which
    ``tc_key_tiles`` calls, takes the types ``KEY_TILES_ARGTYPES`` declares."""
    entry, want = _c_entry("chunk_attention_tc", "chunk_attention_tc_key_tiles")
    assert entry == "chunk_attention_tc_key_tiles"
    assert [t.__name__ for t in tk.KEY_TILES_ARGTYPES] == want


def test_tensor_core_sources_are_registered():
    """Each tensor-core attention source builds like every other library,
    with its FMA entry's signature, and its library name hashes the shared
    Hopper header, which it includes directly or through ``flash_tc.cuh``
    (the flash backward's shared pieces)."""
    for tc, fma in (("chunk_attention_tc", "chunk_attention"), ("flash_dq_tc", "flash_dq"),
                    ("flash_dkv_tc", "flash_dkv")):
        assert tc in _build.SIGNATURES
        assert _build.SIGNATURES[tc][1] == _build.SIGNATURES[fma][1]
        assert _build.CSRC / "hopper.cuh" in _build._sources(tc)
        src = (_build.CSRC / f"{tc}.cu").read_text()
        if tc.startswith("flash"):
            assert '#include "flash_tc.cuh"' in src
            src += (_build.CSRC / "flash_tc.cuh").read_text()
        assert '#include "hopper.cuh"' in src
        assert "wgmma" in src


def _edge_case(kind: str):
    """float32 chunk inputs (q, k, v, q_pos, k_pos, k_valid, window) at an
    edge of the tensor-core kernel's tile skipping."""
    r = np.random.default_rng(len(kind))
    c, prior, off, window = 24, 40, 30, None
    if kind == "sentinel tail":  # 10 valid prior tokens in a table of 160
        c, prior, off = 12, 160, 10
    q = r.standard_normal((1, c, 4, 16)).astype(np.float32)
    k = r.standard_normal((1, prior + c, 2, 16)).astype(np.float32)
    v = r.standard_normal((1, prior + c, 2, 16)).astype(np.float32)
    q_pos = (off + np.arange(c)).astype(np.int32)
    k_pos = np.concatenate([np.arange(prior), q_pos]).astype(np.int32)
    k_valid = np.concatenate([np.arange(prior) < off, np.ones(c, bool)])
    if kind == "shuffled keys past the bounds":
        perm = r.permutation(prior + c)
        k, v, k_pos, k_valid = k[:, perm], v[:, perm], k_pos[perm] + 5000, k_valid[perm]
        q_pos = q_pos + 5000
    elif kind == "live row with no attendable key":
        window = 3
        k_valid[prior + 5:prior + 8] = False  # row 7 sees only these three
    elif kind == "padded rows":
        q_pos[-5:] = -(2 ** 30)
    return q, k, v, q_pos, k_pos, k_valid, window


@pytest.mark.parametrize("kind", ["shuffled keys past the bounds", "sentinel tail",
                                  "live row with no attendable key", "padded rows"])
def test_plain_chunk_forward_matches_reference_at_tile_skipping_edges(kind):
    """The plain version (what the tensor-core kernel is held against on the
    card) against the JAX oracle, out and lse; where every row attends a
    key, against the interpret-mode Pallas kernel too."""
    q, k, v, q_pos, k_pos, k_valid, window = _edge_case(kind)
    args = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, q_pos, k_pos, k_valid)]
    out, lse = tk.chunk_attention_fwd(*args, window=window, softcap=15.0)
    jargs = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos, k_valid)]
    want = jref.attention_ref(*jargs, causal=True, window=window, softcap=15.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    if kind in ("shuffled keys past the bounds", "sentinel tail"):
        jout, jlse = jk._flash_forward(*jargs[:5], jargs[5].astype(jnp.int32), True, window,
                                       15.0, 8, 8, True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :q.shape[1]], **TOL)
    else:  # a row that attends nothing: the mean of v over all keys, lse -1e30
        rows = {"live row with no attendable key": [7], "padded rows": [19, 20, 21, 22, 23]}
        for row in rows[kind]:
            mean = np.repeat(v, 2, axis=2).mean(axis=1)[0]
            np.testing.assert_allclose(out[0, row].numpy(), mean, **TOL)
            assert (lse[0, :, row] == -1e30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_softcap_tanh_is_the_float64_tanh_rounded(dtype):
    """The plain versions' softcap ``tanh`` is taken in float64 and rounded
    to the working type, so it is the correctly rounded value of every
    element whatever float32 ``tanh`` path the CPU takes, in every thread
    split: here over the logits/softcap range of the card tests, each
    element against numpy's float64 tanh, bit for bit."""
    r = np.random.default_rng(16)
    x = np.concatenate([r.uniform(-4, 4, 100_000), np.linspace(-20, 20, 4001)])
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
    got = ref._tanh(xt)
    want = torch.from_numpy(np.tanh(xt.double().numpy())).to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


# --- the paged decode kernel's split over the context ------------------------


@pytest.mark.parametrize("b,kv,n_max,blk,sms,want", [
    (8, 4, 192, 16, 132, 9),     # the serving record: 288 blocks on 132 SMs
    (8, 4, 192, 16, 114, 8),     # another SM count
    (1, 1, 192, 16, 132, 48),    # one (row, head) pair: the table's 48 groups of 64
    (1, 1, 8, 16, 132, 2),       # a short table: 2 groups of 64 tokens
    (3, 2, 5, 16, 132, 2),       # 80 tokens: 2 groups
    (66, 4, 192, 16, 132, 1),    # B KV = 2 sms
    (64, 8, 192, 16, 132, 1),    # B KV > 2 sms
])
def test_decode_plan(b, kv, n_max, blk, sms, want):
    assert tk.decode_plan(b, kv, n_max, blk, sms) == want


def test_decode_plan_bounds():
    """At least 1, exactly 1 once B KV reaches two blocks per SM, and never
    more splits than the table has groups of 64 tokens."""
    for b in (1, 2, 3, 7, 8, 33, 100, 300):
        for kv in (1, 2, 4, 8):
            for n_max, blk in ((1, 1), (1, 16), (5, 16), (12, 8), (192, 16), (2048, 16)):
                for sms in (1, 66, 114, 132):
                    n = tk.decode_plan(b, kv, n_max, blk, sms)
                    groups = math.ceil(n_max * blk / 64)
                    assert 1 <= n <= groups
                    assert n == (1 if b * kv >= 2 * sms else min(math.ceil(2 * sms / (b * kv)),
                                                                 groups))


_DECODE_TILE = 32  # tokens the kernel stages and scores per group


def _split_decode(q, pool_k, pool_v, tables, lengths, splits, softcap=None):
    """The paged decode kernel's arithmetic in plain torch, float32: each
    row's live table entries (``ceil(length / block)``, at most n_max) cut
    into ``splits`` contiguous shares of ``ceil(live / splits)`` entries,
    each share streamed in 32-token groups through an online softmax (m, l,
    acc; scale, softcap, the tokens of the share only), then for each (row,
    KV head) the shares' partials combined in split order: m = max m_s,
    w_s = e^(m_s - m), out = sum w_s acc_s / max(sum w_s l_s, 1e-30)."""
    b, _, h, hd = q.shape
    _, blk, kv, _ = pool_k.shape
    n_max, n_rep = tables.shape[1], h // kv
    rows_k = pool_k.reshape(-1, kv, hd).float()
    rows_v = pool_v.reshape(-1, kv, hd).float()
    out = torch.zeros(b, 1, h, hd)
    for row in range(b):
        length = int(lengths[row])
        live = max(0, min(n_max, -(-length // blk)))
        per = -(-live // splits)
        for hk in range(kv):
            qh = q[row, 0, hk * n_rep:(hk + 1) * n_rep].float()
            parts = []
            for split in range(splits):
                e0, e1 = split * per, min(live, split * per + per)
                t0, t1 = e0 * blk, min(e1 * blk, length)
                m = torch.full((n_rep,), -1e30)
                l, acc = torch.zeros(n_rep), torch.zeros(n_rep, hd)
                for g0 in range(t0, t1, _DECODE_TILE):
                    t = torch.arange(g0, min(g0 + _DECODE_TILE, t1))
                    pool_rows = tables[row, t // blk].long() * blk + t % blk
                    x = (qh @ rows_k[pool_rows, hk].T) * hd ** -0.5
                    if softcap is not None:
                        x = torch.tanh(x / softcap) * softcap
                    m_new = torch.maximum(m, x.amax(1))
                    p = torch.exp(x - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ rows_v[pool_rows, hk]
                    m = m_new
                parts.append((m, l, acc))
            m = torch.stack([p[0] for p in parts]).amax(0)
            l, acc = torch.zeros(n_rep), torch.zeros(n_rep, hd)
            for m_s, l_s, acc_s in parts:  # split order
                w = torch.exp(m_s - m)
                l = l + l_s * w
                acc = acc + acc_s * w[:, None]
            out[row, 0, hk * n_rep:(hk + 1) * n_rep] = acc / l.clamp_min(1e-30)[:, None]
    return out


# blk 8, n_max 12 (96 tokens): length 1, a pool block, 47 / 48 / 49 (split
# and block boundaries for 2-4 splits), the full table, and two free lanes
# (all-sentinel tables, a length that kept counting, once past the table)
_DECODE_LENGTHS = (1, 8, 47, 48, 49, 96, 37, 130)


def _decode_case():
    r = np.random.default_rng(17)
    blk, n_max, kv, h, hd = 8, 12, 2, 4, 16
    b = len(_DECODE_LENGTHS)
    nb = 1 + 6 * n_max
    pool_k = r.standard_normal((nb, blk, kv, hd)).astype(np.float32)
    pool_v = r.standard_normal((nb, blk, kv, hd)).astype(np.float32)
    tables = np.zeros((b, n_max), np.int32)
    ids = list(r.permutation(np.arange(1, nb)))
    for row, length in enumerate(_DECODE_LENGTHS[:6]):
        n_live = -(-length // blk)
        tables[row, :n_live] = ids[:n_live]  # dead entries stay at sentinel 0
        ids = ids[n_live:]
    q = r.standard_normal((b, 1, h, hd)).astype(np.float32)
    return q, pool_k, pool_v, tables, np.array(_DECODE_LENGTHS, np.int32)


@functools.lru_cache(maxsize=None)
def _decode_oracles(softcap):
    """(JAX kernel in interpret mode, JAX gather oracle) on the case."""
    jargs = [jnp.asarray(a) for a in _decode_case()]
    kernel = jk.paged_decode_attention(*jargs, softcap=softcap, interpret=True)
    return np.asarray(kernel), np.asarray(jref.paged_decode_ref(*jargs, softcap=softcap))


@pytest.mark.parametrize("softcap", [None, 10.0])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 20])
def test_split_decode_emulation_matches_reference(splits, softcap):
    """The split-and-combine arithmetic equals the one-pass reference: at 20
    splits every row has empty splits (at most 12 live entries), at 2-4 the
    lengths 47-49 land beside, on and past share and block boundaries, and
    the free lanes read sentinel block 0 as the reference reads it."""
    args = [torch.from_numpy(a) for a in _decode_case()]
    got = _split_decode(*args, splits=splits, softcap=softcap).numpy()
    want_kernel, want_ref = _decode_oracles(softcap)
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
