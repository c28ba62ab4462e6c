"""The attention kernels' two routes, on the CPU.

``repro_torch.kernels.attention.attention_plan`` picks, before any launch,
the tensor-core kernels (``csrc/chunk_attention_tc.cu``,
``csrc/flash_dkv_tc.cu``: bf16 at head dims 64 and 128) or the float32 FMA
kernels for the chunk forward and dk/dv.  Here: the plan itself, the
counters by route, that the CPU path launches and routes nothing, that
``_build.SIGNATURES`` (and ``KEY_TILES_ARGTYPES``, the tile counter's)
declares every C entry's argument types as its source writes them, that the
plain versions the tensor-core chunk kernel is held against on the card
equal the JAX reference at the edges its tile-skipping has to get right
(keys out of position order, positions past the array bounds, a
sentinel-only tail, a live row with no attendable key, padded rows),
float32 within 2e-5, and that their softcap ``tanh`` is float64's, rounded.
"""

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
ROUTED = ("chunk_attention", "flash_dkv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_attention_plan(dtype, hd):
    """bf16 at hd 64 and 128 takes the tensor cores; float32 (which TF32
    would take below its 1e-4) and hd 32 the FMA kernels."""
    want = "tc" if dtype == torch.bfloat16 and hd in (64, 128) else "fma"
    assert tk.attention_plan(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.bfloat16, 16, ValueError), (torch.bfloat16, 80, ValueError),
    (torch.float32, 256, ValueError), (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
])
def test_attention_plan_refuses_what_has_no_kernel(dtype, hd, err):
    with pytest.raises(err, match="head dim|dtype"):
        tk.attention_plan(dtype, hd)


def test_route_counts_cover_chunk_and_dkv():
    """``route_counts`` reads the chunk forward's and dk/dv's counts by
    route beside the psgn wrappers', and ``reset_launch_counts`` zeroes
    them."""
    tk.chunk_attention.routes["tc"] = 3
    tk.flash_dkv.routes["fma"] = 2
    routes = tkernels.route_counts()
    assert routes["chunk_attention"] == {"tc": 3, "fma": 0}
    assert routes["flash_dkv"] == {"tc": 0, "fma": 2}
    tkernels.reset_launch_counts()
    routes = tkernels.route_counts()
    assert set(routes) == {*ROUTED, "psgn_direct", "psgn_gram", "psgn_fused"}
    assert all(v == {"tc": 0, "fma": 0} for v in routes.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_launches_and_routes_nothing(dtype):
    """On the CPU the chunk forward, dk/dv and the autograd function take the
    plain versions: no launch, no route counted, in either type."""
    r = np.random.default_rng(21)
    q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dtype)
                     for shape in ((1, 20, 4, 64), (1, 20, 2, 64), (1, 20, 2, 64),
                                   (1, 20, 4, 64)))
    pos = torch.arange(20)
    tkernels.reset_launch_counts()
    out, lse = tk.chunk_attention_fwd(q, k, v, pos, pos, torch.ones(20, dtype=torch.bool))
    delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
    tk.flash_dkv(q, k, v, dout, lse, delta)
    tq = q.clone().requires_grad_(True)
    tk.flash_attention(tq, k, v).float().sum().backward()
    assert out.dtype == dtype and tq.grad.dtype == dtype
    assert not any(tkernels.launch_counts().values())
    assert all(v == {"tc": 0, "fma": 0} for v in tkernels.route_counts().values())


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
    pointer to 32 bits or pass a float as an int)."""
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
    """Both tensor-core attention sources build like every other library,
    with the chunk and dk/dv FMA entries' signatures, and their library
    names hash the shared Hopper header."""
    for tc, fma in (("chunk_attention_tc", "chunk_attention"), ("flash_dkv_tc", "flash_dkv")):
        assert tc in _build.SIGNATURES
        assert _build.SIGNATURES[tc][1] == _build.SIGNATURES[fma][1]
        assert _build.CSRC / "hopper.cuh" in _build._sources(tc)
        assert "hopper.cuh" in (_build.CSRC / f"{tc}.cu").read_text()
        assert "wgmma" in (_build.CSRC / f"{tc}.cu").read_text()


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
