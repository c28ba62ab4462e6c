"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each kernel is held against its plain PyTorch version on the same inputs on
the card: float32 at 1e-4 (the kernel sums in another order), bfloat16 at
2e-2 against the plain version computed in float32 from the same bf16
inputs (the kernel rounds p to bf16 before the PV product and the output to
bf16).  TF32 is off.  Whether a card is present is decided inside the
``cuda`` fixture, so every worker collects the same tests; without a
Hopper card they skip.

Run on the card: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, ref
from repro_torch.kernels import attention as kattn
from repro_torch.models import transformer as tf
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def test_launch_counters_and_refusals(cuda):
    r = np.random.default_rng(2)
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(r, cuda, torch.float32,
                                                 1, 8, 8, 8, 4, 2, 32)
    kattn.reset_launch_counts()
    kattn.chunk_attention(q, k, v, q_pos, k_pos, k_valid)
    assert kattn.launch_counts() == {"chunk_attention": 1, "paged_decode_attention": 0}
    bad = torch.zeros((1, 8, 4, 48), device=cuda)  # no head-dim-48 instance
    with pytest.raises(ValueError, match="head dim"):
        kattn.chunk_attention(bad, bad[:, :, :2], bad[:, :, :2], q_pos,
                              q_pos, torch.ones(8, dtype=torch.bool, device=cuda))
    assert kattn.chunk_attention.launches == 1


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
    kattn.reset_launch_counts()
    out_card = ServeEngine(cfg, card_params, device=cuda, **kw).generate(reqs)
    counts = kattn.launch_counts()
    out_cpu = ServeEngine(cfg, cpu_params, device="cpu", **kw).generate(reqs)
    assert [o.tokens.tolist() for o in out_card] == [o.tokens.tolist() for o in out_cpu]
    assert counts["chunk_attention"] > 0 and counts["paged_decode_attention"] > 0
