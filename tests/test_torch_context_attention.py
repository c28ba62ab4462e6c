"""The attention of a context-parallel rank, on the CPU, against the JAX
reference: the rank's query rows ``[s0, s1)`` at positions ``s0 +
arange(S_t)`` against the keys ``[0, Sk)`` (``Sk = s1`` under causality,
``S`` without), the form ``models/transformer.py::_context_attention``
gives each lane.

The same numpy inputs go through the reference's Pallas flash attention
(``repro.kernels.attention.flash_attention``, interpret mode) and its XLA
flash lane (``repro.models.attention.flash_attention``) over the whole
sequence; the output gradient is zero outside the rows ``[s0, s1)`` of the
rank's piece.  The port's kernel lane (``kernels.attention.flash_attention(
..., q_offset=s0)``, whose plain versions the CPU runs: ``ref.
attention_ref_lse`` at explicit positions and ``ref.flash_grads_ref``), its
flash lane (``models.attention.flash_attention(..., q_offset=s0)``) and its
dense lane (``attention(..., q_offset=s0)``) on the piece give the
reference's out and dq on those rows and its dk and dv; summed over the T
pieces, dk and dv equal the reference's with the whole output gradient.
Cases: causal and not, a window, a softcap, n_rep 1 and 7, pieces of a
length no block divides.  float32 within 1e-5 (relative, and absolute in
units of the reference's largest element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jk
from repro.models import attention as jattn
from repro_torch.kernels import attention as tk
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

# (name, B, S, T, H, KV, hd, causal, window, softcap)
CASES = [
    ("causal_mha_window_softcap", 1, 32, 4, 2, 2, 16, True, 5, 20.0),
    ("noncausal_nrep7_window", 1, 24, 3, 7, 1, 16, False, 6, None),
    ("causal_nrep7_ragged", 2, 36, 4, 7, 1, 16, True, None, 30.0),  # S_t 9: no block divides it
]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    """The inputs of a case and the reference's output and gradients: whole
    (every row's dout) on both reference lanes, and per piece (the piece's
    rows' dout only) on the Pallas one."""
    name, b, s, t, h, kv, hd, causal, window, softcap = request.param
    r = np.random.default_rng(len(name))
    q, dout = (r.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(2))
    k, v = (r.standard_normal((b, s, kv, hd)).astype(np.float32) for _ in range(2))
    pallas = lambda q, k, v: jk.flash_attention(q, k, v, causal, window, softcap,  # noqa: E731
                                                q_block=32, kv_block=32, interpret=True)
    xla = lambda q, k, v: jattn.flash_attention(q, k, v, causal, window, softcap,  # noqa: E731
                                                q_block=s // t, kv_block=s // t)

    def run(fn):
        @jax.jit
        def go(q, k, v, do):
            out, vjp = jax.vjp(fn, q, k, v)
            return (out, *vjp(do))
        return go

    go = run(pallas)
    st = s // t
    pieces = []
    for i in range(t):
        do = np.zeros_like(dout)
        do[:, i * st:(i + 1) * st] = dout[:, i * st:(i + 1) * st]
        pieces.append([np.asarray(a) for a in go(q, k, v, do)])
    return {"args": (b, s, t, h, kv, hd, causal, window, softcap),
            "inputs": (q, k, v, dout),
            "whole": [np.asarray(a) for a in go(q, k, v, dout)],
            "xla": [np.asarray(a) for a in run(xla)(q, k, v, dout)],
            "pieces": pieces}


def _piece(case, i):
    """Piece ``i``'s torch inputs: its rows of q and dout, the keys ``[0,
    sk)``, and its offset."""
    b, s, t, h, kv, hd, causal, window, softcap = case["args"]
    q, k, v, dout = case["inputs"]
    st = s // t
    s0, s1 = i * st, (i + 1) * st
    sk = s1 if causal else s
    tq = torch.tensor(q[:, s0:s1], requires_grad=True)
    tk_, tv = (torch.tensor(x[:, :sk], requires_grad=True) for x in (k, v))
    return tq, tk_, tv, torch.from_numpy(dout[:, s0:s1]), s0, s1, sk


LANES = ("kernel", "flash", "dense")


def _lane(lane, case, q, k, v, s0):
    _, s, t, _, _, _, causal, window, softcap = case["args"]
    if lane == "kernel":
        return tk.flash_attention(q, k, v, causal, window, softcap, q_offset=s0)
    if lane == "flash":
        st, sk = q.shape[1], k.shape[1]
        return tattn.flash_attention(q, k, v, causal, window, softcap, q_block=st,
                                     kv_block=np.gcd(sk, 8 * st), q_offset=s0)
    return tattn.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                           q_offset=s0)


@pytest.mark.parametrize("lane", LANES)
def test_context_piece_matches_reference(case, lane):
    """Each piece's out and dq are the reference's rows; its dk and dv the
    reference's under that piece's output gradient (zero past ``sk``);
    summed over the pieces, dk and dv are the reference's whole ones, and
    the XLA lane agrees with the Pallas one."""
    b, s, t, h, kv, hd, causal, window, softcap = case["args"]
    want_out, want_dq, want_dk, want_dv = case["whole"]
    for got, want in zip(case["xla"], case["whole"]):
        _close(got, want)
    dk_sum = np.zeros_like(want_dk)
    dv_sum = np.zeros_like(want_dv)
    for i in range(t):
        q, k, v, dout, s0, s1, sk = _piece(case, i)
        out = _lane(lane, case, q, k, v, s0)
        out.backward(dout)
        _close(out.detach(), want_out[:, s0:s1])
        _close(q.grad, want_dq[:, s0:s1])
        _, _, pdk, pdv = case["pieces"][i]
        _close(k.grad, pdk[:, :sk])
        _close(v.grad, pdv[:, :sk])
        assert not pdk[:, sk:].any() and not pdv[:, sk:].any()
        dk_sum[:, :sk] += k.grad.numpy()
        dv_sum[:, :sk] += v.grad.numpy()
    _close(dk_sum, want_dk)
    _close(dv_sum, want_dv)


def test_kernel_plain_backward_at_offset(case):
    """``flash_dq`` and ``flash_dkv`` on the CPU (``ref.flash_grads_ref``
    at ``q_offset``) from the plain forward's lse: the reference's dq rows
    and the piece's dk and dv; the offset is not optional (the same call at
    offset 0 differs wherever the piece is not the first)."""
    b, s, t, h, kv, hd, causal, window, softcap = case["args"]
    for i in range(t):
        q, k, v, dout, s0, s1, sk = _piece(case, i)
        q, k, v = q.detach(), k.detach(), v.detach()
        q_pos = torch.arange(s0, s1)
        k_pos = torch.arange(sk)
        out, lse = tref.attention_ref_lse(q, k, v, q_pos, k_pos, torch.ones(sk),
                                          causal=causal, window=window, softcap=softcap)
        delta = tref.flash_delta(out, dout)
        kw = dict(window=window, softcap=softcap, causal=causal)
        dq = tk.flash_dq(q, k, v, dout, lse, delta, q_offset=s0, **kw)
        dk, dv = tk.flash_dkv(q, k, v, dout, lse, delta, q_offset=s0, **kw)
        _close(dq, case["whole"][1][:, s0:s1])
        _close(dk, case["pieces"][i][2][:, :sk])
        _close(dv, case["pieces"][i][3][:, :sk])
        if s0 and causal:
            wrong = tk.flash_dq(q, k, v, dout, lse, delta, **kw)
            assert not np.allclose(wrong.numpy(), dq.numpy(), rtol=1e-3, atol=1e-3)


def test_offset_shapes_refused():
    """Fewer keys than queries, a negative offset, or an lse of the keys'
    length raise before any launch."""
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        tk.flash_dq(q, k, k, q, lse, lse)
    with pytest.raises(ValueError, match="q_offset"):
        tk.flash_dkv(q, torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16), q, lse, lse,
                     q_offset=-1)
    with pytest.raises(ValueError, match="Sk >= Sq"):
        tk.flash_attention(q, k, k, q_offset=4)
    with pytest.raises(ValueError, match=r"\(B, H, Sq\)"):
        kk = torch.zeros(1, 12, 1, 16)
        tk.flash_dq(q, kk, kk, q, torch.zeros(1, 2, 12), torch.zeros(1, 2, 12), q_offset=4)
