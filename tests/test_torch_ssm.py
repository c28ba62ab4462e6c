"""The port's Mamba block (``repro_torch.models.ssm``) against
``repro.models.ssm``, on the CPU.

A standalone layer (d_model 32, d_state 8, expand 2, conv 4, float32) with
the reference's ``mamba_init`` weights carried over by
``interop.from_reference``, inputs made with numpy from a seed:
``mamba_apply`` at chunk 4 and at chunk = L, its final state, resuming from
a state over a sequence split in two (a piece shorter than K-1 included),
``mamba_decode_step`` token by token, the ``L % chunk`` refusal, gradients
of a scalar loss against ``jax.grad`` with and without the per-chunk
checkpoint, and the init.

Tolerance: outputs, states and gradients within 1e-5 relative and 1e-5
absolute (float32; the doubling scan sums in another order than JAX's
associative scan, and the outputs are O(1)).  The checkpointed and plain
gradients are compared for equality: recomputing a chunk repeats its ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, D_STATE, EXPAND, CONV = 32, 8, 2, 4


def _layer(seed: int = 0):
    """The reference's layer and the port's, holding the same weights."""
    jp = jssm.mamba_init(jax.random.key(seed), D_MODEL, D_STATE, EXPAND, CONV)
    layer = ssm.Mamba(D_MODEL, D_STATE, EXPAND, CONV)
    interop.from_reference(layer, dict(layer.named_parameters()),
                           jax.tree.map(np.asarray, jp))
    return jp, layer.requires_grad_(False)


def _x(seed: int, length: int, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, length, D_MODEL)).astype(np.float32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_layer_holds_the_reference_layout():
    """Every reference leaf maps onto one port parameter with no new rule:
    the projections transpose, the raw tensors keep their shapes, and
    ``A_log`` and ``D`` are float32."""
    jp, layer = _layer()
    ref = interop.params_to_numpy(layer)
    assert jax.tree.structure(ref) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bf16 = ssm.Mamba(D_MODEL, D_STATE, EXPAND, CONV, dtype=torch.bfloat16)
    assert {n: p.dtype for n, p in bf16.named_parameters()
            if p.dtype == torch.float32} == {"A_log": torch.float32, "D": torch.float32}


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba_apply_matches_reference(chunk):
    """L 16 in chunks of 4 (four scans threaded by the boundary state) and
    of 16 (one): the output and, with ``return_state``, ``h`` and the conv
    tail."""
    jp, layer = _layer(1)
    x = _x(2, 16)
    jout, jstate = jssm.mamba_apply(jp, jnp.asarray(x), d_state=D_STATE, chunk=chunk,
                                    return_state=True)
    out, state = ssm.mamba_apply(layer, torch.from_numpy(x), chunk=chunk, return_state=True)
    _close(out, jout)
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])
    assert state["h"].dtype == torch.float32
    assert tuple(state["conv"].shape) == (2, CONV - 1, EXPAND * D_MODEL)
    # the chunking changes nothing but rounding
    _close(ssm.mamba_apply(layer, torch.from_numpy(x), chunk=16 // chunk), out)


@pytest.mark.parametrize("cuts", [(8,), (6, 8), (12, 14)])
def test_resume_from_state_matches_one_call(cuts):
    """The sequence in pieces, each resuming from the one before's state,
    equals one call; a piece of 2 < K-1 tokens after a state still hands on
    K-1 rows of conv history (the reference's tail rule).  The reference
    runs the same pieces."""
    jp, layer = _layer(3)
    x = _x(4, 16)
    full = ssm.mamba_apply(layer, torch.from_numpy(x), chunk=4)
    pieces, jpieces, state, jstate = [], [], None, None
    bounds = (0,) + cuts + (16,)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = x[:, lo:hi]
        out, state = ssm.mamba_apply(layer, torch.from_numpy(part), chunk=2,
                                     return_state=True, state=state)
        jout, jstate = jssm.mamba_apply(jp, jnp.asarray(part), d_state=D_STATE,
                                        chunk=2, return_state=True,
                                        state=jstate)
        pieces.append(out)
        jpieces.append(np.asarray(jout))
        _close(state["h"], jstate["h"])
        _close(state["conv"], jstate["conv"])
    _close(torch.cat(pieces, dim=1), np.concatenate(jpieces, axis=1))
    _close(torch.cat(pieces, dim=1), full.detach().numpy())


def test_decode_steps_match_apply_and_reference():
    """``mamba_decode_step`` token by token from ``mamba_decode_init``
    equals ``mamba_apply`` over the whole sequence and the reference's
    decode, and leaves the reference's state."""
    jp, layer = _layer(5)
    x = _x(6, 12)
    full = ssm.mamba_apply(layer, torch.from_numpy(x), chunk=4)
    state = ssm.mamba_decode_init(2, D_MODEL, D_STATE, EXPAND, CONV, device="cpu")
    jstate = jssm.mamba_decode_init(2, D_MODEL, D_STATE, EXPAND, CONV)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in jstate.items()}
    outs = []
    for t in range(12):
        out, state = ssm.mamba_decode_step(layer, state, torch.from_numpy(x[:, t:t + 1]))
        jout, jstate = jssm.mamba_decode_step(jp, jstate, jnp.asarray(x[:, t:t + 1]),
                                              d_state=D_STATE)
        _close(out, jout)
        outs.append(out)
    _close(torch.cat(outs, dim=1), full.detach().numpy())
    _close(state["h"], jstate["h"])
    _close(state["conv"], jstate["conv"])


def test_chunk_must_divide_the_sequence():
    """The reference asserts ``L % chunk == 0``; the port raises, and never
    pads."""
    jp, layer = _layer()
    x = _x(7, 12)
    with pytest.raises(AssertionError):
        jssm.mamba_apply(jp, jnp.asarray(x), d_state=D_STATE, chunk=8)
    with pytest.raises(ValueError, match="multiple of the ssm chunk 8"):
        ssm.mamba_apply(layer, torch.from_numpy(x), chunk=8)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_grad(remat):
    """d/d(params, x) of ``sum(w * mamba_apply(x))`` over 4 chunks, against
    ``jax.grad``; the per-chunk checkpoint gives the same gradients as the
    plain graph, bit for bit."""
    jp, layer = _layer(8)
    x = _x(9, 16)
    w = np.random.default_rng(10).standard_normal((2, 16, D_MODEL)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba_apply(p, xx, d_state=D_STATE, chunk=4) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))

    layer.requires_grad_(True)

    def grads(ckpt: bool):
        layer.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_(True)
        loss = (ssm.mamba_apply(layer, xt, chunk=4, remat=ckpt) * torch.from_numpy(w)).sum()
        loss.backward()
        return xt.grad, {n: p.grad.clone() for n, p in layer.named_parameters()}

    gx, gp = grads(remat)
    _close(gx, jgx)
    tree = interop.to_reference(layer, gp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree)),
                    jax.tree.leaves(jgp)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    gx_other, gp_other = grads(not remat)
    assert torch.equal(gx, gx_other)
    assert all(torch.equal(gp[n], gp_other[n]) for n in gp)


def test_init_params_draws_the_reference_distributions():
    """``transformer.init_params`` on falcon-mamba's reduced config in bf16:
    ``A_log = log(1 .. d_state)`` and ``D = 1`` in float32, a zero conv
    bias, the conv kernel N(0, 1) / K and the projections N(0, 1/d_in)."""
    cfg = get_config("falcon-mamba-7b", reduced=True).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mixer = model.blocks[0].mamba
    assert model.blocks[0].attn is None and model.blocks[0].ffn is None
    assert mixer.A_log.dtype == mixer.D.dtype == torch.float32
    assert mixer.in_proj.weight.dtype == torch.bfloat16
    want = torch.log(torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32))
    assert torch.equal(mixer.A_log, want.expand_as(mixer.A_log))
    assert torch.equal(mixer.D, torch.ones_like(mixer.D))
    assert not mixer.conv_bias.any() and not mixer.dt_proj.bias.any()
    conv = torch.cat([blk.mamba.conv_kernel.float().flatten() for blk in model.blocks])
    assert abs(conv.std().item() * cfg.ssm_conv - 1.0) < 0.1
    w = mixer.in_proj.weight.float()
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
