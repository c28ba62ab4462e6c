"""The port's primitive layers against ``repro.models.layers`` on the CPU.

Same numpy inputs into both packages; weights handed to the port in
``nn.Linear``'s (out, in) layout.  Tolerance: 1e-6 absolute and relative in
float32 for the elementwise ops, 1e-5 for the matrix products (summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("with_bias", [False, True])
def test_rms_norm(with_bias):
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 5, 32)).astype(np.float32) * 3
    scale = r.standard_normal(32).astype(np.float32)
    bias = r.standard_normal(32).astype(np.float32)
    params = {"scale": jnp.asarray(scale)}
    if with_bias:
        params["bias"] = jnp.asarray(bias)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                      torch.from_numpy(bias) if with_bias else None)
    _close(got, jl.rms_norm(params, jnp.asarray(x)), 1e-6)


def test_rms_norm_keeps_bf16():
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 16)).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.ones(16))
    want = jl.rms_norm({"scale": jnp.ones(16)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 0)


def test_layer_norm():
    r = np.random.default_rng(2)
    x = r.standard_normal((4, 24)).astype(np.float32) + 2
    scale = r.standard_normal(24).astype(np.float32)
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale))
    _close(got, jl.layer_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_apply_rope(theta):
    """Per-row positions, as the paged decode uses them, and the large
    rope_theta of Yi-6B."""
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = r.integers(0, 3000, size=(2, 7)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, 1e-4 if theta > 1e5 else 1e-5)


def test_rope_frequencies():
    got = tl.rope_frequencies(128, 5_000_000.0)
    _close(got, jl.rope_frequencies(128, 5_000_000.0), 1e-6)


@pytest.mark.parametrize("with_probe", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_dense(with_bias, with_probe):
    """The probe is added after the bias, as in the reference."""
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    kernel = r.standard_normal((16, 24)).astype(np.float32)
    bias = r.standard_normal(24).astype(np.float32)
    probe = r.standard_normal((2, 3, 24)).astype(np.float32)
    params = {"kernel": jnp.asarray(kernel)}
    if with_bias:
        params["bias"] = jnp.asarray(bias)
    got = tl.dense(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
                   torch.from_numpy(bias) if with_bias else None,
                   probe=torch.from_numpy(probe) if with_probe else None)
    want = jl.dense(params, jnp.asarray(x), probe=jnp.asarray(probe) if with_probe else None)
    _close(got, want, 1e-5)


def test_embed():
    r = np.random.default_rng(5)
    table = r.standard_normal((50, 8)).astype(np.float32)
    ids = r.integers(0, 50, size=(3, 6))
    got = tl.embed(torch.from_numpy(table), torch.from_numpy(ids))
    _close(got, jl.embed({"embedding": jnp.asarray(table)}, jnp.asarray(ids)), 0)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = tl.ACTIVATIONS[name](torch.from_numpy(x))
    _close(got, jl.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)
