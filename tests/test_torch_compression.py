"""The port's cross-pod gradient compressor against the JAX reference, on
the CPU.

``repro_torch.dist.compression`` quantises on ``kernels/quant.py``, whose
CPU path is the plain version.  Inputs are float32 arrays from numpy with a
seed, handed to both packages.

  * ``_quantize`` and ``compress_leaf`` are held BIT FOR BIT against the
    reference's functions run op by op (as its own tests call them): the
    same codes, scale, dequantised value and residual, over shapes
    including a scalar.
  * error feedback integrates to the true signal, the check of
    ``tests/test_compression.py``: the average of 50 transmitted rounds
    within 0.05 of the signal, the residual below the signal's absmax.
  * ``make_compressed_pod_mean`` against the reference's on a 2-pod mesh
    (the 8 host devices of the test harness as 2 pods): the per-pod
    residuals and the mean.  The reference runs under ``jit``, where XLA
    computes ``absmax / 127`` as ``absmax * float32(1/127)`` (one ulp off
    the division in a few percent of leaves, ``tests/test_torch_kernels.py``),
    so a code can land on the neighbouring value: the mean is held to one
    quantum over the pods (``sum_p scale_p / pods``) and the residuals to
    one quantum of their pod, and the test counts the codes that flipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as jc
from repro_torch.dist import Mesh, ShardingPlan, current_plan, use_plan
from repro_torch.dist import compression as tc
from repro_torch.kernels import quant as tquant

torch.set_num_threads(2)

SHAPES = [(), (7,), (3, 5), (2, 3, 4), (64, 33)]


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_and_compress_leaf_are_bit_exact(shape):
    r = np.random.default_rng(len(shape))
    g = np.asarray(r.standard_normal(shape) * 0.1, np.float32)
    e = np.asarray(r.standard_normal(shape) * 1e-3, np.float32)
    jq, js = jc._quantize(jnp.asarray(g + e))
    tq, ts = tc._quantize(torch.from_numpy(np.asarray(g + e)))
    assert tq.shape == shape and ts.shape == () and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    jdeq, jerr = jc.compress_leaf(jnp.asarray(g), jnp.asarray(e))
    tdeq, terr = tc.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(tdeq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    assert terr.dtype == torch.float32


def test_compress_leaf_keeps_the_gradient_dtype():
    g = torch.randn(4, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    deq, err = tc.compress_leaf(g, torch.zeros(4, 8))
    assert deq.dtype == torch.bfloat16 and err.dtype == torch.float32
    for shape in [(), (7,), (3, 5), (2, 3, 4)]:
        deq, new_err = tc.compress_leaf(torch.ones(shape), torch.zeros(shape))
        assert deq.shape == shape and new_err.shape == shape


def test_error_feedback_unbiased_over_time():
    """The ACCUMULATED transmitted signal converges to the accumulated true
    signal; the residual stays bounded (tests/test_compression.py)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    err = torch.zeros(16, 64)
    sent = torch.zeros_like(g_true)
    for _ in range(50):
        deq, err = tc.compress_leaf(g_true, err)
        sent = sent + deq
    assert (sent / 50 - g_true).abs().max().item() < 0.05
    assert err.abs().max().item() < g_true.abs().max().item()


def test_init_error_state_and_tree_checks():
    tree = {"w": torch.zeros(3, 2, dtype=torch.bfloat16), "b": torch.zeros(2)}
    err = tc.init_error_state(tree)
    assert list(err) == ["w", "b"] and all(e.dtype == torch.float32 for e in err.values())
    with pytest.raises(ValueError, match="mismatch"):
        tc.compressed_pod_mean([[torch.zeros(2)]], [[torch.zeros(2), torch.zeros(1)]])
    with pytest.raises(ValueError, match="residual trees"):
        tc.compressed_pod_mean([[torch.zeros(2)], [torch.zeros(2)]], [[torch.zeros(2)]])


def test_make_compressed_pod_mean_matches_reference():
    """2 pods, a stacked tree of three leaves: per-pod residuals and the
    replicated mean against the reference's shard_map version."""
    r = np.random.default_rng(1)
    g = {"w": r.standard_normal((2, 4, 16)).astype(np.float32),
         "b": r.standard_normal((2, 16)).astype(np.float32),
         "s": r.standard_normal((2,)).astype(np.float32)}
    e = {k: (r.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    jmesh = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    jred, jerr = jax.jit(jc.make_compressed_pod_mean(jmesh, "pod"))(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    mesh = Mesh(["cpu"] * 2, ("pod",))
    tred, terr = tc.make_compressed_pod_mean(mesh, "pod")(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    flipped = 0
    for k in g:
        x = g[k] + e[k]
        scale = np.abs(x.reshape(2, -1)).max(1) / np.float32(127)  # per pod
        quantum = scale.reshape((2,) + (1,) * (x.ndim - 1))
        d_err = np.abs(terr[k].numpy() - np.asarray(jerr[k]))
        assert terr[k].shape == g[k].shape and np.all(d_err <= quantum * 1.001), k
        flipped += int((d_err > quantum / 2).sum())
        np.testing.assert_allclose(tred[k].numpy(), np.asarray(jred[k]), rtol=0,
                                   atol=float(scale.sum() / 2) * 1.001)
        np.testing.assert_allclose(tred[k].numpy(), x.mean(0), atol=float(scale.max()))
        if x[0].size > 1:  # a one-element leaf quantises exactly (code +-127)
            assert not np.allclose(terr[k].numpy()[0], terr[k].numpy()[1])
    assert flipped <= 2, f"{flipped} codes flipped"  # a handful of ulp-borderline codes


def test_compressed_pod_mean_gathers_onto_one_device():
    """Each pod's payload is int8 with one float32 scale per leaf: the mean
    equals the dequantised codes averaged in pod order."""
    r = np.random.default_rng(2)
    grads = [[torch.from_numpy(r.standard_normal((5, 3)).astype(np.float32))]
             for _ in range(3)]
    err = [tc.init_error_state(g) for g in grads]
    mean, new_err = tc.compressed_pod_mean(grads, err, "cpu")
    deq = []
    for g in grads:
        q, s = tquant.quantize_int8(g[0].reshape(1, -1))
        deq.append(q.float() * s[0])
    want = torch.stack(deq).mean(0).reshape(5, 3)
    torch.testing.assert_close(mean[0], want, rtol=0, atol=0)
    assert len(new_err) == 3 and new_err[1][0].shape == (5, 3)


def test_sharding_plan_and_mesh():
    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("pod", "data"))
    plan = ShardingPlan(mesh=mesh, dp=("pod", "data"), fsdp=(), tp=None)
    assert mesh.shape == {"pod": 2, "data": 4} and mesh.size == 8
    assert plan.dp_size == 8 and plan.fsdp_size == 1 and plan.tp_size == 1
    assert mesh.physical_device() == torch.device("cpu")
    assert mesh == Mesh(["cpu"] * 8, ("x",)).__class__(
        np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("pod", "data"))
    with pytest.raises(NotImplementedError, match="process groups"):
        Mesh(["cpu", "meta"], ("data",)).physical_device()
    with pytest.raises(ValueError, match="do not fit"):
        Mesh(["cpu"] * 2, ("a", "b"))
    assert current_plan() is None
    with use_plan(plan):
        assert current_plan() is plan
    assert current_plan() is None
