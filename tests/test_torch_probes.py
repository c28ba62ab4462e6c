"""The port's gram tier on transformer probes against ``repro.models.probes``.

The tiny config of ``tests/test_probes.py`` (2 layers, d_model 32, 4/2
heads, d_ff 64, S 16, float32, ``scan_layers=False``) with the reference's
own random weights carried over by ``interop.params_from_jax``; token
batches from numpy.  The reference runs its Pallas psgn kernels in
interpret mode (its default off the TPU); the port runs on the CPU, where
the psgn wrappers take their plain versions.  Tolerances: the zero-probe
loss equals the port's own ``loss_fn`` bit for bit and the reference's
within 1e-6 relative; activations and probe gradients within 1e-5 relative
plus 1e-5 of the tensor's RMS (float32, other summation orders: the largest
difference seen is 4e-6 of the RMS); per-sample norms within 1e-5
relative.  Method picks, groups and coverage must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import probes as jprobes
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import probes
from repro_torch.models import transformer as tf

torch.set_num_threads(2)

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, d_ff=64, vocab_size=61, param_dtype="float32",
            compute_dtype="float32", xent_chunk=8, scan_layers=False, remat=False)
GEMMA = dict(pattern=("attn_local", "attn"), window=4, attn_softcap=30.0)
CONFIGS = {"tiny": {}, "gemma-style": GEMMA}
B, S = 3, 16


def _cfgs(extra: dict):
    return JModelConfig(**TINY).replace(**extra), ModelConfig(**TINY).replace(**extra)


def _setup(extra: dict, seed: int = 0):
    jcfg, cfg = _cfgs(extra)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, size=(B, S))
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)}
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(toks)}
    return jcfg, cfg, jparams, params, jbatch, batch


def _port_pass(cfg, params, batch):
    return probes.probe_grads(lambda p, pr, mb: probes.loss_with_probes(cfg, p, pr, mb),
                              params, probes.probe_specs(cfg, B, S, device="cpu"), batch)


@pytest.mark.parametrize("extra", list(CONFIGS.values()), ids=list(CONFIGS))
def test_probe_forward_matches_plain(extra):
    """Zero probes: the port's own loss_fn (dense lane at S 16) bit for bit,
    the reference's loss_with_probes and loss_fn within 1e-6."""
    jcfg, cfg, jparams, params, jbatch, batch = _setup(extra)
    pr = probes.probe_specs(cfg, B, S, device="cpu")
    loss_p, acts = probes.loss_with_probes(cfg, params, pr, batch)
    loss, _ = tf.loss_fn(cfg, params, batch)
    assert loss_p.item() == loss.item()
    assert list(acts) == list(pr) == [n for n, _ in jprobes._dense_probe_names(jcfg)]
    jloss_p, _ = jprobes.loss_with_probes(jcfg, jparams, jprobes.probe_specs(jcfg, B, S),
                                          jbatch)
    jloss, _ = jtf.loss_fn(jcfg, jparams, jbatch)
    np.testing.assert_allclose(loss_p.item(), float(jloss_p), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)


@pytest.mark.parametrize("extra", list(CONFIGS.values()), ids=list(CONFIGS))
def test_acts_and_probe_grads_match_reference(extra):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(extra, seed=2)
    params.requires_grad_(True)  # as in training: the pass freezes them for itself
    loss, acts, pgrads = _port_pass(cfg, params, batch)
    (jloss, jacts), jgrads = jax.value_and_grad(
        lambda pr: jprobes.loss_with_probes(jcfg, jparams, pr, jbatch), has_aux=True,
    )(jprobes.probe_specs(jcfg, B, S))
    # jax hands the dicts back sorted by key; the port sorts them the same way
    assert list(acts) == list(jacts) and list(pgrads) == list(jgrads)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    for got, want in [(acts[n], jacts[n]) for n in acts] + \
            [(pgrads[n], jgrads[n]) for n in pgrads]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.sqrt(np.mean(want ** 2)))
    # the parameters are trainable again after the probe pass, with no gradient
    assert all(p.requires_grad and p.grad is None for p in params.parameters())


@pytest.mark.parametrize("extra", list(CONFIGS.values()), ids=list(CONFIGS))
def test_persample_sq_norms_gram_matches_reference(extra):
    jcfg, cfg, jparams, params, jbatch, batch = _setup(extra, seed=4)
    got = probes.persample_sq_norms_gram(cfg, params, batch)
    want = jprobes.persample_sq_norms_gram(jcfg, jparams, jbatch)
    assert got.shape == (B,) and got.dtype == torch.float32
    assert bool((got > 0).all()) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_method_picks_and_groups_at_the_tiny_config():
    """At S 16 the tiny config's layers take the dispatch the Yi-6B widths
    take at S 2048: q and o tie and go direct, k and v go direct, gate, up
    and down go to gram; the tree fuses the q/o and the k/v groups."""
    _, cfg, _, params, _, batch = _setup({})
    _, acts, pgrads = _port_pass(cfg, params, batch)
    picks = {n.split(".")[1]: ops.choose_method(S, a.shape[-1], pgrads[n].shape[-1])
             for n, a in acts.items()}
    assert picks == {"q": "direct", "k": "direct", "v": "direct", "o": "direct",
                     "gate": "gram", "up": "gram", "down": "gram"}
    groups = list(ops.group_layers(acts, pgrads).values())
    assert groups == [["l0p0.down"], ["l0p0.gate"], ["l0p0.k", "l0p0.v", "l1p0.k", "l1p0.v"],
                      ["l0p0.o", "l0p0.q", "l1p0.o", "l1p0.q"], ["l0p0.up"], ["l1p0.down"],
                      ["l1p0.gate"], ["l1p0.up"]]


def test_gram_matches_per_sample_autograd_on_covered_params():
    """The probe trick equals per-sequence gradients taken one sequence at
    a time, squared over the covered weights (the reference's vmap check)."""
    _, cfg, _, params, _, batch = _setup({}, seed=6)
    got = probes.persample_sq_norms_gram(cfg, params, batch)
    params.requires_grad_(True)
    covered = [lin.weight for blk in params.blocks
               for lin in (blk.attn.q, blk.attn.k, blk.attn.v, blk.attn.o,
                           blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_out)]
    want = []
    for i in range(B):
        mb = {k: v[i:i + 1] for k, v in batch.items()}
        grads = torch.autograd.grad(tf.loss_fn(cfg, params, mb)[0], covered)
        want.append(sum(g.square().sum() for g in grads).item())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


@pytest.mark.parametrize("extra", [{}, GEMMA, dict(ffn_glu=False, qkv_bias=True)],
                         ids=["tiny", "gemma-style", "mlp-bias"])
def test_coverage_and_probe_specs_match_reference(extra):
    jcfg, cfg = _cfgs(extra)
    assert probes.coverage(cfg) == jprobes.coverage(jcfg)
    assert probes._dense_probe_names(cfg) == jprobes._dense_probe_names(jcfg)
    specs = probes.probe_specs(cfg, 2, 5, device="cpu")
    jspecs = jprobes.probe_specs(jcfg, 2, 5)
    assert {n: tuple(t.shape) for n, t in specs.items()} == \
        {n: tuple(t.shape) for n, t in jspecs.items()}
    assert all(not t.any() for t in specs.values())


def test_coverage_of_yi_6b():
    """Yi-6B at full width (the model is built on the meta device, so
    nothing is allocated) against the reference's count."""
    from repro.configs import get_config as jget

    assert probes.coverage(get_config("yi-6b")) == jprobes.coverage(jget("yi-6b"))


def test_moe_and_mamba_positions_raise():
    _, cfg, _, params, _, batch = _setup({})
    pr = probes.probe_specs(cfg, B, S, device="cpu")
    moe = cfg.replace(num_experts=4, top_k=2, ffn_pattern=("moe",))
    mamba = cfg.replace(pattern=("attn", "mamba"))
    for bad in (moe, mamba):
        with pytest.raises(NotImplementedError, match="Queue C"):
            probes.loss_with_probes(bad, params, pr, batch)
        with pytest.raises(NotImplementedError, match="Queue C"):
            probes.coverage(bad)


def test_probe_specs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        probes.probe_specs(ModelConfig(**TINY), 1, 4)
