"""Gram-tier diversity estimation for transformers: a probe-instrumented
forward and per-sample gradient norms through the psgn kernels.

Counterpart of ``repro/models/probes.py``.  A zero "probe" is added to the
output of every DENSE layer; the gradient w.r.t. a probe is the gradient of
that layer's output, and with the saved layer inputs the per-sample gradient
squared norm of each dense weight is

    ||G_b||_F^2 = ||X_b^T Delta_b||_F^2      (kernels/psgn.py; G_b is
                                              never formed)

Coverage: attention q/k/v/o and the dense FFN weights (the matrix products
that dominate the parameter count).  Embeddings (or the embedding frontend),
norms, the LM head, the MoE FFNs (router and experts) and the Mamba mixers
are excluded, as in the reference; ``coverage(cfg)`` reports the covered
fraction (0 for falcon-mamba, which has neither attention nor FFN).  A MoE
FFN runs unprobed (``models/moe.py::moe_apply`` in ``moe_groups`` groups),
and ``0.01 *`` its layers' summed aux loss joins the loss when
``cfg.num_experts`` is set, as in ``transformer.loss_fn``.  A 'mamba'
position runs its mixer unprobed (``models/ssm.py::mamba_apply`` over
chunks of ``cfg.ssm_chunk``), then its FFN as any layer's.

The probe forward runs the plain dense attention lane
(``models/attention.py::attention``) whatever ``cfg.attn_impl`` says, as
the reference does, and keeps no per-layer checkpoint.  With zero probes
its loss equals ``transformer.loss_fn`` on the dense lane bit for bit.

The reference takes the probe gradients through ``jax.value_and_grad``,
which hands dicts back with their keys sorted; the per-layer sums here run
in that sorted order.
"""

from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import apply_rope, dense
from repro_torch.models.moe import MoE, moe_apply


def _dense_probe_names(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(probe name, output width)] for every covered dense layer."""
    hd = cfg.resolved_head_dim
    out = []
    for r in range(cfg.repeats):
        for p in range(cfg.period):
            kind = cfg.pattern[p]
            base = f"l{r}p{p}"
            if kind in ("attn", "attn_local"):
                out += [
                    (f"{base}.q", cfg.num_heads * hd),
                    (f"{base}.k", cfg.num_kv_heads * hd),
                    (f"{base}.v", cfg.num_kv_heads * hd),
                    (f"{base}.o", cfg.d_model),
                ]
            if cfg.d_ff > 0 and cfg.ffn_kind(p) == "dense":
                if cfg.ffn_glu:
                    out += [(f"{base}.gate", cfg.d_ff), (f"{base}.up", cfg.d_ff)]
                else:
                    out += [(f"{base}.in", cfg.d_ff)]
                out += [(f"{base}.down", cfg.d_model)]
    return out


def probe_specs(cfg: ModelConfig, batch: int, seq: int,
                device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """Zero probes ``{name: (batch, seq, width)}`` in the compute type, on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    return {name: torch.zeros((batch, seq, width), dtype=dt, device=dev)
            for name, width in _dense_probe_names(cfg)}


def coverage(cfg: ModelConfig) -> float:
    """Fraction of parameters whose per-sample grad norm the gram tier
    covers; the total counts a model built on the meta device."""
    hd = cfg.resolved_head_dim
    per_layer_attn = cfg.d_model * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        + cfg.num_heads * hd * cfg.d_model
    covered = 0
    for p in range(cfg.period):
        if cfg.pattern[p] in ("attn", "attn_local"):
            covered += per_layer_attn
        if cfg.d_ff > 0 and cfg.ffn_kind(p) == "dense":
            mult = 3 if cfg.ffn_glu else 2
            covered += mult * cfg.d_model * cfg.d_ff
    covered *= cfg.repeats
    with torch.device("meta"):
        model = tf.Transformer(cfg, getattr(torch, cfg.param_dtype))
    return covered / sum(p.numel() for p in model.parameters())


def loss_with_probes(cfg: ModelConfig, params: tf.Transformer, probes: dict,
                     batch: dict, moe_groups: int = 1) -> tuple[torch.Tensor, dict]:
    """(loss, saved dense-layer inputs ``{name: (B, S, Din)}``): the mean CE
    of ``batch`` (plus ``0.01 * moe_aux`` with experts) with each probe added
    to its dense layer's output."""
    acts: dict = {}

    def pdense(x, lin, name):
        if name in probes:
            acts[name] = x
            return dense(x, lin.weight, lin.bias, probe=probes[name])
        return dense(x, lin.weight, lin.bias)

    x = tf._embed_input(cfg, params, batch)  # the frontend is not probed
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    hd = cfg.resolved_head_dim
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r, p, blk in tf._layers(cfg, params):
        kind = cfg.pattern[p]
        base = f"l{r}p{p}"
        h = blk.norm(x)
        if kind == "mamba":
            x = x + ssm.mamba_apply(blk.mamba, h, chunk=cfg.ssm_chunk, remat=cfg.remat)
        else:
            ap = blk.attn
            q = pdense(h, ap.q, f"{base}.q").reshape(b, s, cfg.num_heads, hd)
            k = pdense(h, ap.k, f"{base}.k").reshape(b, s, cfg.num_kv_heads, hd)
            v = pdense(h, ap.v, f"{base}.v").reshape(b, s, cfg.num_kv_heads, hd)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            window = cfg.window if kind == "attn_local" else None
            o = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                                   softcap=cfg.attn_softcap)
            x = x + pdense(o.reshape(b, s, cfg.num_heads * hd), ap.o, f"{base}.o")
        if isinstance(blk.ffn, MoE):
            y, a = moe_apply(blk.ffn, blk.ffn_norm(x), top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, groups=moe_groups,
                             act=cfg.ffn_act)
            x = x + y
            aux = aux + a
        elif blk.ffn is not None:
            ffn = blk.ffn
            h = blk.ffn_norm(x)
            if ffn.glu:
                hh = ffn.act(pdense(h, ffn.w_gate, f"{base}.gate"))
                hh = hh * pdense(h, ffn.w_up, f"{base}.up")
            else:
                hh = ffn.act(pdense(h, ffn.w_in, f"{base}.in"))
            x = x + pdense(hh, ffn.w_out, f"{base}.down")
    x = params.final_norm(x)
    loss = tf.xent_chunked(x, params.lm_head.weight, batch["targets"], cfg.xent_chunk,
                           cfg.final_softcap)
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss, acts


def probe_grads(probe_loss, params: torch.nn.Module, probes: dict, batch: dict
                ) -> tuple[torch.Tensor, dict, dict]:
    """One probe-gradient pass: ``(loss, acts, probe grads)``, the dicts
    sorted by name as the reference receives them.

    ``probe_loss(params, probes, batch) -> (loss, acts)``.  The gradient is
    taken w.r.t. the probes only: the parameters are frozen for the pass,
    so autograd keeps nothing for, and computes no, weight gradients (the
    reference's ``grad`` w.r.t. the probes skips them the same way)."""
    frozen = [p for p in params.parameters() if p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        probes = {n: t.detach().requires_grad_(True) for n, t in probes.items()}
        loss, acts = probe_loss(params, probes, batch)
        names = sorted(probes)
        grads = torch.autograd.grad(loss, [probes[n] for n in names])
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return (loss.detach(), {n: acts[n].detach() for n in sorted(acts)},
            dict(zip(names, grads)))


def persample_sq_norms_gram(cfg: ModelConfig, params: tf.Transformer,
                            batch: dict, moe_groups: int = 1) -> torch.Tensor:
    """(B,) per-sample gradient sq-norms over the covered dense weights.

    The sample is a SEQUENCE; its loss is that sequence's mean token CE.
    The loss is the batch mean, so the probe gradients are scaled by B, in
    float32 (the reference multiplies by an ``np.float32``, which promotes).
    Each layer goes through ``ops.persample_sq_norm`` on its own.  ``batch``
    holds "tokens" or, for an embedding-input config, "embeddings"."""
    inputs = batch["tokens"] if "tokens" in batch else batch["embeddings"]
    b, s = inputs.shape[0], inputs.shape[1]
    probes = probe_specs(cfg, b, s, device=inputs.device)
    _, acts, pgrads = probe_grads(
        lambda p, pr, mb: loss_with_probes(cfg, p, pr, mb, moe_groups), params, probes,
        batch)
    total = None
    for name, x in acts.items():
        delta = pgrads[name].float() * float(b)
        v = kernel_ops.persample_sq_norm(x, delta)
        total = v if total is None else total + v
    return total
