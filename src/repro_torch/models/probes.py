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
chunks of ``cfg.ssm_chunk``; under tp ``mamba_apply_tp`` on the rank's
channels, as the training stack runs it), then its FFN as any layer's.

The probe forward runs the plain dense attention lane
(``models/attention.py::attention``) whatever ``cfg.attn_impl`` says, as
the reference does, and keeps no per-layer checkpoint.  With zero probes
its loss equals ``transformer.loss_fn`` on the dense lane bit for bit.

Tensor-parallel (a sharded state whose plan's tp axes span T > 1 ranks,
``dist.sharding.tp_split``): the probe forward splits each block as the
training stack does, and the probes sit at the rank's widths: q ``H/T *
hd``, k and v ``KV/T * hd``, the FFN's gate/up/in ``ff/T``, o and down
``d_model`` (added to the rank's partial output, so their gradient is the
whole output's).  Where attention runs context-parallel (T divides the
heads' widths but not the heads: ``TpSplit.attn == "context"``) the probes
sit at the rank's columns, q ``H hd/T`` and k, v ``KV hd/T`` over every
row, o ``d_model`` on the rank's ``H hd/T`` input columns, and the probe
block runs the training stack's exchanges (``transformer._context_qkv``,
``_context_out``) around the dense lane at the rank's query offset.  The
psgn kernels then read the rank's ``X`` and ``Delta``:
for a column-parallel layer X whole and Delta the rank's columns, for a
row-parallel one X the rank's rows and Delta whole; each sample's norms are
summed over tp afterwards (``tp_sum``).  Where T ranks share each KV head,
k and v are probed at the whole KV width (every KV head computed from the
gathered leaves, the rank's head used), the probe's gradient summed over
tp, and their norms counted by tp rank 0 only; so are a layer's that
computes whole on every tp rank.  The embedding (or frontend) and the
head, unprobed, split as in ``transformer.loss_fn``: the rank's ``d/T``
input columns joined by one all-gather, the vocab-parallel cross-entropy
behind ``tp.copy`` (without it the probes' gradients would be the rank's
part of the head's dx only).  ``probe_specs`` reads the widths off the
current plan (the train step calls it under ``use_plan``), or off
``plan=``.  The exact tier's per-sample pass (``torch.func``) runs whole.

The reference takes the probe gradients through ``jax.value_and_grad``,
which hands dicts back with their keys sorted; the per-layer sums here run
in that sorted order.
"""

from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.plan import all_reduce_sum_, current_plan
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import apply_rope, dense, in_func_transform
from repro_torch.models.moe import MoE, moe_apply


def _dense_probe_names(cfg: ModelConfig, plan=None, seq: int | None = None
                       ) -> list[tuple[str, int]]:
    """[(probe name, output width)] for every covered dense layer, at a tp
    rank's widths on ``plan`` for sequences of ``seq`` (the module
    docstring)."""
    hd = cfg.resolved_head_dim
    out = []
    for r in range(cfg.repeats):
        for p in range(cfg.period):
            kind = cfg.pattern[p]
            base = f"l{r}p{p}"
            split = sharding.tp_split(cfg, p, plan, seq)
            t = split.size
            if kind in ("attn", "attn_local"):
                wq, wk = cfg.num_heads * hd, cfg.num_kv_heads * hd
                if split.attn is not None:  # "context" too: the rank's columns
                    wq //= t
                    wk //= t if split.attn != "shared" else 1
                out += [
                    (f"{base}.q", wq),
                    (f"{base}.k", wk),
                    (f"{base}.v", wk),
                    (f"{base}.o", cfg.d_model),
                ]
            if cfg.d_ff > 0 and cfg.ffn_kind(p) == "dense":
                ff = cfg.d_ff // t if split.ffn == "dense" else cfg.d_ff
                if cfg.ffn_glu:
                    out += [(f"{base}.gate", ff), (f"{base}.up", ff)]
                else:
                    out += [(f"{base}.in", ff)]
                out += [(f"{base}.down", cfg.d_model)]
    return out


def probe_specs(cfg: ModelConfig, batch: int, seq: int,
                device: torch.device | str = DEFAULT_DEVICE, plan=None) -> dict:
    """Zero probes ``{name: (batch, seq, width)}`` in the compute type, on
    ``device`` (the card unless the caller asks for the CPU).  On a plan
    that holds sharded state over several tp ranks (``plan``, or the
    current one), the widths are the rank's (the module docstring)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    plan = plan if plan is not None else current_plan()
    if not sharding.shards_state(plan):
        plan = None
    return {name: torch.zeros((batch, seq, width), dtype=dt, device=dev)
            for name, width in _dense_probe_names(cfg, plan, seq)}


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
    layout = sharding.layout_of(params)
    tp = sharding.tensor_parallel(layout) if not in_func_transform() else None

    def pdense(x, weight, bias, name, counted=True, summed=False):
        """The dense layer plus its probe; its input kept where this rank
        counts the layer's norms; ``summed``: the probe's gradient summed
        over tp."""
        if name not in probes:
            return dense(x, weight, bias)
        if counted:
            acts[name] = x
        probe = probes[name]
        if probe.shape[-1] != weight.shape[0]:
            raise ValueError(f"probe {name} is {probe.shape[-1]} wide, its layer "
                             f"{weight.shape[0]}: build the probes with probe_specs under "
                             "the state's plan")
        return dense(x, weight, bias, probe=tp.copy(probe) if summed else probe)

    x = tf._model_input(cfg, params, batch, tp)  # the frontend is not probed
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r, p, blk in tf._layers(cfg, params):
        split = sharding.tp_split(cfg, p, layout.plan, x.shape[1]) if tp is not None else None
        with sharding.gathered(blk, layout, f"blocks.{r * cfg.period + p}.",
                               keep_resident=False, split=split):
            x, aux = _probed_block(cfg, blk, x, r, p, positions, pdense, aux, moe_groups,
                                   tp, split)
    loss = tf._xent(cfg, params, params.final_norm(x), batch["targets"], tp)
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss, acts


def _probed_block(cfg: ModelConfig, blk, x, r: int, p: int, positions, pdense, aux,
                  moe_groups: int, tp=None, split=None):
    """One layer of :func:`loss_with_probes` (its experts gathered whole:
    the probe pass routes with ``moe_apply``, as the reference's does);
    ``tp``/``split``: split over tp as the training stack splits it."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    kind = cfg.pattern[p]
    base = f"l{r}p{p}"
    # a layer computed whole on every tp rank counts its norms on one
    once = tp is None or tp.rank == 0
    h = blk.norm(x)
    if kind == "mamba":
        x = x + tf._mamba_sublayer(cfg, blk.mamba, h, tp, split)
    elif split is not None and split.attn == "context":
        ap = blk.attn
        window = cfg.window if kind == "attn_local" else None
        q, k, v = tf._context_qkv(
            cfg, ap, tp.copy(h), positions, tp,
            lambda n, hin, w, bias: pdense(hin, w, bias, f"{base}.{n}"))
        o = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                               softcap=cfg.attn_softcap,
                               q_offset=tf.context_rows(cfg, s, tp)[0])
        o = pdense(tf._context_out(o, tp), ap.o.weight, None, f"{base}.o")
        x = x + tp.reduce(o)
    else:
        ap = blk.attn
        mode = split.attn if split is not None else None
        q0, hq, k0, hk = tf.tp_heads(cfg, tp, mode)
        hin = h if mode is None else tp.copy(h)
        qb = ap.q.bias if mode is None else tf._rows(ap.q.bias, q0, hq, hd)
        q = pdense(hin, ap.q.weight, qb, f"{base}.q", mode is not None or once)
        q = q.reshape(b, s, hq, hd)
        if mode == "shared":  # every KV head from the whole leaves; this rank's one used
            k, v = (pdense(hin, lin.weight, lin.bias, f"{base}.{n}", once, summed=True)
                    .reshape(b, s, cfg.num_kv_heads, hd)[:, :, k0:k0 + 1]
                    for n, lin in (("k", ap.k), ("v", ap.v)))
        else:
            k, v = (pdense(hin, lin.weight,
                           lin.bias if mode is None else tf._rows(lin.bias, k0, hk, hd),
                           f"{base}.{n}", mode is not None or once).reshape(b, s, hk, hd)
                    for n, lin in (("k", ap.k), ("v", ap.v)))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.window if kind == "attn_local" else None
        o = attn_lib.attention(q, k, v, causal=cfg.causal, window=window,
                               softcap=cfg.attn_softcap)
        o = pdense(o.reshape(b, s, hq * hd), ap.o.weight, None, f"{base}.o",
                   mode is not None or once)
        x = x + (o if mode is None else tp.reduce(o))
    ffn_mode = split.ffn if split is not None else None
    if isinstance(blk.ffn, MoE):
        y, a = moe_apply(blk.ffn, blk.ffn_norm(x), top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, groups=moe_groups,
                         act=cfg.ffn_act, tp=tp if ffn_mode == "moe" else None)
        x = x + y
        aux = aux + a
    elif blk.ffn is not None:
        ffn = blk.ffn
        h = blk.ffn_norm(x)
        mine = ffn_mode == "dense"
        if mine:
            h = tp.copy(h)
        counted = mine or once
        if ffn.glu:
            hh = ffn.act(pdense(h, ffn.w_gate.weight, None, f"{base}.gate", counted))
            hh = hh * pdense(h, ffn.w_up.weight, None, f"{base}.up", counted)
        else:
            hh = ffn.act(pdense(h, ffn.w_in.weight, None, f"{base}.in", counted))
        y = pdense(hh, ffn.w_out.weight, None, f"{base}.down", counted)
        x = x + (tp.reduce(y) if mine else y)
    return x, aux


def tp_sum(params: torch.nn.Module, norms: torch.Tensor | None, batch: int,
           device: torch.device) -> torch.Tensor:
    """A probe pass's (B,) per-sample norms, summed over tp when
    ``params``' state splits over several tp ranks (each counted its own
    layers' part, :func:`loss_with_probes`); zeros for a rank that counted
    no layer."""
    v = torch.zeros(batch, dtype=torch.float32, device=device) if norms is None else norms
    tp = sharding.tensor_parallel(sharding.layout_of(params))
    if tp is not None and not in_func_transform():
        all_reduce_sum_(v, tp.group)
    return v


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
    layout = sharding.layout_of(params)
    probes = probe_specs(cfg, b, s, device=inputs.device,
                         plan=layout.plan if layout is not None else None)
    _, acts, pgrads = probe_grads(
        lambda p, pr, mb: loss_with_probes(cfg, p, pr, mb, moe_groups), params, probes,
        batch)
    total = None
    for name, x in acts.items():
        delta = pgrads[name].float() * float(b)
        v = kernel_ops.persample_sq_norm(x, delta)
        total = v if total is None else total + v
    return tp_sum(params, total, b, inputs.device)
