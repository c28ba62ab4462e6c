"""The decoder/encoder stack: parameters, the training forward with its
chunked cross-entropy, the encoder's forward, and serving (the paged KV
pool, windowed rings and the dense per-slot cache, decode, chunked and
whole-prompt prefill).

Counterpart of ``repro/models/transformer.py``.  The reference stacks each
pattern position's parameters over a repeats axis and scans; here the model
is an ``nn.Module`` with a ``ModuleList`` of blocks (layer ``r * period +
p`` is repeat ``r`` of pattern position ``p``) and ``nn.Linear`` weights in
``(out, in)`` layout, and the stack is a Python loop (``cfg.scan_layers``
has no counterpart).  Serving state keeps the reference's layout: per
pattern position a ``(repeats, ...)`` stack, so ``pages[...][r]`` is one
layer's contiguous ``(num_blocks, block, KV, hd)`` pool and
``cache[...]["k"][r]`` one layer's ``(B, s_c, KV, hd)`` cache.

Training: ``loss_fn`` runs the stack with gradients.  ``cfg.remat``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant), so the
backward runs the layer's forward again, attention kernel included.
Inside a ``torch.func`` transform (the exact tier's ``vmap(grad(...))``,
``core/diversity.py``) the layers run without the checkpoint, which
torch.func cannot run: the per-sample pass keeps every layer's activations
for the samples it takes at once, where the reference's ``jax.checkpoint``
would not.  Remat changes no result, only memory.  ``xent_chunked`` and
both flash lanes have vmap rules: the kernel lane folds the vmapped axis
into B and launches each kernel once for the fold.
``cfg.attn_impl`` picks the attention lane (``models/attention.py::
resolve_impl``): "pallas" is ``kernels/attention.py::flash_attention`` (the
chunk kernel forward and the dq / dk-dv backward kernels on the card),
"flash" the reference's XLA lane (``models/attention.py::flash_attention``,
streaming softmax and its recompute backward in plain PyTorch: the
reference runs it on no Pallas kernel), "dense" the plain lane under
autograd; "auto" takes "flash" above ``cfg.flash_threshold``.  The
``flash_*_block`` settings tile the flash lane and the reference's Pallas
kernels, not the CUDA kernels.  ``xent_chunked`` never forms the (B, S, V)
logits and recomputes each chunk's in its backward.  Parameters take
gradients once ``train.state.init_state`` makes them trainable; ``build()``
(serving) keeps them frozen.

Serving: a full-attention ('attn') position keeps its KV in the block pool
when serving paged (``paged_positions``), else in the dense per-slot cache
(``prefill_step`` fills it); a sliding-window ('attn_local') position keeps
a ring of ``min(window, seq_len)`` keys per slot, written at ``pos mod
s_c``.  Paged decode and chunked prefill go through ``kernels/attention.py``
(the CUDA kernels for tensors on the card, their plain versions on the
CPU); decode against a ring or the dense cache runs the plain
``models/attention.py::decode_attention``, as the reference runs it in XLA.
Rings and the dense cache are updated in place, like the pool.

Inputs: ``cfg.input_mode == "tokens"`` reads ``batch["tokens"]`` (B, S)
through the ``embed`` table; ``"embeddings"`` (the audio and vision
configs' stub frontend) reads ``batch["embeddings"]`` (B, S, d_model),
cast to the compute type, through ``frontend``, a bias-free dense layer in
the table's place; ``decode_step`` takes (B, 1) tokens or (B, 1, d_model)
embeddings likewise.  An encoder (``cfg.causal == False``) runs its
attention without the causal mask, in training and in ``prefill_step``.

Entry points:
  init_params(cfg, generator, device, dtype)    the model (random weights)
  loss_fn(cfg, params, batch)                   mean CE loss, metrics
  xent_chunked(x, weight, targets, chunk, softcap)
  prefill_step(cfg, params, batch)              last logits and the cache
                                                (an encoder: every logit)
  init_cache / init_pages / paged_positions     serving state
  decode_step(cfg, params, cache, tokens, pages=, tables=)
  prefill_chunk(cfg, params, row, pages, batch, offset, prior_tab, write_tab)

MoE FFNs: ``cfg.ffn_kind(pos) == "moe"`` builds ``models/moe.py::MoE``
(the router kept in float32 in any model type) and runs ``moe_apply`` in
``moe_groups`` groups (``loss_fn``, ``prefill_step``, ``decode_step`` and
``prefill_chunk`` take them; serving passes 1, as the reference's engine).
The stack sums the layers' aux losses, and ``loss_fn`` adds ``0.01 * aux``
when ``cfg.num_experts`` is set.  ``cfg.moe_impl == "ep"`` under a plan with
an expert axis raises (``models/moe_ep.py``, ROADMAP.md Queue A 5); without
a plan it takes ``moe_apply``, as the reference does.

Mamba mixers ('mamba', ``models/ssm.py``): ``Block`` holds a ``Mamba``
in the attention's place, and the layer still runs its FFN (none when
``d_ff == 0``, falcon-mamba's case).  Training runs ``mamba_apply`` over
the sequence in chunks of ``cfg.ssm_chunk`` (``cfg.remat`` checkpoints
each chunk step as well as the layer).  Serving keeps a Mamba position's
state per slot and in each prefill job's row, never in the pool:
``{"h" float32 (repeats, B, d_inner, d_state), "conv" (repeats, B, K-1,
d_inner)}`` in the compute type, whatever the context's length.
``prefill_step`` fills it, ``decode_step`` advances it a token, and
``prefill_chunk`` resumes from the row's state in chunks of
``min(ssm_chunk, C)`` steps (``C`` when that does not divide ``C``), as the
reference does; all three write it in place.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.plan import current_plan
from repro_torch.kernels import attention as kernels_attn
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm
from repro_torch.models.moe import MoE, init_experts_, moe_apply
from repro_torch.models.layers import (ACTIVATIONS, apply_rope, dense, embed, in_func_transform,
                                       layer_norm, rms_norm)

#: the mixers the port runs, in training and serving
MIXERS = ("attn", "attn_local", "mamba")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    def __init__(self, d: int, kind: str, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rms":
            return rms_norm(x, self.scale)
        return layer_norm(x, self.scale)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        hd = cfg.resolved_head_dim
        d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.q = nn.Linear(d, h * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.k = nn.Linear(d, kv * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.v = nn.Linear(d, kv * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.o = nn.Linear(h * hd, d, bias=False, dtype=dtype)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.glu = cfg.ffn_glu
        self.act = ACTIVATIONS[cfg.ffn_act]
        if self.glu:
            self.w_gate = nn.Linear(d, f, bias=False, dtype=dtype)
            self.w_up = nn.Linear(d, f, bias=False, dtype=dtype)
        else:
            self.w_in = nn.Linear(d, f, bias=False, dtype=dtype)
        self.w_out = nn.Linear(f, d, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.glu:
            h = self.act(dense(x, self.w_gate.weight)) * dense(x, self.w_up.weight)
        else:
            h = self.act(dense(x, self.w_in.weight))
        return dense(h, self.w_out.weight)


class Block(nn.Module):
    """One layer: a pre-norm mixer (``attn``, or ``mamba`` at a 'mamba'
    position; the other is None) then (optionally) a pre-norm FFN, dense or
    MoE."""

    def __init__(self, cfg: ModelConfig, pos: int, dtype: torch.dtype):
        super().__init__()
        kind = cfg.pattern[pos]
        if kind not in MIXERS:
            raise ValueError(f"unknown mixer kind {kind!r}")
        self.norm = Norm(cfg.d_model, cfg.norm_type, dtype)
        self.attn = self.mamba = None
        if kind == "mamba":
            self.mamba = ssm.Mamba(cfg.d_model, cfg.ssm_state, cfg.ssm_expand, cfg.ssm_conv,
                                   cfg.ssm_dt_rank, dtype)
        else:
            self.attn = Attention(cfg, dtype)
        self.ffn_norm = self.ffn = None
        if cfg.d_ff > 0:
            kind = cfg.ffn_kind(pos)
            if kind not in ("dense", "moe"):
                raise ValueError(f"unknown ffn kind {kind!r}")
            self.ffn_norm = Norm(cfg.d_model, cfg.norm_type, dtype)
            self.ffn = (MoE(cfg.d_model, cfg.d_ff, cfg.num_experts, dtype) if kind == "moe"
                        else FFN(cfg, dtype))


class Transformer(nn.Module):
    """Token embedding (or the embedding frontend), ``num_layers`` blocks,
    final norm, LM head."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        if cfg.input_mode == "tokens":
            self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype)
        elif cfg.input_mode == "embeddings":
            self.frontend = nn.Linear(cfg.d_model, cfg.d_model, bias=False, dtype=dtype)
        else:
            raise ValueError(f"unknown input_mode {cfg.input_mode!r}")
        self.blocks = nn.ModuleList(
            Block(cfg, layer % cfg.period, dtype) for layer in range(cfg.num_layers)
        )
        self.final_norm = Norm(cfg.d_model, cfg.norm_type, dtype)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, dtype=dtype)


def build(cfg: ModelConfig, device: torch.device | str, dtype: torch.dtype | None = None
          ) -> Transformer:
    """The model with UNINITIALISED storage on ``device`` (built on the meta
    device first, so no time goes into default inits)."""
    with torch.device("meta"):
        model = Transformer(cfg, dtype or _dtype(cfg.param_dtype))
    return model.to_empty(device=device).eval().requires_grad_(False)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: torch.device | str = "cuda",
                dtype: torch.dtype | None = None) -> Transformer:
    """Random weights with the reference's distributions: dense kernels
    (the embedding frontend's and the float32 MoE router's too) N(0,
    1/d_in), MoE ``w_gate``/``w_up`` N(0, 1/d_model) and ``w_out`` N(0,
    1/d_ff), the Mamba mixers' ``ssm.mamba_init_``, embeddings N(0,
    0.02^2), norm scales 1, biases 0.

    ``generator`` must live on ``device`` (default: a fresh one seeded 0);
    ``dtype`` defaults to ``cfg.param_dtype``.  The numbers differ from the
    JAX init for the same seed (``interop.params_from_jax`` carries exact
    weights across)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build(cfg, device, dtype)
    # a Mamba mixer draws its own projections
    mixers = {id(lin) for mod in model.modules() if isinstance(mod, ssm.Mamba)
              for lin in mod.children()}
    for mod in model.modules():
        if isinstance(mod, ssm.Mamba):
            ssm.mamba_init_(mod, generator)
        elif isinstance(mod, nn.Linear) and id(mod) not in mixers:
            mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, Norm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, MoE):
            init_experts_(mod, generator)
    return model


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _embed_input(cfg: ModelConfig, params: Transformer, batch: dict) -> torch.Tensor:
    """(B, S, d_model) in the compute type: the token embedding, or the
    frontend applied to ``batch["embeddings"]`` cast to the compute type."""
    cdt = _dtype(cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        return embed(params.embed.weight, batch["tokens"].long()).to(cdt)
    return dense(batch["embeddings"].to(cdt), params.frontend.weight)


def _self_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, window: int | None, causal: bool) -> torch.Tensor:
    """Self-attention over positions ``arange(S)`` on the lane
    ``resolve_impl`` names for the length."""
    s = q.shape[1]
    impl = attn_lib.resolve_impl(cfg, s)
    if impl == "pallas":
        return kernels_attn.flash_attention(q, k, v, causal, window, cfg.attn_softcap)
    if impl == "flash":
        return attn_lib.flash_attention(q, k, v, causal, window, cfg.attn_softcap,
                                        min(cfg.flash_q_block, s),
                                        min(cfg.flash_kv_block, s))
    if impl == "dense":
        return attn_lib.attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_softcap)
    raise ValueError(f"unknown attn_impl {impl!r}")


def _attn_sublayer(cfg: ModelConfig, ap: Attention, x: torch.Tensor, kind: str,
                   positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, ap, x, positions)
    window = cfg.window if kind == "attn_local" else None
    out = _self_attention(cfg, q, k, v, window, cfg.causal)
    return dense(out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim), ap.o.weight)


def _block_apply(cfg: ModelConfig, kind: str, blk: Block, x: torch.Tensor,
                 positions: torch.Tensor, moe_groups: int
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: the pre-norm mixer (attention, or Mamba over chunks of
    ``cfg.ssm_chunk``), then the pre-norm FFN; ``(x, the layer's MoE aux
    loss)`` (None without a MoE FFN)."""
    h = blk.norm(x)
    if kind == "mamba":
        x = x + ssm.mamba_apply(blk.mamba, h, chunk=cfg.ssm_chunk, remat=cfg.remat)
    else:
        x = x + _attn_sublayer(cfg, blk.attn, h, kind, positions)
    return _ffn(cfg, blk, x, moe_groups)


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor,
               positions: torch.Tensor, moe_groups: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer in order; ``(x, moe_aux)``, the aux loss summed over the
    layers.  Under ``cfg.remat`` each layer is checkpointed where gradients
    are on, outside ``torch.func`` transforms: only its input is kept, and
    the backward runs its forward again."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = cfg.remat and torch.is_grad_enabled() and not in_func_transform()
    for _, p, blk in _layers(cfg, params):
        if ckpt:
            # the forward draws no random numbers: no RNG state to replay
            x, a = checkpoint(_block_apply, cfg, cfg.pattern[p], blk, x, positions,
                              moe_groups, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _block_apply(cfg, cfg.pattern[p], blk, x, positions, moe_groups)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# ---------------------------------------------------------------------------


def _chunk_logits(xc: torch.Tensor, w: torch.Tensor, softcap):
    """float32 logits of one chunk (and the tanh of the cap, or None)."""
    logits = (xc @ w.t()).float()
    if softcap is None:
        return logits, None
    capped = torch.tanh(logits / softcap)
    return capped * softcap, capped


class _XentChunked(torch.autograd.Function):
    """The chunked cross-entropy and its recompute backward.  Under
    ``torch.vmap`` the forward runs once per vmapped index, so each index
    gets its own mean (one mean over the folded rows would mix them); the
    backward is plain ops and runs under the transform as written (it
    accumulates dW out of place)."""

    @staticmethod
    def forward(x, weight, targets, chunk, softcap):
        b, s, _ = x.shape
        w = weight.to(x.dtype)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            logits, _ = _chunk_logits(x[:, i:i + chunk], w, softcap)
            tgt = logits.gather(-1, targets[:, i:i + chunk, None].long())[..., 0]
            loss_sum = loss_sum + (torch.logsumexp(logits, dim=-1) - tgt).sum()
        return loss_sum / (b * s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, targets, chunk, softcap = inputs
        ctx.save_for_backward(x, weight, targets)
        ctx.chunk, ctx.softcap = chunk, softcap

    @staticmethod
    def vmap(info, in_dims, x, weight, targets, chunk, softcap):
        n = info.batch_size
        x, weight, targets = (t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
                              for t, d in zip((x, weight, targets), in_dims))
        return torch.stack([_XentChunked.forward(x[i], weight[i], targets[i], chunk, softcap)
                            for i in range(n)]), 0

    @staticmethod
    def backward(ctx, g):
        x, weight, targets = ctx.saved_tensors
        chunk, softcap = ctx.chunk, ctx.softcap
        b, s, d = x.shape
        scale = g / (b * s)
        w = weight.to(x.dtype)
        dx = torch.empty_like(x)
        # the float32 dW product runs only where the head takes a gradient
        # (the probe pass of the gram tier differentiates w.r.t. probes only)
        dw = (torch.zeros(weight.shape, dtype=torch.float32, device=x.device)
              if ctx.needs_input_grad[1] else None)
        for i in range(0, s, chunk):
            xc = x[:, i:i + chunk]
            logits, capped = _chunk_logits(xc, w, softcap)
            dlogits = torch.softmax(logits, dim=-1)
            # probs - one_hot(targets)
            dlogits.scatter_add_(-1, targets[:, i:i + chunk, None].long(),
                                 torch.full(xc.shape[:2] + (1,), -1.0, device=x.device))
            if capped is not None:
                dlogits = dlogits * (1.0 - capped * capped)
            dlogits = (dlogits * scale).to(x.dtype)
            dx[:, i:i + chunk] = dlogits @ w
            if dw is not None:
                # out of place: under vmap dW is batched, its zeros are not
                dw = torch.addmm(dw, dlogits.reshape(-1, dlogits.shape[-1]).t().float(),
                                 xc.reshape(-1, d).float())
        return dx, None if dw is None else dw.to(weight.dtype), None, None, None


def xent_chunked(x: torch.Tensor, weight: torch.Tensor, targets: torch.Tensor,
                 chunk: int = 512, softcap: float | None = None) -> torch.Tensor:
    """Mean token cross-entropy, chunked over the SEQUENCE axis so the
    (B, S, V) logits never exist at once.

    x (B, S, d); ``weight`` the LM head in ``(V, d)`` layout (the reference
    takes its ``(d, V)`` kernel); targets (B, S) int.  The backward
    recomputes each chunk's logits and accumulates dW in float32: it keeps
    only (x, weight, targets), as the reference's custom_vjp does.  Under
    ``torch.vmap`` each vmapped index gets its own mean."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the xent chunk {chunk}")
    return _XentChunked.apply(x, weight, targets, chunk, softcap)


def loss_fn(cfg: ModelConfig, params: Transformer, batch: dict, moe_groups: int = 1,
            ) -> tuple[torch.Tensor, dict]:
    """Mean CE loss of ``batch`` ({"tokens" (B, S) int, or "embeddings" (B,
    S, d_model); "targets" (B, S) int}), plus ``0.01 * moe_aux`` when
    ``cfg.num_experts`` is set, and ``{"ce_loss", "moe_aux"}`` (the CE alone,
    and the aux loss summed over the layers).  The MoE FFNs route in
    ``moe_groups`` groups of the batch's tokens."""
    x = _embed_input(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_stack(cfg, params, x, positions, moe_groups)
    x = params.final_norm(x)
    loss = xent_chunked(x, params.lm_head.weight, batch["targets"], cfg.xent_chunk,
                        cfg.final_softcap)
    metrics = {"ce_loss": loss, "moe_aux": aux}
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss, metrics


@torch.no_grad()
def prefill_step(cfg: ModelConfig, params: Transformer, batch: dict, moe_groups: int = 1,
                 ) -> tuple[torch.Tensor, dict]:
    """Encode a prompt, ``batch`` ``{"tokens" (B, S)}`` or ``{"embeddings"
    (B, S, d_model)}``, with no paged pool.

    A causal config returns the last position's float32 logits (B, 1, V),
    final softcap included, and the dense cache (``init_cache(cfg, B, S)``
    shapes) holding each layer's last ``_cache_len_for`` keys and values
    (a Mamba layer's final ``h`` and conv tail: S a multiple of
    ``min(ssm_chunk, S)``), with ``len`` S: decode continues from it with
    ``decode_step``.  The stack runs on the lane ``resolve_impl`` names
    ("pallas": the chunk kernel forward).  An encoder (``cfg.causal == False``) returns the
    logits at every position, (B, S, V), and an empty cache, as the
    reference's encoder branch."""
    x = _embed_input(cfg, params, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    if not cfg.causal:
        x, _ = _run_stack(cfg, params, x, positions, moe_groups)
        # the reference's encoder branch: no final softcap
        return dense(params.final_norm(x), params.lm_head.weight).float(), {}
    cache = init_cache(cfg, b, s, device=x.device)
    hd = cfg.resolved_head_dim
    for r, p, blk in _layers(cfg, params):
        entry, h = cache[f"pos{p}"], blk.norm(x)
        if cfg.pattern[p] == "mamba":
            y, state = ssm.mamba_apply(blk.mamba, h, chunk=cfg.ssm_chunk, return_state=True)
            _write_state(entry, r, state)
            x = x + y
        else:
            ap = blk.attn
            q, k, v = _qkv(cfg, ap, h, positions)
            window = cfg.window if cfg.pattern[p] == "attn_local" else None
            h = _self_attention(cfg, q, k, v, window, True)
            x = x + dense(h.reshape(b, s, cfg.num_heads * hd), ap.o.weight)
            kc, vc = entry["k"][r], entry["v"][r]
            s_c = kc.shape[1]
            kc.copy_(k[:, s - s_c:])
            vc.copy_(v[:, s - s_c:])
        x, _ = _ffn(cfg, blk, x, moe_groups)
    cache["len"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return _head(cfg, params, x[:, -1:, :]), cache


# ---------------------------------------------------------------------------
# Serving state
# ---------------------------------------------------------------------------


def _cache_len_for(cfg: ModelConfig, pos: int, seq_len: int) -> int:
    """Keys a per-slot cache of pattern position ``pos`` holds: the window
    for a sliding-window layer (its ring), else the whole context."""
    if cfg.pattern[pos] == "attn_local" and cfg.window is not None:
        return min(cfg.window, seq_len)
    return seq_len


def paged_positions(cfg: ModelConfig) -> tuple[int, ...]:
    """Pattern positions whose KV lives in the block pool when serving paged:
    the full-attention positions.  Windowed rings stay per slot."""
    return tuple(p for p in range(cfg.period) if cfg.pattern[p] == "attn")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, skip: tuple = (),
               device: torch.device | str) -> dict:
    """Per-slot decode state for a context of ``seq_len`` tokens:
    ``{"len": () int32}`` plus, per pattern position not in ``skip``,
    ``{"k", "v"}`` of shape ``(repeats, batch, s_c, KV, hd)`` in the compute
    type, ``s_c = min(window, seq_len)`` for a sliding-window position (a
    ring written at ``pos mod s_c``) and ``seq_len`` for a full-attention one
    (the dense cache); for a Mamba position ``{"h"}`` float32 ``(repeats,
    batch, d_inner, d_state)`` and ``{"conv"}`` ``(repeats, batch, K-1,
    d_inner)`` in the compute type, whatever ``seq_len``.  Paged serving
    skips every full-attention position (its KV is in the pool)."""
    cache: dict = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    cdt = _dtype(cfg.compute_dtype)
    for p in range(cfg.period):
        if p in skip:
            continue
        if cfg.pattern[p] == "mamba":
            d_inner = cfg.ssm_expand * cfg.d_model
            cache[f"pos{p}"] = {
                "h": torch.zeros((cfg.repeats, batch, d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((cfg.repeats, batch, cfg.ssm_conv - 1, d_inner),
                                    dtype=cdt, device=device)}
            continue
        shape = (cfg.repeats, batch, _cache_len_for(cfg, p, seq_len), cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache[f"pos{p}"] = {"k": torch.zeros(shape, dtype=cdt, device=device),
                            "v": torch.zeros(shape, dtype=cdt, device=device)}
    return cache


def init_pages(cfg: ModelConfig, num_blocks: int, block_size: int, *,
               device: torch.device | str) -> dict:
    """The paged KV pool: per full-attention pattern position a
    ``(repeats, num_blocks, block_size, KV, hd)`` pool for k and for v.
    Block 0 is the sentinel: never allocated, the write target of inactive
    lanes."""
    shape = (cfg.repeats, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cdt = _dtype(cfg.compute_dtype)
    return {
        f"pos{p}": {
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
        }
        for p in paged_positions(cfg)
    }


def _layers(cfg: ModelConfig, params: Transformer):
    """(repeat, pattern position, block) in layer order."""
    for r in range(cfg.repeats):
        for p in range(cfg.period):
            yield r, p, params.blocks[r * cfg.period + p]


def _state(entry: dict, r: int) -> dict:
    """Layer ``r``'s Mamba state in a per-position cache entry."""
    return {"h": entry["h"][r], "conv": entry["conv"][r]}


def _write_state(entry: dict, r: int, state: dict) -> None:
    """Write a Mamba layer's new state into slice ``r`` of ``entry``, in
    place (the conv tail in the entry's type)."""
    entry["h"][r].copy_(state["h"])
    entry["conv"][r].copy_(state["conv"])


def _qkv(cfg: ModelConfig, ap: Attention, h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = dense(h, ap.q.weight, ap.q.bias).reshape(b, s, cfg.num_heads, hd)
    k = dense(h, ap.k.weight, ap.k.bias).reshape(b, s, cfg.num_kv_heads, hd)
    v = dense(h, ap.v.weight, ap.v.bias).reshape(b, s, cfg.num_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(cfg: ModelConfig, blk: Block, x: torch.Tensor, moe_groups: int
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The pre-norm FFN sublayer: ``(x + ffn(norm(x)), the MoE aux loss)``
    (None for a dense FFN or none)."""
    if blk.ffn is None:
        return x, None
    h = blk.ffn_norm(x)
    if not isinstance(blk.ffn, MoE):
        return x + blk.ffn(h), None
    if cfg.moe_impl == "ep":
        plan = current_plan()
        if plan is not None and plan.ep:
            raise NotImplementedError(
                "moe_impl='ep' (models/moe_ep.py: the explicit all-to-all over the "
                "expert axis) is not ported to repro_torch yet (ROADMAP.md, Queue A 5)")
    y, aux = moe_apply(blk.ffn, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       groups=moe_groups, act=cfg.ffn_act)
    return x + y, aux


def _head(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = params.final_norm(x)
    logits = dense(x, params.lm_head.weight).float()
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, cache: dict,
                tokens: torch.Tensor, moe_groups: int = 1, *, pages: dict | None = None,
                tables: torch.Tensor | None = None):
    """One token for every row: ``tokens`` (B, 1) int, or (B, 1, d_model)
    embeddings for an embedding-input config.

    ``cache["len"]`` is a scalar (every row at one position, the lockstep
    batch) or a ``(B,)`` vector of per-slot positions.  A Mamba position
    advances its rows' state by one token (``ssm.mamba_decode_step``).  A
    position held in ``cache`` (a sliding-window ring, or the dense cache
    of a full-attention layer) takes the new k/v at ``pos mod s_c`` of its
    row, then the row attends its ``min(pos + 1, s_c)`` valid entries
    (every retained ring slot is inside the window) through the plain
    ``decode_attention``.

    Paged (``pages``/``tables`` given): a full-attention position in
    ``pages`` writes at ``tables[b, pos // block]`` offset ``pos % block``
    and attends its whole context through the fused paged-decode kernel.
    ``tables`` is ``(B, n_max)`` int: slot b's logical block i lives at pool
    block ``tables[b, i]``; inactive lanes point at sentinel block 0
    (written garbage, never read unmasked).

    The cache and the pool are updated IN PLACE (the reference returns new
    ones); the returned dicts hold the same tensors.  Returns (logits
    (B, 1, V) float32, new cache), and the pool after them when paged."""
    key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
    x = _embed_input(cfg, params, {key: tokens})
    b = x.shape[0]
    pos_now = cache["len"]
    posv = pos_now.reshape(b) if pos_now.dim() == 1 else pos_now.expand(b)
    posv = posv.long()
    pages_in = pages if pages is not None else {}
    if pages_in and tables is None:
        raise ValueError("decode_step: paged decode needs the block tables")
    lengths = (posv + 1).to(torch.int32)  # the kernel's type, converted once
    hd = cfg.resolved_head_dim
    rows = torch.arange(b, device=x.device)
    for r, p, blk in _layers(cfg, params):
        name, hn = f"pos{p}", blk.norm(x)
        if cfg.pattern[p] == "mamba":
            y, state = ssm.mamba_decode_step(blk.mamba, _state(cache[name], r), hn)
            _write_state(cache[name], r, state)
            x, _ = _ffn(cfg, blk, x + y, moe_groups)
            continue
        ap = blk.attn
        q, k, v = _qkv(cfg, ap, hn, posv[:, None])
        if name in pages_in:
            pk, pv = pages_in[name]["k"][r], pages_in[name]["v"][r]
            blk_sz, n_max = pk.shape[1], tables.shape[1]
            # a free lane's position keeps counting while it idles; clamp its
            # table column (it writes the sentinel block either way)
            wb = tables[rows, (posv // blk_sz).clamp(max=n_max - 1)]
            off = posv % blk_sz
            # write-then-read, in place on the live pool: this token is
            # visible to its own query.  Plain assignment: duplicate (0, off)
            # targets of inactive lanes race harmlessly on the sentinel block
            pk[wb, off] = k[:, 0]
            pv[wb, off] = v[:, 0]
            h = kernels_attn.paged_decode_attention(
                q, pk, pv, tables, lengths, softcap=cfg.attn_softcap
            )
        else:
            kc, vc = cache[name]["k"][r], cache[name]["v"][r]
            s_c = kc.shape[1]
            slot = posv % s_c  # a full dense cache wraps too, as the reference's
            kc[rows, slot] = k[:, 0]
            vc[rows, slot] = v[:, 0]
            h = attn_lib.decode_attention(q, kc, vc, (posv + 1).clamp(max=s_c),
                                          softcap=cfg.attn_softcap, window=None)
        x = x + dense(h.reshape(b, 1, cfg.num_heads * hd), ap.o.weight)
        x, _ = _ffn(cfg, blk, x, moe_groups)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    logits = _head(cfg, params, x)
    if pages is None:
        return logits, new_cache
    return logits, new_cache, pages


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: Transformer, row: dict, pages: dict,
                  batch: dict, offset: int, prior_tab: torch.Tensor,
                  write_tab: torch.Tensor, moe_groups: int = 1):
    """One chunk of a paged, resumable prefill for a SINGLE request.

    The chunk's queries sit at absolute positions ``offset + arange(C)`` and
    attend causally to the prior context and the chunk's own keys, through
    the chunk-attention kernel:

      * a full-attention position gathers its prior context from the
        request's pool blocks ``prior_tab`` — (nbp,) int in logical order,
        padded with sentinel 0 to a pow2 count; entries past ``offset``
        tokens are masked — and writes the chunk's k/v to the pool at
        ``write_tab`` ((C // block,) int), in place;
      * a sliding-window position reads its ring in ``row`` in
        chronological order (positions ``offset - s_c .. offset - 1``, the
        negative ones invalid), attends under ``cfg.window``, and writes the
        chunk's last ``min(C, s_c)`` keys back into the ring, in place;
      * a Mamba position resumes from its state in ``row`` over chunks of
        ``min(ssm_chunk, C)`` steps (all C at once when that does not divide
        C) and writes the new state back, in place.

    row: ``{"len": (1,)}`` plus the rings and Mamba states
    (``init_cache(cfg, 1, max_seq, skip=paged_positions(cfg))`` shapes).
    batch: ``{"tokens": (1, C)}`` or ``{"embeddings": (1, C, d_model)}``, C
    a multiple of the block size.  Returns (last-position logits (1, 1, V)
    float32, new row, pages)."""
    x = _embed_input(cfg, params, batch)
    c = x.shape[1]
    dev = x.device
    offset = int(offset)
    q_pos = offset + torch.arange(c, dtype=torch.int32, device=dev)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    paged = set(paged_positions(cfg))
    prior_idx = prior_tab.long()
    ones = torch.ones(c, dtype=torch.int32, device=dev)
    keys: dict = {}  # per layout, (k_pos, k_valid) int32 built once per chunk
    sc = min(cfg.ssm_chunk, c)
    if c % sc:  # the scan needs an even split: one chunk of all C
        sc = c
    for r, p, blk in _layers(cfg, params):
        hn = blk.norm(x)
        if cfg.pattern[p] == "mamba":
            entry = row[f"pos{p}"]
            y, state = ssm.mamba_apply(blk.mamba, hn, chunk=sc, return_state=True,
                                       state=_state(entry, r))
            _write_state(entry, r, state)
            x, _ = _ffn(cfg, blk, x + y, moe_groups)
            continue
        ap = blk.attn
        q, k, v = _qkv(cfg, ap, hn, q_pos[None, :])
        if p in paged:  # full attention: prior context from the pool
            pk, pv = pages[f"pos{p}"]["k"][r], pages[f"pos{p}"]["v"][r]
            blk_sz = pk.shape[1]
            prior = prior_idx.numel() * blk_sz
            if "pool" not in keys:
                prior_pos = torch.arange(prior, dtype=torch.int32, device=dev)
                keys["pool"] = (torch.cat([prior_pos, q_pos]),
                                torch.cat([(prior_pos < offset).to(torch.int32), ones]))
            gk = pk[prior_idx].reshape(1, prior, kv, hd)
            gv = pv[prior_idx].reshape(1, prior, kv, hd)
            h = kernels_attn.chunk_attention(
                q, torch.cat([gk, k], dim=1), torch.cat([gv, v], dim=1),
                q_pos, *keys["pool"], window=None, softcap=cfg.attn_softcap,
            )
            pk[write_tab.long()] = k[0].reshape(-1, blk_sz, kv, hd)
            pv[write_tab.long()] = v[0].reshape(-1, blk_sz, kv, hd)
        else:  # sliding window: prior context from the ring
            ring_k, ring_v = row[f"pos{p}"]["k"][r], row[f"pos{p}"]["v"][r]
            s_c = ring_k.shape[1]
            if "ring" not in keys:
                prior_pos = offset - s_c + torch.arange(s_c, dtype=torch.int32, device=dev)
                w = min(c, s_c)  # the chunk's tail that survives into the ring
                keys["ring"] = (torch.cat([prior_pos, q_pos]),
                                torch.cat([(prior_pos >= 0).to(torch.int32), ones]))
                keys["ring_read"] = torch.remainder(prior_pos, s_c).long()
                keys["ring_write"] = torch.remainder(
                    offset + c - w + torch.arange(w, device=dev), s_c)
            idx = keys["ring_read"]
            h = kernels_attn.chunk_attention(
                q, torch.cat([ring_k[:, idx], k], dim=1),
                torch.cat([ring_v[:, idx], v], dim=1),
                q_pos, *keys["ring"], window=cfg.window, softcap=cfg.attn_softcap,
            )
            w = keys["ring_write"].numel()
            ring_k[:, keys["ring_write"]] = k[:, c - w:]
            ring_v[:, keys["ring_write"]] = v[:, c - w:]
        x = x + dense(h.reshape(1, c, cfg.num_heads * hd), ap.o.weight)
        x, _ = _ffn(cfg, blk, x, moe_groups)
    new_row = dict(row)
    new_row["len"] = row["len"] + c
    return _head(cfg, params, x[:, -1:, :]), new_row, pages
