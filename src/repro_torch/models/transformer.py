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
  xent_vocab_parallel(x, w_t, v0, targets, chunk, softcap, tp)
  prefill_step(cfg, params, batch)              last logits and the cache
                                                (an encoder: every logit)
  init_cache / init_pages / paged_positions     serving state
  param_specs(cfg) / cache_specs(cfg, B, S)     meta-device stand-ins (the
                                                dry run's; no storage)
  decode_step(cfg, params, cache, tokens, pages=, tables=)
  prefill_chunk(cfg, params, row, pages, batch, offset, prior_tab, write_tab)

MoE FFNs: ``cfg.ffn_kind(pos) == "moe"`` builds ``models/moe.py::MoE``
(the router kept in float32 in any model type) and runs ``moe_apply`` in
``moe_groups`` groups (``loss_fn``, ``prefill_step``, ``decode_step`` and
``prefill_chunk`` take them; serving passes 1, as the reference's engine).
The stack sums the layers' aux losses, and ``loss_fn`` adds ``0.01 * aux``
when ``cfg.num_experts`` is set.  ``cfg.moe_impl == "ep"`` in training
under a rank plan (``use_plan``, read once by ``_run_stack``) whose expert
axes span several ranks takes ``models/moe_ep.py::moe_apply_ep`` (the
experts stay on their ranks, the tokens move by two all-to-alls;
``moe_groups`` is not read, as in the reference); without such a plan,
and inside a ``torch.func`` transform (the exact tier's per-sample pass,
on experts gathered whole), it takes ``moe_apply``.

Sharded training state (``dist.sharding.StateLayout``, a rank rung's):
the parameters are this rank's shards.  ``_run_stack`` gathers each
block's shards whole when the block is entered, inside the remat region,
so the backward gathers again instead of holding every gathered block
(``dist.sharding.gathered``; the gather's backward reduce-scatters the
gradient); without tp ``_model_input`` and ``loss_fn`` gather the
embedding (or frontend) and the head.  Under ``moe_impl="ep"`` the
experts' expert dim stays resident.  Serving (``prefill_step``, ``decode_step``,
``prefill_chunk``, under ``no_grad``, no remat) gathers each block for
its extent only (``_serving_layers``): whole without tp, so a sharded
model never stands whole on a rank; an unsharded model takes the same
path with no gather.

Tensor-parallel training (a sharded state whose plan's tp axes span T > 1
ranks; ``loss_fn`` asks ``_run_stack`` for it, outside ``torch.func``
transforms): each block splits by ``dist.sharding.tp_split``, Megatron-style
on the shards the specs give the rank (tp rank t of T):

  * attention, when ``H % T == 0`` and ``KV % T == 0`` or ``T % KV == 0``:
    query heads ``[t H/T, (t+1) H/T)`` from the rank's column shard of
    ``q``; its ``KV/T`` KV heads from its ``k``/``v`` shards, or, when T
    ranks share each KV head, head ``t // (T/KV)`` of ``k``/``v`` gathered
    whole over tp (their gradient summed back over tp); replicated biases
    (qwen2's) sliced by head after ``copy_to_group``; the attention on the
    lane ``resolve_impl`` names at the local head counts (the three flash
    kernels on the card); ``o`` row-parallel, then the exit;
  * attention context-parallel (Ulysses-style, the reference's ``attn_q``
    / ``attn_kv`` layout), when T does not divide the heads but divides
    ``H hd``, ``KV hd`` and S (qwen2-7b's 28/4 and internvl2-1b's 14/2
    heads at T 16): the rank's ``H hd/T`` columns of ``q`` and ``KV hd/T``
    of ``k``/``v`` over every row (with its columns of a replicated bias),
    one all-to-all trading the q columns for its ``S/T`` query rows
    ``[s0, s1)`` of every head (RoPE at those positions), one all-gather
    joining k and v whole (its backward summed over tp, the rank's columns
    kept), the attention of its rows at ``q_offset = s0`` against the keys
    ``[0, s1)`` (causal; every key without causality) on the lane
    ``resolve_impl`` names for S (the flash kernels at the offset form on
    the card), the out all-to-all trading the rows back for its ``H hd/T``
    columns, then its rows of ``o`` and the exit
    (``_context_attention``); the rows are contiguous, so under causality
    the last rank's rows see the most keys;
  * a dense FFN, and a MoE FFN on ``moe_apply``, when ``ff % T == 0``: the
    rank's ``ff/T`` columns (of every expert: the router stays replicated
    and routes alike on every tp rank), then the exit;
  * a Mamba mixer, when T divides ``d_inner``: the rank's ``c = d_inner/T``
    channels ``[t c, (t+1) c)`` (``models/ssm.py::mamba_apply_tp``): one
    exchange over tp turns its column shard of ``in_proj`` (rows ``[2 t c,
    2 (t+1) c)`` of ``[x | z]``) into its ``[x_t | z_t]`` rows, the
    convolution, ``A_log``, ``D`` and ``dt_proj``'s rows on its channels
    (``dt_proj``'s replicated bias sliced behind ``copy_to_group``),
    ``x_proj``'s partial product summed over tp with a backward that sums
    too, the scan over its channels, its rows of ``out_proj``, then the
    exit.

The residual stream splits too, by ``d_model`` columns, wherever T
divides ``d_model`` (``dist.sharding.residual_split``; the reference's
``residual`` activation spec ``P(dp, None, tp)``): tp rank t holds
columns ``[t d/T, (t+1) d/T)`` between sublayers and across the layer
boundary, so the input ``checkpoint`` keeps of each layer under remat is
``(B, S, d/T)`` (``remat_counts``).  Each pre-norm sublayer enters by one
all-gather of the ranks' columns (``dist.plan.residual_entry``), runs its
norm on the whole x, and a split sublayer leaves by one reduce-scatter of
its row-parallel output to the rank's columns (``residual_exit``: the
all-reduce's bytes in two collectives); the residual adds run on the
rank's columns.  The entry's backward sums the ranks' partial gradients
by a reduce-scatter in front of a split sublayer (each of its products
uses a part of the normed input), so the norm's scale takes a part of its
gradient on each rank and is summed over tp once (``TpSplit.role``
"partial"); the MoE router, which reads the whole normed input alike on
every rank, passes ``tp.shared`` (its gradient divided by T, so the sum
counts it once).  Where T does not divide ``d_model`` the residual stays
whole on every rank (``tp_whole`` "residual") and a split sublayer sits
between ``dist.plan.copy_to_group`` in front of its column-parallel
products and ``reduce_from_group`` after its row-parallel ones.  The
residual collectives are counted by kind in
``dist.plan.residual_counts``.  The input and the head split too, on the
shards the specs give the rank, so no tp rank forms a ``(V, d)`` table
or its gradient whole:

  * the embedding (V over fsdp, d over tp): its tp shard gathered over
    fsdp only, the rank's ``d/T`` columns looked up; the frontend
    (column-parallel): the rank's ``d/T`` output columns; these are its
    residual shard as they are (with the residual whole: one all-gather
    over tp whose backward keeps the rank's columns) (``_model_input``);
  * the head, where T divides V: the final norm on the residual gathered
    by an entry (its scale's gradient summed over tp once), then
    ``xent_vocab_parallel`` on the rank's ``V/T`` rows: per chunk its
    float32 logits (capped), their logsumexp and the target logit where
    the rank holds it, one all-gather over tp of both for the whole row's,
    and in the backward the rank's dx part (summed by the entry's
    reduce-scatter; with the residual whole, ``x = tp.copy(final_norm(x))``
    and its all-reduce) and its rows' dW (``_xent``).

What does not split computes whole on every tp rank from leaves gathered
whole, as without tp: ``moe_impl="ep"`` (the experts' ``ff`` gathered), a
head whose V the tp ranks do not divide, attention whose heads, widths or
length the tp ranks do not divide, and a Mamba mixer whose ``d_inner``
they do not divide.  Under a split residual such a sublayer (or a whole
input or head) enters by an all-gather whose backward keeps the rank's
columns (its gradient is whole and alike on every rank) and leaves
through ``dist.plan.residual_slice``, the rank's columns of its output.
``tp_counts()`` counts, by kind, the sublayers the stack ran split
(``tp_split``: "attn" by heads, "attn_context" context-parallel, "mamba"
by channels) and whole (``tp_whole``) on a tp plan, in training and in
serving, the training stack's residual a layer ("residual"), and the
input and the head per call;
``vocab_parallel_counts()`` the input's and the head's collectives,
``context_parallel_counts()`` the context-parallel exchanges,
``ssm.collective_counts()`` the channel-parallel mixers'; ROADMAP.md Queue
A 5 lists the whole ones as still to port.

Tensor-parallel serving (``prefill_step``, ``decode_step``,
``prefill_chunk`` on a sharded model whose plan spans T > 1 tp ranks):
each block splits by the same ``tp_split`` (``_serving_layers``), so a tp
rank computes its query heads, its KV heads and its FFN columns, and its
pool, rings and dense cache hold only those KV heads
(``dist.sharding.serving_kv_heads``: ``KV/T`` of them "local", the one it
shares, whole, "shared"; every head where attention computes whole);
``o`` and the FFN's output all-reduce over tp, and the residual stream
stays whole (the reference splits it in training only).  The input
splits as in training with the residual whole (``_model_input``: the
embedding's or the frontend's ``d/T`` columns, one all-gather over tp);
the head (V over tp where T divides V)
gives each rank its ``V/T`` float32 logits, capped, and one all-gather
over tp joins them, so every rank samples from the whole row.  Whole on
every tp rank: the Mamba mixers and their state, a head whose V the tp
ranks do not divide, the sublayers ``tp_split`` leaves whole, and
context-parallel attention and the Mamba mixers
(``dist.sharding.serving_split``: prefill at the reference's ``attn_q``
split and the mixers' state at the rank's channels are later items); each
counted in ``tp_whole``.  The caches must hold the rank's KV heads
(``init_cache``/``init_pages(kv_heads=serving_kv_heads(cfg, plan))``);
a split sublayer never falls back to the whole path.

Mamba mixers ('mamba', ``models/ssm.py``): ``Block`` holds a ``Mamba``
in the attention's place, and the layer still runs its FFN (none when
``d_ff == 0``, falcon-mamba's case).  Training runs ``mamba_apply`` over
the sequence in chunks of ``cfg.ssm_chunk`` (``cfg.remat`` checkpoints
each chunk step as well as the layer), or under tp ``mamba_apply_tp`` on
the rank's channels.  Serving keeps a Mamba position's
state per slot and in each prefill job's row, never in the pool:
``{"h" float32 (repeats, B, d_inner, d_state), "conv" (repeats, B, K-1,
d_inner)}`` in the compute type, whatever the context's length.
``prefill_step`` fills it, ``decode_step`` advances it a token, and
``prefill_chunk`` resumes from the row's state in chunks of
``min(ssm_chunk, C)`` steps (``C`` when that does not divide ``C``), as the
reference does; all three write it in place.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.dist.plan import all_gather_dim, all_to_all, current_plan, gather_shards
from repro_torch.kernels import attention as kernels_attn
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm
from repro_torch.models.moe import MoE, init_experts_, moe_apply
from repro_torch.models.moe_ep import expert_parallel, moe_apply_ep
from repro_torch.models.layers import (ACTIVATIONS, apply_rope, dense, embed, in_func_transform,
                                       layer_norm, rms_norm)

#: the mixers the port runs, in training and serving
MIXERS = ("attn", "attn_local", "mamba")

#: sublayers the stack ran split over tp and whole on every tp rank, by
#: kind (forward calls on a tp plan, training or serving), since
#: ``reset_tp_counts``
_TP_COUNTS: dict[str, dict[str, int]] = {"tp_split": {}, "tp_whole": {}}
#: the collectives of the split input and head, by kind, since
#: ``reset_tp_counts`` (``vocab_parallel_counts``)
_VP_COUNTS: dict[str, dict[str, int]] = {
    k: {"calls": 0, "bytes": 0}
    for k in ("input_all_gather", "xent_all_gather", "head_all_reduce")}


def tp_counts() -> dict[str, dict[str, int]]:
    """``{"tp_split": {kind: n}, "tp_whole": {kind: n}}`` since the last
    :func:`reset_tp_counts`: one count per sublayer a forward of the
    training stack or a serving call ran on a tp plan (the remat recompute
    not counted), and per call of the input ("embed" or "frontend") and
    the head, the gram tier's probe pass included; and per layer of the
    training stack its residual stream, "residual" split by columns or
    whole (:func:`dist.sharding.residual_split`)."""
    return {k: dict(v) for k, v in _TP_COUNTS.items()}


def vocab_parallel_counts() -> dict[str, dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` since the last :func:`reset_tp_counts`:
    the all-gather over tp of the split input ("input_all_gather"), the
    cross-entropy's all-gather of the ranks' logsumexps and target logits
    ("xent_all_gather"), both by the gathered output's bytes, and the
    all-reduce of the head's partial dx in the backward
    ("head_all_reduce").  Under a split residual (the training stack's)
    the input enters as the rank's columns and the final entry sums the
    head's dx: neither the input all-gather nor the head all-reduce."""
    return {k: dict(v) for k, v in _VP_COUNTS.items()}


#: the context-parallel attention's collectives, by kind, since
#: ``reset_tp_counts`` (``context_parallel_counts``)
_CP_COUNTS: dict[str, dict[str, int]] = {
    k: {"calls": 0, "bytes": 0} for k in ("q_all_to_all", "kv_all_gather", "out_all_to_all")}


def context_parallel_counts() -> dict[str, dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` since the last :func:`reset_tp_counts`:
    the collectives the forward of a context-parallel attention sublayer
    issues, by the tensor each exchanges: the all-to-all of the rank's q
    columns for its query rows ("q_all_to_all"), the all-gather of k and v
    over tp ("kv_all_gather", by its whole output), the all-to-all of the
    output rows back to columns ("out_all_to_all").  A remat recompute
    issues and counts them again; the backward's inverse exchanges and the
    k/v reduce-scatter are not counted here (``dist.plan.
    record_collectives`` sees every call)."""
    return {k: dict(v) for k, v in _CP_COUNTS.items()}


#: the inputs the training stack hands ``checkpoint`` under remat (layers,
#: storage bytes), since ``reset_remat_counts``
_REMAT_COUNTS = {"layers": 0, "bytes": 0}


def remat_counts() -> dict[str, int]:
    """``{"layers", "bytes"}`` since the last :func:`reset_remat_counts`:
    the layers the stack checkpointed (the remat recompute not counted) and
    the bytes of the storages of their inputs, which the checkpoint keeps
    until the backward (the rank's ``d/T`` columns under a split
    residual)."""
    return dict(_REMAT_COUNTS)


def reset_remat_counts() -> None:
    _REMAT_COUNTS.update(layers=0, bytes=0)


def reset_tp_counts() -> None:
    """Zero the counts above and the channel-parallel Mamba mixers'
    (``ssm.collective_counts``)."""
    for v in _TP_COUNTS.values():
        v.clear()
    for v in (*_VP_COUNTS.values(), *_CP_COUNTS.values()):
        v.update(calls=0, bytes=0)
    ssm.reset_collective_counts()


def _count_vp(kind: str, out: torch.Tensor, counts: dict = _VP_COUNTS) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += out.numel() * out.element_size()


def _count_tp(key: str, kinds) -> None:
    for kind in kinds:
        _TP_COUNTS[key][kind] = _TP_COUNTS[key].get(kind, 0) + 1


def _count_split(split: sharding.TpSplit, stack: bool = False) -> None:
    """Count a block's sublayers: split (attention by heads "attn",
    context-parallel "attn_context", the Mamba mixer by channels "mamba",
    the FFN) and whole; and with ``stack`` (the training stack's) the
    residual stream, "residual" split by columns or whole."""
    attn = [] if not split.attn else ["attn_context" if split.attn == "context" else "attn"]
    _count_tp("tp_split", attn + ["mamba"] * bool(split.ssm) + [split.ffn] * bool(split.ffn))
    _count_tp("tp_whole", split.whole)
    if stack:
        _count_tp("tp_split" if split.residual else "tp_whole", ("residual",))


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

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """The norm of ``x``; under ``tp`` its scale behind ``tp.copy`` (its
        gradient a part on each tp rank, summed once)."""
        scale = self.scale if tp is None else tp.copy(self.scale)
        if self.kind == "rms":
            return rms_norm(x, scale)
        return layer_norm(x, scale)


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


def _whole(params: Transformer, name: str) -> torch.Tensor:
    """Parameter ``name`` whole: gathered under autograd when the state is
    sharded."""
    mod, _, attr = name.rpartition(".")
    t = getattr(params.get_submodule(mod), attr)  # a plain tensor under functional_call
    layout = sharding.layout_of(params)
    return t if layout is None else layout.gather([name], [t])[0]


def _tp_shard(params: Transformer, name: str, tp) -> tuple[torch.Tensor, int | None]:
    """Parameter ``name`` for split compute under ``tp`` (None: whole, as
    ``_whole``): gathered over every axis but the tp axes, and the dim its
    tp shard lies along (None when the specs leave it whole over tp)."""
    if tp is None:
        return _whole(params, name), None
    mod, _, attr = name.rpartition(".")
    t = getattr(params.get_submodule(mod), attr)
    layout = sharding.layout_of(params)
    dim = next((d for d, axes in layout.by_name[name].dims if axes == tp.axes), None)
    roles = {name: "resident"} if dim is not None else None
    return layout.gather([name], [t], roles=roles)[0], dim


def _model_input(cfg: ModelConfig, params: Transformer, batch: dict, tp) -> torch.Tensor:
    """The stack's input, (B, S, d_model) in the compute type: the token
    embedding, or the frontend applied to ``batch["embeddings"]`` cast to
    the compute type; in training and serving.  Under ``tp`` (None: from
    the leaf whole) this rank's ``d/T`` columns, from the embedding's tp
    shard (gathered over fsdp only) looked up, or from its rows of the
    frontend (column-parallel), then one all-gather over tp whose backward
    keeps the rank's columns of the gradient (``dist.plan.gather_shards``:
    the residual stream's gradient is the same on every tp rank).  A leaf
    the specs leave whole over tp computes whole.  Under a split residual
    (``tp.residual``, the training stack's) the rank's columns are its
    residual shard and go in as they are, and a whole leaf's output is
    sliced to them (``tp.own``).  Counted in ``tp_counts`` and
    ``vocab_parallel_counts``."""
    cdt = _dtype(cfg.compute_dtype)
    if cfg.input_mode == "tokens":
        kind, want = "embed", 1
        w, dim = _tp_shard(params, "embed.weight", tp)
        x = embed(w, batch["tokens"].long()).to(cdt)
    else:
        kind, want = "frontend", 0
        w, dim = _tp_shard(params, "frontend.weight", tp)
        x = dense(batch["embeddings"].to(cdt), w)
    if tp is None:
        return x
    if dim is None:
        _count_tp("tp_whole", (kind,))
        return tp.own(x)
    if dim != want:
        raise ValueError(f"{kind} is split over tp along dim {dim}, not d_model")
    _count_tp("tp_split", (kind,))
    if tp.residual:
        return x
    x = gather_shards([x], [[(x.dim() - 1, tp.axes)]], tp.mesh,
                      sharding.layout_of(params).plan.dp)[0]
    _count_vp("input_all_gather", x)
    return x


def _tile(n: int, block: int) -> int:
    """A block size that tiles ``n``: ``min(block, n)`` where that divides
    ``n``, else the largest common divisor of the two."""
    b = min(block, n)
    return b if n % b == 0 else math.gcd(n, block)


def _self_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, window: int | None, causal: bool, q_offset: int = 0,
                    seq: int | None = None) -> torch.Tensor:
    """Attention on the lane ``resolve_impl`` names for the length ``seq``
    (default the queries'): self-attention over positions ``arange(S)``,
    or a context-parallel rank's queries at ``q_offset + arange(S_t)``
    against the keys ``arange(Sk)`` of the sequence of ``seq``."""
    s, sk = q.shape[1], k.shape[1]
    impl = attn_lib.resolve_impl(cfg, seq or s)
    if impl == "pallas":
        return kernels_attn.flash_attention(q, k, v, causal, window, cfg.attn_softcap,
                                            q_offset)
    if impl == "flash":
        if q_offset == 0 and sk == s:
            qb, kb = min(cfg.flash_q_block, s), min(cfg.flash_kv_block, s)
        else:
            qb, kb = _tile(s, cfg.flash_q_block), _tile(sk, cfg.flash_kv_block)
        return attn_lib.flash_attention(q, k, v, causal, window, cfg.attn_softcap, qb, kb,
                                        q_offset)
    if impl == "dense":
        return attn_lib.attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_softcap, q_offset=q_offset)
    raise ValueError(f"unknown attn_impl {impl!r}")


def context_rows(cfg: ModelConfig, s: int, tp) -> tuple[int, int, int]:
    """``(s0, s1, sk)`` of tp rank ``tp.rank`` under context-parallel
    attention over a length-``s`` sequence: its query rows ``[s0, s1)``,
    contiguous ``s/T`` positions (the reference's ``attn_q`` query blocks),
    and the keys ``[0, sk)`` its rows attend: ``s1`` under causality (the
    later keys mask to nothing), every key without."""
    st = s // tp.size
    s0, s1 = tp.rank * st, (tp.rank + 1) * st
    return s0, s1, s1 if cfg.causal else s


def _cols_to_rows(x: torch.Tensor, tp) -> torch.Tensor:
    """(B, S, C) holding this rank's C columns of every row -> (B, S/T, T C)
    holding every rank's columns, in tp order, of this rank's S/T rows: one
    all-to-all over tp (``dist.plan.all_to_all``; its backward the inverse
    exchange), the chunks laid out on dim 0."""
    b, s, c = x.shape
    t = tp.size
    y = all_to_all(x.reshape(b, t, s // t, c).transpose(0, 1).contiguous(), tp.mesh, tp.axes)
    return y.permute(1, 2, 0, 3).reshape(b, s // t, t * c)


def _rows_to_cols(y: torch.Tensor, tp) -> torch.Tensor:
    """The inverse of :func:`_cols_to_rows`: (B, S/T, T C) -> (B, S, C)."""
    b, st, tc = y.shape
    t = tp.size
    c = tc // t
    z = all_to_all(y.reshape(b, st, t, c).permute(2, 0, 1, 3).contiguous(), tp.mesh, tp.axes)
    return z.transpose(0, 1).reshape(b, t * st, c)


def _context_qkv(cfg: ModelConfig, ap: Attention, h: torch.Tensor, positions: torch.Tensor,
                 tp, proj=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S/T, H, hd) of tp rank ``tp.rank``'s query rows ``[s0, s1)``
    with RoPE at ``positions[:, s0:s1]``, and k, v (B, Sk, KV, hd) of the
    keys ``[0, sk)`` (:func:`context_rows`), k with RoPE at every position:
    the rank's resident column shards of ``q``, ``k`` and ``v`` applied to
    every row of ``h`` (``proj(name, h, weight, bias)``, ``dense`` unless
    given: the probe pass's hook) with its columns of the replicated biases,
    then one all-to-all of the q columns for the rows and one all-gather of
    k and v over tp whose backward sums every rank's contribution and keeps
    the rank's columns (``gather_shards(summed=)``: every rank's queries
    attend every key).  Counted in ``context_parallel_counts``."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    s0, s1, sk = context_rows(cfg, s, tp)
    proj = proj or (lambda name, x, w, bias: dense(x, w, bias))

    def cols(name: str, lin) -> torch.Tensor:
        n = lin.weight.shape[0]  # the rank's columns: its resident shard's rows
        bias = None if lin.bias is None else lin.bias.narrow(0, tp.rank * n, n)
        return proj(name, h, lin.weight, bias)

    q = _cols_to_rows(cols("q", ap.q), tp)
    _count_vp("q_all_to_all", q, _CP_COUNTS)
    k, v = gather_shards([cols("k", ap.k), cols("v", ap.v)], [[(2, tp.axes)]] * 2, tp.mesh,
                         (), summed=[True, True])
    _CP_COUNTS["kv_all_gather"]["calls"] += 1
    _CP_COUNTS["kv_all_gather"]["bytes"] += 2 * k.numel() * k.element_size()
    q = apply_rope(q.reshape(b, s1 - s0, cfg.num_heads, hd), positions[:, s0:s1],
                   cfg.rope_theta)
    k = apply_rope(k[:, :sk].reshape(b, sk, cfg.num_kv_heads, hd), positions[:, :sk],
                   cfg.rope_theta)
    return q, k, v[:, :sk].reshape(b, sk, cfg.num_kv_heads, hd)


def _context_out(out: torch.Tensor, tp) -> torch.Tensor:
    """The attention's (B, S/T, H, hd) output rows -> (B, S, H hd/T), the
    rank's columns of every row, for its row shard of ``o`` (one all-to-all;
    counted in ``context_parallel_counts``)."""
    y = _rows_to_cols(out.reshape(*out.shape[:2], -1), tp)
    _count_vp("out_all_to_all", y, _CP_COUNTS)
    return y


def _context_attention(cfg: ModelConfig, ap: Attention, h: torch.Tensor,
                       positions: torch.Tensor, window: int | None, tp) -> torch.Tensor:
    """Context-parallel attention (``TpSplit.attn == "context"``) on ``h``
    (normed, behind ``tp.copy``): :func:`_context_qkv`, the rank's S/T
    query rows at ``q_offset = s0`` against keys ``[0, sk)`` on the lane
    ``resolve_impl`` names for the whole length, :func:`_context_out`, then
    the rank's rows of ``o`` (row-parallel); the caller sums them over tp
    (``tp.exit``)."""
    s = h.shape[1]
    q, k, v = _context_qkv(cfg, ap, h, positions, tp)
    out = _self_attention(cfg, q, k, v, window, cfg.causal, context_rows(cfg, s, tp)[0], s)
    return dense(_context_out(out, tp), ap.o.weight)


def _attn_sublayer(cfg: ModelConfig, ap: Attention, x: torch.Tensor, kind: str,
                   positions: torch.Tensor, tp=None, split: str | None = None
                   ) -> torch.Tensor:
    """The attention sublayer on ``x`` (normed); ``split`` ("local" or
    "shared", ``dist.sharding.TpSplit.attn``) computes rank ``tp.rank``'s
    heads, "context" its query rows of every head
    (:func:`_context_attention`), between ``tp.enter`` and ``tp.exit``
    (the row-parallel ``o`` summed over tp)."""
    b, s, _ = x.shape
    window = cfg.window if kind == "attn_local" else None
    if split is None:
        q, k, v = _qkv(cfg, ap, x, positions)
        out = _self_attention(cfg, q, k, v, window, cfg.causal)
        return dense(out.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim), ap.o.weight)
    if split == "context":
        return tp.exit(_context_attention(cfg, ap, tp.enter(x), positions, window, tp))
    q, k, v = _qkv(cfg, ap, tp.enter(x), positions, tp, split)
    out = _self_attention(cfg, q, k, v, window, cfg.causal)
    return tp.exit(dense(out.reshape(b, s, -1), ap.o.weight))


def _mamba_sublayer(cfg: ModelConfig, mixer: ssm.Mamba, h: torch.Tensor, tp=None,
                    split: sharding.TpSplit | None = None) -> torch.Tensor:
    """The Mamba mixer on ``h`` (normed) in chunks of ``cfg.ssm_chunk``:
    whole, or on tp rank ``tp.rank``'s channels where ``split.ssm`` says
    so (``ssm.mamba_apply_tp``)."""
    if split is not None and split.ssm:
        return ssm.mamba_apply_tp(mixer, h, tp, chunk=cfg.ssm_chunk, remat=cfg.remat)
    return ssm.mamba_apply(mixer, h, chunk=cfg.ssm_chunk, remat=cfg.remat)


def _block_apply(cfg: ModelConfig, kind: str, blk: Block, x: torch.Tensor,
                 positions: torch.Tensor, moe_groups: int, plan=None, tp=None,
                 split: sharding.TpSplit | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: the pre-norm mixer (attention, or Mamba over chunks of
    ``cfg.ssm_chunk``), then the pre-norm FFN; ``(x, the layer's MoE aux
    loss)`` (None without a MoE FFN).  ``tp``/``split``: the sublayers
    ``split`` names run split over tp (``dist.sharding.TensorParallel``).
    Under a split residual ``x`` is the rank's ``d/T`` columns: each
    sublayer's norm reads them gathered whole (``tp.entry``), a split
    sublayer leaves by ``tp.exit`` and a whole one by ``tp.own``, and the
    residual adds run on the rank's columns."""
    mixer = split is not None and bool(split.ssm if kind == "mamba" else split.attn)
    h = blk.norm(_entry(x, tp, mixer))
    if kind == "mamba":
        y = _mamba_sublayer(cfg, blk.mamba, h, tp, split)
    else:
        y = _attn_sublayer(cfg, blk.attn, h, kind, positions, tp,
                           split.attn if split is not None else None)
    x = x + (y if mixer else _own(y, tp))
    return _ffn(cfg, blk, x, moe_groups, plan, tp, split.ffn if split is not None else None)


def _entry(x: torch.Tensor, tp, summed: bool) -> torch.Tensor:
    """``tp.entry``: a sublayer's residual input whole (``x`` without tp)."""
    return x if tp is None else tp.entry(x, summed)


def _own(y: torch.Tensor, tp) -> torch.Tensor:
    """``tp.own``: a whole sublayer's output as the residual holds it."""
    return y if tp is None else tp.own(y)


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor,
               positions: torch.Tensor, moe_groups: int = 1, tp=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer in order; ``(x, moe_aux)``, the aux loss summed over the
    layers.  Under ``cfg.remat`` each layer is checkpointed where gradients
    are on, outside ``torch.func`` transforms: only its input is kept (the
    rank's ``d/T`` columns under a split residual), and the backward runs
    its forward again, its entries' gathers included.  ``tp`` (the training
    stack's, ``loss_fn``'s; None outside ``torch.func`` transforms or
    without a plan spanning several tp ranks): each block splits by
    ``dist.sharding.tp_split`` (the module docstring)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = cfg.remat and torch.is_grad_enabled() and not in_func_transform()
    layout = sharding.layout_of(params)
    # read here, not in the layer: the recompute under remat runs in the
    # backward, on the autograd engine's thread, outside any use_plan
    plan = current_plan()
    for r, p, blk in _layers(cfg, params):
        split = sharding.tp_split(cfg, p, layout.plan, x.shape[1]) if tp is not None else None
        if split is not None:
            _count_split(split, stack=True)
        args = (cfg, cfg.pattern[p], blk, x, positions, moe_groups, layout,
                f"blocks.{r * cfg.period + p}.", plan, tp, split)
        if ckpt:
            _REMAT_COUNTS["layers"] += 1
            _REMAT_COUNTS["bytes"] += x.untyped_storage().nbytes()
            # the forward draws no random numbers: no RNG state to replay
            x, a = checkpoint(_gathered_block, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _gathered_block(*args)
        if a is not None:
            aux = aux + a
    return x, aux


def _gathered_block(cfg: ModelConfig, kind: str, blk: Block, x: torch.Tensor,
                    positions: torch.Tensor, moe_groups: int, layout, prefix: str, plan,
                    tp=None, split=None):
    """``_block_apply`` on the block's parameters gathered whole (a sharded
    state; as they are otherwise), but for the leaves ``split`` keeps on
    the rank."""
    with sharding.gathered(blk, layout, prefix, split=split):
        return _block_apply(cfg, kind, blk, x, positions, moe_groups, plan, tp, split)


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


class _XentVocabParallel(torch.autograd.Function):
    """The chunked cross-entropy over a head split along the vocabulary:
    this tp rank holds rows ``[v0, v0 + V_t)``.  Forward: per chunk the
    rank's float32 logits, their logsumexp and the target's logit where the
    rank holds it (0 elsewhere); one all-gather over tp of both gives the
    whole row's logsumexp (a logsumexp over the ranks') and target logit (a
    sum), the same on every rank.  Backward: per chunk the rank's softmax
    from the saved logsumexp, its dx part (summed over tp by the caller's
    ``tp.copy``) and its rows' dW in float32; no collective."""

    @staticmethod
    def forward(ctx, x, weight, targets, v0, chunk, softcap, tp):
        b, s, _ = x.shape
        w = weight.to(x.dtype)
        rows, owned = _owned_targets(targets, v0, w.shape[0])
        local = torch.empty((1, 2, b, s), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            logits, _ = _chunk_logits(x[:, i:i + chunk], w, softcap)
            local[0, 0, :, i:i + chunk] = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, rows[:, i:i + chunk, None])[..., 0]
            local[0, 1, :, i:i + chunk] = torch.where(owned[:, i:i + chunk], tgt, 0.0)
        parts = all_gather_dim([local], [0], tp.mesh, tp.axes)[0]
        _count_vp("xent_all_gather", parts)
        lse = torch.logsumexp(parts[:, 0], dim=0)
        ctx.save_for_backward(x, weight, targets, lse)
        ctx.v0, ctx.chunk, ctx.softcap = v0, chunk, softcap
        return (lse - parts[:, 1].sum(0)).sum() / (b * s)

    @staticmethod
    def backward(ctx, g):
        x, weight, targets, lse = ctx.saved_tensors
        chunk, softcap = ctx.chunk, ctx.softcap
        b, s, d = x.shape
        scale = g / (b * s)
        w = weight.to(x.dtype)
        rows, owned = _owned_targets(targets, ctx.v0, w.shape[0])
        dx = torch.empty_like(x)
        # the float32 dW product runs only where the head takes a gradient
        dw = (torch.zeros(weight.shape, dtype=torch.float32, device=x.device)
              if ctx.needs_input_grad[1] else None)
        for i in range(0, s, chunk):
            xc = x[:, i:i + chunk]
            logits, capped = _chunk_logits(xc, w, softcap)
            dlogits = torch.exp(logits - lse[:, i:i + chunk, None])
            # probs - one_hot(targets), at the targets this rank holds
            dlogits.scatter_add_(-1, rows[:, i:i + chunk, None],
                                 -owned[:, i:i + chunk, None].float())
            if capped is not None:
                dlogits = dlogits * (1.0 - capped * capped)
            dlogits = (dlogits * scale).to(x.dtype)
            dx[:, i:i + chunk] = dlogits @ w
            if dw is not None:
                dw = torch.addmm(dw, dlogits.reshape(-1, dlogits.shape[-1]).t().float(),
                                 xc.reshape(-1, d).float())
        return (dx, None if dw is None else dw.to(weight.dtype), None, None, None, None, None)


def _owned_targets(targets: torch.Tensor, v0: int, vt: int):
    """``(rows, owned)``: each target's row in the shard ``[v0, v0 + vt)``
    (clamped into it) and whether the shard holds it."""
    t = targets.long() - v0
    return t.clamp(0, vt - 1), (t >= 0) & (t < vt)


def xent_vocab_parallel(x: torch.Tensor, weight: torch.Tensor, v0: int,
                        targets: torch.Tensor, chunk: int, softcap: float | None, tp
                        ) -> torch.Tensor:
    """``xent_chunked`` with the head split along the vocabulary over
    ``tp`` (``dist.sharding.TensorParallel``): ``weight`` is this rank's
    ``(V_t, d)`` rows from ``v0``, ``x`` the same on every tp rank and
    passed through ``tp.copy`` by the caller (the rank's dx is a part).
    Every rank returns the whole mean; dW is the rank's rows'.  Outside
    ``torch.func`` transforms only (no vmap rule)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the xent chunk {chunk}")
    return _XentVocabParallel.apply(x, weight, targets, int(v0), chunk, softcap, tp)


def _xent(cfg: ModelConfig, params: Transformer, x: torch.Tensor, targets: torch.Tensor,
          tp) -> torch.Tensor:
    """The mean CE of the stack's output ``x`` through the final norm:
    ``xent_chunked`` on the whole head, or under ``tp`` (None: whole) where
    the specs split the head's V over tp, ``xent_vocab_parallel`` on the
    rank's rows, the normed ``x`` behind ``tp.copy`` (each rank's dx a
    part); a head whole over tp computes whole.  Under a split residual
    ``x`` is the rank's columns, gathered whole first (``tp.entry``, summed
    back where the head splits, the norm's scale then behind ``tp.copy``).
    Counted in ``tp_counts``."""
    w, dim = _tp_shard(params, "lm_head.weight", tp)
    split = dim is not None
    if tp is None:
        x = params.final_norm(x)
    elif dim not in (None, 0):
        raise ValueError(f"lm_head.weight is split over tp along dim {dim}, not the vocabulary")
    else:
        _count_tp("tp_split" if split else "tp_whole", ("head",))
        if tp.residual:
            x = params.final_norm(tp.entry(x, split), tp if split else None)
        else:
            x = params.final_norm(x)
            if split:
                x = tp.copy(x, _VP_COUNTS["head_all_reduce"])
    if split:
        return xent_vocab_parallel(x, w, tp.rank * w.shape[0], targets, cfg.xent_chunk,
                                   cfg.final_softcap, tp)
    return xent_chunked(x, w, targets, cfg.xent_chunk, cfg.final_softcap)


def loss_fn(cfg: ModelConfig, params: Transformer, batch: dict, moe_groups: int = 1,
            ) -> tuple[torch.Tensor, dict]:
    """Mean CE loss of ``batch`` ({"tokens" (B, S) int, or "embeddings" (B,
    S, d_model); "targets" (B, S) int}), plus ``0.01 * moe_aux`` when
    ``cfg.num_experts`` is set, and ``{"ce_loss", "moe_aux"}`` (the CE alone,
    and the aux loss summed over the layers).  The MoE FFNs route in
    ``moe_groups`` groups of the batch's tokens.  Under tp (the module
    docstring; not inside a ``torch.func`` transform) the input, the stack,
    the residual stream and the head split."""
    tp = sharding.tensor_parallel(sharding.layout_of(params), cfg) \
        if not in_func_transform() else None
    x = _model_input(cfg, params, batch, tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _run_stack(cfg, params, x, positions, moe_groups, tp)
    loss = _xent(cfg, params, x, batch["targets"], tp)
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
    reference's encoder branch.  Under tp (the module docstring) the rank
    computes its heads and columns and its cache holds its KV heads."""
    layout = sharding.layout_of(params)
    tp = sharding.tensor_parallel(layout)
    x = _model_input(cfg, params, batch, tp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, s, device=x.device,
                       kv_heads=serving_kv_heads(cfg, layout and layout.plan)) \
        if cfg.causal else {}
    for r, p, blk, split in _serving_layers(cfg, params, tp):
        entry, h = cache.get(f"pos{p}"), blk.norm(x)
        if cfg.pattern[p] == "mamba":
            y, state = ssm.mamba_apply(blk.mamba, h, chunk=cfg.ssm_chunk, return_state=True)
            if entry is not None:
                _write_state(entry, r, state)
            x = x + y
        else:
            ap, attn = blk.attn, split.attn
            q, k, v = _qkv(cfg, ap, h, positions, tp, attn)
            window = cfg.window if cfg.pattern[p] == "attn_local" else None
            h = _self_attention(cfg, q, k, v, window, cfg.causal)
            x = x + _o_proj(ap, h, tp, attn)
            if entry is not None:
                kc, vc = _held(entry["k"][r], k), _held(entry["v"][r], v)
                s_c = kc.shape[1]
                kc.copy_(k[:, s - s_c:])
                vc.copy_(v[:, s - s_c:])
        x, _ = _ffn(cfg, blk, x, moe_groups, None, tp, split.ffn)
    if not cfg.causal:  # the reference's encoder branch: no final softcap
        return _head(cfg, params, x, tp, softcap=False), {}
    cache["len"] = torch.full((), s, dtype=torch.int32, device=x.device)
    return _head(cfg, params, x[:, -1:, :], tp), cache


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
               device: torch.device | str, kv_heads: int | None = None) -> dict:
    """Per-slot decode state for a context of ``seq_len`` tokens:
    ``{"len": () int32}`` plus, per pattern position not in ``skip``,
    ``{"k", "v"}`` of shape ``(repeats, batch, s_c, KV, hd)`` in the compute
    type, ``s_c = min(window, seq_len)`` for a sliding-window position (a
    ring written at ``pos mod s_c``) and ``seq_len`` for a full-attention one
    (the dense cache); for a Mamba position ``{"h"}`` float32 ``(repeats,
    batch, d_inner, d_state)`` and ``{"conv"}`` ``(repeats, batch, K-1,
    d_inner)`` in the compute type, whatever ``seq_len``.  Paged serving
    skips every full-attention position (its KV is in the pool).
    ``kv_heads``: the KV heads a tp rank holds (``serving_kv_heads``;
    default every head)."""
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
        shape = (cfg.repeats, batch, _cache_len_for(cfg, p, seq_len),
                 cfg.num_kv_heads if kv_heads is None else kv_heads, cfg.resolved_head_dim)
        cache[f"pos{p}"] = {"k": torch.zeros(shape, dtype=cdt, device=device),
                            "v": torch.zeros(shape, dtype=cdt, device=device)}
    return cache


def init_pages(cfg: ModelConfig, num_blocks: int, block_size: int, *,
               device: torch.device | str, kv_heads: int | None = None) -> dict:
    """The paged KV pool: per full-attention pattern position a
    ``(repeats, num_blocks, block_size, KV, hd)`` pool for k and for v
    (``KV`` = ``kv_heads``, a tp rank's count, default every head).  Block
    0 is the sentinel: never allocated, the write target of inactive
    lanes."""
    shape = (cfg.repeats, num_blocks, block_size,
             cfg.num_kv_heads if kv_heads is None else kv_heads, cfg.resolved_head_dim)
    cdt = _dtype(cfg.compute_dtype)
    return {
        f"pos{p}": {
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device),
        }
        for p in paged_positions(cfg)
    }


def param_specs(cfg: ModelConfig) -> Transformer:
    """The model on the ``meta`` device: every parameter's shape and type,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return build(cfg, "meta")


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``init_cache(cfg, batch, seq_len)`` on the ``meta`` device."""
    return init_cache(cfg, batch, seq_len, device="meta")


def _layers(cfg: ModelConfig, params: Transformer):
    """(repeat, pattern position, block) in layer order."""
    for r in range(cfg.repeats):
        for p in range(cfg.period):
            yield r, p, params.blocks[r * cfg.period + p]


def _serving_layers(cfg: ModelConfig, params: Transformer, tp=None):
    """``(repeat, position, block, split)`` in layer order, each block's
    parameters gathered while the caller's loop body runs (a sharded model;
    as they are otherwise): one block at a time stands whole, or under
    ``tp`` (``dist.sharding.tensor_parallel`` of the model's layout) split
    by ``serving_split`` (``tp_split`` with context-parallel attention
    whole), its split leaves kept as the rank's shards (``split`` splits
    nothing without tp).  Counts each block's sublayers in ``tp_counts``."""
    layout = sharding.layout_of(params)
    for r, p, blk in _layers(cfg, params):
        split = sharding.serving_split(cfg, p, layout.plan if tp is not None else None)
        if tp is not None:
            _count_split(split)
        with sharding.gathered(blk, layout, f"blocks.{r * cfg.period + p}.", split=split):
            yield r, p, blk, split


def serving_kv_heads(cfg: ModelConfig, plan=None) -> int:
    """The KV heads an attention layer keeps in this rank's serving caches
    on ``plan``: ``dist.sharding.serving_kv_heads`` where the plan holds
    sharded state (a rank rung: the model serves split over its tp axes),
    every head otherwise (None, a local mesh)."""
    attn = [p for p in range(cfg.period) if cfg.pattern[p] != "mamba"]
    if not attn or not sharding.shards_state(plan):
        return cfg.num_kv_heads
    return sharding.serving_kv_heads(cfg, attn[0], plan)[1]


def _held(cache: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``cache`` (a layer's pool, ring or dense cache, heads on dim -2),
    checked to hold the KV heads of ``new``, the layer's k or v."""
    if cache.shape[-2] != new.shape[-2]:
        raise ValueError(f"a serving cache holds {cache.shape[-2]} KV heads a layer, this "
                         f"rank computes {new.shape[-2]}: build it with kv_heads="
                         f"serving_kv_heads(cfg, plan)")
    return cache


def _state(entry: dict, r: int) -> dict:
    """Layer ``r``'s Mamba state in a per-position cache entry."""
    return {"h": entry["h"][r], "conv": entry["conv"][r]}


def _write_state(entry: dict, r: int, state: dict) -> None:
    """Write a Mamba layer's new state into slice ``r`` of ``entry``, in
    place (the conv tail in the entry's type)."""
    entry["h"][r].copy_(state["h"])
    entry["conv"][r].copy_(state["conv"])


def tp_heads(cfg: ModelConfig, tp, split: str | None) -> tuple[int, int, int, int]:
    """``(first query head, query heads, first KV head, KV heads)`` that
    tp rank ``tp.rank`` computes under ``split`` ("local", "shared"; None:
    every head)."""
    if split is None:
        return 0, cfg.num_heads, 0, cfg.num_kv_heads
    hq = cfg.num_heads // tp.size
    k0, hk = sharding.TpSplit(tp.size, split).kv_heads(cfg.num_kv_heads, tp.rank)
    return tp.rank * hq, hq, k0, hk


def _rows(w: torch.Tensor | None, lo: int, n: int, hd: int) -> torch.Tensor | None:
    """Heads ``[lo, lo + n)`` of a projection's weight or bias (``hd``
    rows a head)."""
    return None if w is None else w.narrow(0, lo * hd, n * hd)


def _qkv(cfg: ModelConfig, ap: Attention, h: torch.Tensor, positions: torch.Tensor,
         tp=None, split: str | None = None):
    """q, k, v with RoPE, (B, S, heads, hd): every head, or under ``split``
    tp rank ``tp.rank``'s (``tp_heads``) from its resident shards of ``q``
    (and of ``k``/``v`` when "local"; the KV head it shares sliced from the
    whole ``k``/``v`` when "shared") and its heads' rows of the biases."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q0, hq, k0, hk = tp_heads(cfg, tp, split)

    def proj(lin, lo: int, n: int, whole_weight: bool) -> torch.Tensor:
        w, bias = lin.weight, lin.bias
        if split is not None:  # the bias is replicated: this rank's heads of it
            bias = _rows(bias, lo, n, hd)
            w = _rows(w, lo, n, hd) if whole_weight else w
        return dense(h, w, bias).reshape(b, s, n, hd)

    q = proj(ap.q, q0, hq, False)
    k = proj(ap.k, k0, hk, split == "shared")
    v = proj(ap.v, k0, hk, split == "shared")
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(cfg: ModelConfig, blk: Block, x: torch.Tensor, moe_groups: int, plan=None,
         tp=None, split: str | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The pre-norm FFN sublayer: ``(x + ffn(norm(x)), the MoE aux loss)``
    (None for a dense FFN or none).  ``plan`` is the training stack's
    plan (``moe_impl="ep"`` routes over its expert ranks); ``split``
    ("dense" or "moe") runs tp rank ``tp.rank``'s ``ff/T`` columns between
    ``tp.enter`` and ``tp.exit``.  Under a split residual the norm reads
    ``x`` gathered whole and a whole FFN leaves by ``tp.own``
    (:func:`_block_apply`)."""
    if blk.ffn is None:
        return x, None
    h = blk.ffn_norm(_entry(x, tp, split is not None))
    if not isinstance(blk.ffn, MoE):
        if split == "dense":
            return x + tp.exit(blk.ffn(tp.enter(h))), None
        return x + _own(blk.ffn(h), tp), None
    if cfg.moe_impl == "ep" and expert_parallel(plan) and not in_func_transform():
        y, aux = moe_apply_ep(blk.ffn, h, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor, act=cfg.ffn_act,
                              mesh=plan.mesh, ep_axes=plan.ep)
        return x + _own(y, tp), aux
    y, aux = moe_apply(blk.ffn, h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       groups=moe_groups, act=cfg.ffn_act,
                       tp=tp if split == "moe" else None)
    return x + (y if split == "moe" else _own(y, tp)), aux


def _o_proj(ap: Attention, h: torch.Tensor, tp=None, split: str | None = None
            ) -> torch.Tensor:
    """The attention's output projection of ``h`` (B, S, heads, hd): every
    head, or under ``split`` the rank's heads' rows, all-reduced over tp."""
    y = dense(h.reshape(*h.shape[:2], -1), ap.o.weight)
    return y if split is None else tp.reduce(y)


def _head(cfg: ModelConfig, params: Transformer, x: torch.Tensor, tp=None,
          softcap: bool = True) -> torch.Tensor:
    """float32 logits of the final-normed ``x``, capped by
    ``cfg.final_softcap`` (``softcap``).  Under ``tp`` (serving) with V
    split over tp: this rank's ``V/T`` logits, then one all-gather over tp;
    a head the specs leave whole over tp computes whole (counted)."""
    x = params.final_norm(x)
    w, dim = _tp_shard(params, "lm_head.weight", tp)
    logits, _ = _chunk_logits(x, w.to(x.dtype), cfg.final_softcap if softcap else None)
    if tp is None:
        return logits
    if dim is None:
        _count_tp("tp_whole", ("head",))
        return logits
    if dim != 0:
        raise ValueError(f"lm_head.weight is split over tp along dim {dim}, not the vocabulary")
    _count_tp("tp_split", ("head",))
    return all_gather_dim([logits], [logits.dim() - 1], tp.mesh, tp.axes)[0]


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
    (B, 1, V) float32, new cache), and the pool after them when paged.
    Under tp (the module docstring) the cache and the pool hold the rank's
    KV heads, and every rank returns the whole logits."""
    key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
    tp = sharding.tensor_parallel(sharding.layout_of(params))
    x = _model_input(cfg, params, {key: tokens}, tp)
    b = x.shape[0]
    pos_now = cache["len"]
    posv = pos_now.reshape(b) if pos_now.dim() == 1 else pos_now.expand(b)
    posv = posv.long()
    pages_in = pages if pages is not None else {}
    if pages_in and tables is None:
        raise ValueError("decode_step: paged decode needs the block tables")
    lengths = (posv + 1).to(torch.int32)  # the kernel's type, converted once
    rows = torch.arange(b, device=x.device)
    for r, p, blk, split in _serving_layers(cfg, params, tp):
        name, hn = f"pos{p}", blk.norm(x)
        if cfg.pattern[p] == "mamba":
            y, state = ssm.mamba_decode_step(blk.mamba, _state(cache[name], r), hn)
            _write_state(cache[name], r, state)
            x, _ = _ffn(cfg, blk, x + y, moe_groups, None, tp, split.ffn)
            continue
        ap, attn = blk.attn, split.attn
        q, k, v = _qkv(cfg, ap, hn, posv[:, None], tp, attn)
        if name in pages_in:
            pk, pv = _held(pages_in[name]["k"][r], k), _held(pages_in[name]["v"][r], v)
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
            kc, vc = _held(cache[name]["k"][r], k), _held(cache[name]["v"][r], v)
            s_c = kc.shape[1]
            slot = posv % s_c  # a full dense cache wraps too, as the reference's
            kc[rows, slot] = k[:, 0]
            vc[rows, slot] = v[:, 0]
            h = attn_lib.decode_attention(q, kc, vc, (posv + 1).clamp(max=s_c),
                                          softcap=cfg.attn_softcap, window=None)
        x = x + _o_proj(ap, h, tp, attn)
        x, _ = _ffn(cfg, blk, x, moe_groups, None, tp, split.ffn)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    logits = _head(cfg, params, x, tp)
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
    float32, new row, pages).  Under tp (the module docstring) the rings
    and the pool hold the rank's KV heads, and every rank returns the
    whole logits."""
    tp = sharding.tensor_parallel(sharding.layout_of(params))
    x = _model_input(cfg, params, batch, tp)
    c = x.shape[1]
    dev = x.device
    offset = int(offset)
    q_pos = offset + torch.arange(c, dtype=torch.int32, device=dev)
    hd = cfg.resolved_head_dim
    paged = set(paged_positions(cfg))
    prior_idx = prior_tab.long()
    ones = torch.ones(c, dtype=torch.int32, device=dev)
    keys: dict = {}  # per layout, (k_pos, k_valid) int32 built once per chunk
    sc = min(cfg.ssm_chunk, c)
    if c % sc:  # the scan needs an even split: one chunk of all C
        sc = c
    for r, p, blk, split in _serving_layers(cfg, params, tp):
        hn = blk.norm(x)
        if cfg.pattern[p] == "mamba":
            entry = row[f"pos{p}"]
            y, state = ssm.mamba_apply(blk.mamba, hn, chunk=sc, return_state=True,
                                       state=_state(entry, r))
            _write_state(entry, r, state)
            x, _ = _ffn(cfg, blk, x + y, moe_groups, None, tp, split.ffn)
            continue
        ap, attn = blk.attn, split.attn
        q, k, v = _qkv(cfg, ap, hn, q_pos[None, :], tp, attn)
        kv = k.shape[2]  # the KV heads this rank computes and holds
        if p in paged:  # full attention: prior context from the pool
            pk, pv = _held(pages[f"pos{p}"]["k"][r], k), _held(pages[f"pos{p}"]["v"][r], v)
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
            ring_k, ring_v = _held(row[f"pos{p}"]["k"][r], k), _held(row[f"pos{p}"]["v"][r], v)
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
        x = x + _o_proj(ap, h, tp, attn)
        x, _ = _ffn(cfg, blk, x, moe_groups, None, tp, split.ffn)
    new_row = dict(row)
    new_row["len"] = row["len"] + c
    return _head(cfg, params, x[:, -1:, :], tp), new_row, pages
