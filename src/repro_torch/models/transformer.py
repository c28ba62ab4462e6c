"""The decoder stack, serving half: parameters, the paged KV pool, paged
decode and chunked prefill.

Counterpart of the serving functions of ``repro/models/transformer.py``.
The reference stacks each pattern position's parameters over a repeats axis
and scans; here the model is an ``nn.Module`` with a ``ModuleList`` of
blocks (layer ``r * period + p`` is repeat ``r`` of pattern position ``p``)
and ``nn.Linear`` weights in ``(out, in)`` layout.  The KV pool keeps the
reference's layout: per full-attention pattern position a
``(repeats, num_blocks, block, KV, hd)`` tensor, so ``pages[...][r]`` is one
layer's contiguous ``(num_blocks, block, KV, hd)`` pool.

Attention always goes through ``kernels/attention.py``: the CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU.

Entry points:
  init_params(cfg, generator, device, dtype)    the model (random weights)
  init_cache / init_pages / paged_positions     serving state
  decode_step(cfg, params, cache, tokens, pages=, tables=)
  prefill_chunk(cfg, params, row, pages, batch, offset, prior_tab, write_tab)

Only the full-attention ('attn') mixer with a dense FFN is ported: the
'attn_local' ring, 'mamba' state and MoE FFNs raise ``NotImplementedError``
(ROADMAP.md, Queue C).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention as kernels_attn
from repro_torch.models.layers import ACTIVATIONS, apply_rope, dense, embed, layer_norm, rms_norm

_NOT_PORTED = {
    "attn_local": "the windowed-ring ('attn_local') serving path",
    "mamba": "the Mamba state serving path",
    "moe": "the MoE FFN",
}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"{_NOT_PORTED.get(kind, repr(kind))} is not ported to repro_torch yet "
        f"(ROADMAP.md, Queue C)"
    )


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
    """One layer: pre-norm attention then (optionally) a pre-norm FFN."""

    def __init__(self, cfg: ModelConfig, pos: int, dtype: torch.dtype):
        super().__init__()
        kind = cfg.pattern[pos]
        if kind != "attn":
            raise _not_ported(kind)
        self.norm = Norm(cfg.d_model, cfg.norm_type, dtype)
        self.attn = Attention(cfg, dtype)
        self.ffn_norm = self.ffn = None
        if cfg.d_ff > 0:
            if cfg.ffn_kind(pos) != "dense":
                raise _not_ported(cfg.ffn_kind(pos))
            self.ffn_norm = Norm(cfg.d_model, cfg.norm_type, dtype)
            self.ffn = FFN(cfg, dtype)


class Transformer(nn.Module):
    """Token embedding, ``num_layers`` blocks, final norm, LM head."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        if cfg.input_mode != "tokens":
            raise NotImplementedError(
                "embedding-input frontends are not ported to repro_torch yet "
                "(ROADMAP.md, Queue C)"
            )
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype)
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
    N(0, 1/d_in), embeddings N(0, 0.02^2), norm scales 1, biases 0.

    ``generator`` must live on ``device`` (default: a fresh one seeded 0);
    ``dtype`` defaults to ``cfg.param_dtype``.  The numbers differ from the
    JAX init for the same seed (``interop.params_from_jax`` carries exact
    weights across)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build(cfg, device, dtype)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, Norm):
            mod.scale.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# Serving state
# ---------------------------------------------------------------------------


def paged_positions(cfg: ModelConfig) -> tuple[int, ...]:
    """Pattern positions whose KV lives in the block pool when serving paged:
    the full-attention positions."""
    return tuple(p for p in range(cfg.period) if cfg.pattern[p] == "attn")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, skip: tuple = (),
               device: torch.device | str) -> dict:
    """Per-slot decode state: ``{"len": () int32}`` plus one entry per
    pattern position not in ``skip``.  Paged serving skips every
    full-attention position (its KV is in the pool); the dense per-slot
    cache, windowed rings and SSM state are not ported."""
    cache: dict = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    for p in range(cfg.period):
        if p in skip:
            continue
        if cfg.pattern[p] != "attn":
            raise _not_ported(cfg.pattern[p])
        raise NotImplementedError("the dense (non-paged) KV cache is not "
                                  "ported to repro_torch (ROADMAP.md, Queue C)")
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
            if cfg.pattern[p] != "attn":
                raise _not_ported(cfg.pattern[p])
            yield r, p, params.blocks[r * cfg.period + p]


def _qkv(cfg: ModelConfig, ap: Attention, h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = dense(h, ap.q.weight, ap.q.bias).reshape(b, s, cfg.num_heads, hd)
    k = dense(h, ap.k.weight, ap.k.bias).reshape(b, s, cfg.num_kv_heads, hd)
    v = dense(h, ap.v.weight, ap.v.bias).reshape(b, s, cfg.num_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _ffn(blk: Block, x: torch.Tensor) -> torch.Tensor:
    if blk.ffn is None:
        return x
    return x + blk.ffn(blk.ffn_norm(x))


def _head(cfg: ModelConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    x = params.final_norm(x)
    logits = dense(x, params.lm_head.weight).float()
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Transformer, cache: dict,
                tokens: torch.Tensor, *, pages: dict, tables: torch.Tensor):
    """One token for every slot against the paged pool.

    tokens: (B, 1) int.  ``cache["len"]`` is a scalar or a ``(B,)`` vector of
    per-slot positions.  ``tables`` is ``(B, n_max)`` int: slot b's logical
    block i lives at pool block ``tables[b, i]``.  Each row writes its new
    k/v at ``tables[b, pos // block]`` offset ``pos % block`` and then
    attends to its whole context, this token included.  Inactive lanes point
    at sentinel block 0 (written garbage, never read unmasked).

    The pool is updated IN PLACE (the reference returns a new pool); the
    returned ``pages`` is the same dict.  Returns (logits (B, 1, V) float32,
    new cache, pages)."""
    if pages is None or tables is None:
        raise NotImplementedError("decode against the dense (non-paged) KV "
                                  "cache is not ported (ROADMAP.md, Queue C)")
    x = embed(params.embed.weight, tokens).to(_dtype(cfg.compute_dtype))
    b = x.shape[0]
    pos_now = cache["len"]
    posv = pos_now.reshape(b) if pos_now.dim() == 1 else pos_now.expand(b)
    posv = posv.long()
    lengths = (posv + 1).to(torch.int32)  # the kernel's type, converted once
    hd = cfg.resolved_head_dim
    rows = torch.arange(b, device=x.device)
    n_max = tables.shape[1]
    for r, p, blk in _layers(cfg, params):
        ap = blk.attn
        q, k, v = _qkv(cfg, ap, blk.norm(x), posv[:, None])
        pk, pv = pages[f"pos{p}"]["k"][r], pages[f"pos{p}"]["v"][r]
        blk_sz = pk.shape[1]
        # a free lane's position keeps counting while it idles; clamp its
        # table column (it writes the sentinel block either way)
        wb = tables[rows, (posv // blk_sz).clamp(max=n_max - 1)]
        off = posv % blk_sz
        # write-then-read, in place on the live pool: this token is visible
        # to its own query.  Plain assignment: duplicate (0, off) targets of
        # inactive lanes race harmlessly on the never-read sentinel block
        pk[wb, off] = k[:, 0]
        pv[wb, off] = v[:, 0]
        h = kernels_attn.paged_decode_attention(
            q, pk, pv, tables, lengths, softcap=cfg.attn_softcap
        )
        x = x + dense(h.reshape(b, 1, cfg.num_heads * hd), ap.o.weight)
        x = _ffn(blk, x)
    new_cache = dict(cache)
    new_cache["len"] = cache["len"] + 1
    return _head(cfg, params, x), new_cache, pages


@torch.no_grad()
def prefill_chunk(cfg: ModelConfig, params: Transformer, row: dict, pages: dict,
                  batch: dict, offset: int, prior_tab: torch.Tensor,
                  write_tab: torch.Tensor):
    """One chunk of a paged, resumable prefill for a SINGLE request.

    The chunk's queries sit at absolute positions ``offset + arange(C)`` and
    attend causally to (a) the prior context gathered from the request's
    pool blocks ``prior_tab`` — (nbp,) int in logical order, padded with
    sentinel 0 to a pow2 count; entries past ``offset`` tokens are masked —
    and (b) the chunk's own keys.  Then the chunk's k/v are written to the
    pool at ``write_tab`` ((C // block,) int), in place.

    row: ``{"len": (1,)}`` (full-attention positions carry no row state).
    batch: ``{"tokens": (1, C)}``, C a multiple of the block size.
    Returns (last-position logits (1, 1, V) float32, new row, pages)."""
    x = embed(params.embed.weight, batch["tokens"]).to(_dtype(cfg.compute_dtype))
    c = x.shape[1]
    dev = x.device
    q_pos = int(offset) + torch.arange(c, dtype=torch.int32, device=dev)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    prior_idx = prior_tab.long()
    k_pos = k_valid = None
    for r, p, blk in _layers(cfg, params):
        ap = blk.attn
        q, k, v = _qkv(cfg, ap, blk.norm(x), q_pos[None, :])
        pk, pv = pages[f"pos{p}"]["k"][r], pages[f"pos{p}"]["v"][r]
        blk_sz = pk.shape[1]
        prior = prior_idx.numel() * blk_sz
        if k_pos is None:  # int32, the kernel's types, built once per chunk
            prior_pos = torch.arange(prior, dtype=torch.int32, device=dev)
            k_pos = torch.cat([prior_pos, q_pos])
            k_valid = torch.cat([(prior_pos < int(offset)).to(torch.int32),
                                 torch.ones(c, dtype=torch.int32, device=dev)])
        gk = pk[prior_idx].reshape(1, prior, kv, hd)
        gv = pv[prior_idx].reshape(1, prior, kv, hd)
        h = kernels_attn.chunk_attention(
            q, torch.cat([gk, k], dim=1), torch.cat([gv, v], dim=1),
            q_pos, k_pos, k_valid, window=None, softcap=cfg.attn_softcap,
        )
        x = x + dense(h.reshape(1, c, cfg.num_heads * hd), ap.o.weight)
        pk[write_tab.long()] = k[0].reshape(-1, blk_sz, kv, hd)
        pv[write_tab.long()] = v[0].reshape(-1, blk_sz, kv, hd)
        x = _ffn(blk, x)
    new_row = dict(row)
    new_row["len"] = row["len"] + c
    return _head(cfg, params, x[:, -1:, :]), new_row, pages
