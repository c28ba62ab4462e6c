"""Plain attention lanes: GQA, logit softcap, causal / sliding-window masks.

Counterpart of the dense functions in ``repro/models/attention.py``, with
the same op order and precision (scores formed in the input type, softmax in
float32, probabilities cast back before the value product):

  * ``attention()``        — materialises (B, H, Sq, Sk) scores.
  * ``chunk_attention()``  — queries and keys at explicit absolute positions
                             with a key-validity mask (chunked prefill).
  * ``decode_attention()`` — single-query attention against a KV cache.

All take q:(B,Sq,H,hd), k/v:(B,Sk,KV,hd) with H % KV == 0 and return
(B,Sq,H,hd).  Query head ``h`` reads KV head ``h // n_rep``.  These are the
plain lanes the serving kernels in ``kernels/attention.py`` stand in for;
the kernels' own float32 oracles are in ``kernels/ref.py``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int | None) -> torch.Tensor:
    """(Sq, Sk) additive bias: 0 where attendable, NEG_INF where masked."""
    rel = q_pos[:, None] - k_pos[None, :]  # >0 means key in the past
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok = ok & (rel >= 0)
    if window is not None:
        ok = ok & (rel < window)
    zero = torch.zeros((), dtype=torch.float32, device=rel.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _softcap(logits: torch.Tensor, softcap: float | None) -> torch.Tensor:
    if softcap is None:
        return logits
    return torch.tanh(logits / softcap) * softcap


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, q_offset: int = 0) -> torch.Tensor:
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    logits = _softcap(logits, softcap)
    pos_q = torch.arange(sq, device=q.device) + q_offset
    pos_k = torch.arange(k.shape[1], device=q.device)
    logits = logits + _mask_bias(pos_q, pos_k, causal, window)[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    k_valid: torch.Tensor, *, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention: queries at explicit absolute positions over
    keys at explicit absolute positions with a validity mask (prior context
    gathered from pool blocks, then this chunk's own keys)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    logits = _softcap(logits, softcap)
    bias = _mask_bias(q_pos, k_pos, True, window)
    bias = torch.where(k_valid.bool()[None, :], bias, torch.full_like(bias, NEG_INF))
    logits = logits + bias[None, None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor | int, *,
                     softcap: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    k = _repeat_kv(k_cache, h // kv)
    v = _repeat_kv(v_cache, h // kv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    logits = _softcap(logits, softcap)
    pos = torch.arange(s, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < n  # (B, S)
    if window is not None:
        valid = valid & (pos[None, :] >= n - window)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
