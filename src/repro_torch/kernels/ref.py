"""Plain PyTorch versions of the serving kernels: float32 oracles.

Counterparts of ``attention_ref`` and ``paged_decode_ref`` in
``repro/kernels/ref.py``.  They are what ``kernels/attention.py``'s wrappers
run for a tensor on the CPU, and what the CUDA kernels are held against on
the card: every input is upcast to float32, the softcap comes before the
mask, and the softmax runs over the whole key axis at once.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _repeat(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return torch.repeat_interleave(x, n_rep, dim=2) if n_rep > 1 else x


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      k_valid: torch.Tensor, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention at explicit positions.

    Returns ``(out (B, Sq, H, hd) float32, lse (B, H, Sq) float32)``, where
    ``lse = max + log(max(sum, 1e-30))`` of the masked logits, the row
    statistic the streaming kernel writes beside its output."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    kr = _repeat(k.float(), n_rep)
    vr = _repeat(v.float(), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    rel = q_pos[:, None].long() - k_pos[None, :].long()
    ok = k_valid.bool()[None, :].expand(rel.shape)
    if causal:
        ok = ok & (rel >= 0)
    if window is not None:
        ok = ok & (rel < window)
    logits = torch.where(ok[None, None], logits, torch.full_like(logits, _NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    probs = torch.exp(logits - m)
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs / denom, vr)
    lse = (m + torch.log(denom))[..., 0]
    return out, lse


def attention_ref(q, k, v, q_pos, k_pos, k_valid, *, causal: bool = True,
                  window: int | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    """The output half of :func:`attention_ref_lse` (float32)."""
    return attention_ref_lse(q, k, v, q_pos, k_pos, k_valid, causal=causal,
                             window=window, softcap=softcap)[0]


def paged_decode_ref(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     softcap: float | None = None) -> torch.Tensor:
    """Materialised-gather decode (float32): gather every table entry,
    sentinel and tail included, into a ``(B, n_max*block, KV, hd)`` context,
    then mask each row by its length.

    q: (B, 1, H, hd); pool_k/v: (num_blocks, block, KV, hd); tables:
    (B, n_max) int; lengths: (B,) int.  Returns (B, 1, H, hd) float32."""
    b, n_max = tables.shape
    _, blk, kv, hd = pool_k.shape
    n_rep = q.shape[2] // kv
    idx = tables.reshape(-1).long()
    gk = _repeat(pool_k[idx].reshape(b, n_max * blk, kv, hd).float(), n_rep)
    gv = _repeat(pool_v[idx].reshape(b, n_max * blk, kv, hd).float(), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), gk) * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(n_max * blk, device=q.device)
    ok = pos[None, :] < lengths.reshape(-1, 1).long()  # (B, S)
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", probs, gv)
