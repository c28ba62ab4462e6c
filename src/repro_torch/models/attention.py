"""Plain attention lanes: GQA, logit softcap, causal / sliding-window masks.

Counterpart of the dense functions in ``repro/models/attention.py``, with
the same op order and precision (scores formed in the input type, softmax in
float32, probabilities cast back before the value product):

  * ``attention()``        — materialises (B, H, Sq, Sk) scores.
  * ``flash_attention()``  — streaming softmax over KV blocks with the
                             recompute backward, O(Sq * kv_block) live
                             scores (the reference's XLA "flash" lane).
  * ``chunk_attention()``  — queries and keys at explicit absolute positions
                             with a key-validity mask (chunked prefill).
  * ``decode_attention()`` — single-query attention against a KV cache.

All take q:(B,Sq,H,hd), k/v:(B,Sk,KV,hd) with H % KV == 0 and return
(B,Sq,H,hd).  Query head ``h`` reads KV head ``h // n_rep``.  These are the
plain lanes the kernels in ``kernels/attention.py`` stand in for (the
kernels' own float32 oracles are in ``kernels/ref.py``); ``attention()`` is
also the training path's ``attn_impl="dense"`` lane, differentiated by
autograd, and ``flash_attention()`` its ``attn_impl="flash"`` lane (the one
``"auto"`` takes above ``cfg.flash_threshold``).  The reference runs that lane
in XLA, on no Pallas kernel, so plain PyTorch is its port; the
``"pallas"`` lane is ``kernels/attention.py::flash_attention``, which never
comes here.  ``resolve_impl`` picks the lane for a config.
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


def _flash_forward(q, k, v, causal, window, softcap, q_block, kv_block, q_offset=0):
    """``(out (B, Sq, H, hd), lse (B, nq, H, q_block) float32)``: every query
    block at once (the reference's vmap), a loop over KV blocks carrying the
    running max, denominator and float32 numerator; the queries at
    positions ``q_offset + arange(Sq)``, the keys at ``arange(Sk)``."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    scale = hd ** -0.5
    nq, nk = sq // q_block, sk // kv_block
    qb = q.reshape(b, nq, q_block, h, hd)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, nq, h, q_block), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nq, h, q_block), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, nq, h, q_block, hd), dtype=torch.float32, device=q.device)
    for kj in range(nk):
        sl = slice(kj * kv_block, (kj + 1) * kv_block)
        k_blk, v_blk = _repeat_kv(k[:, sl], n_rep), _repeat_kv(v[:, sl], n_rep)
        k_pos = torch.arange(sl.start, sl.stop, device=q.device)
        logits = torch.einsum("bnqhd,bkhd->bnhqk", qb, k_blk).float() * scale
        logits = _softcap(logits, softcap)
        bias = _mask_bias(q_pos, k_pos, causal, window).reshape(nq, q_block, kv_block)
        logits = logits + bias[None, :, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnhqk,bkhd->bnhqd", p.to(v_blk.dtype), v_blk).float()
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).permute(0, 1, 3, 2, 4).to(q.dtype)
    return out.reshape(b, sq, h, hd), m + torch.log(l_safe)


def _flash_backward(q, k, v, out, lse, dout, causal, window, softcap, q_block, kv_block,
                    q_offset=0):
    """The reference's recompute: ``delta = rowsum(dout * out)``; pass 1 runs
    every query block over the KV blocks for dq, pass 2 every KV block over
    the query blocks for dk and dv (summed onto the KV heads)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = hd ** -0.5
    nq, nk = sq // q_block, sk // kv_block
    qb = q.reshape(b, nq, q_block, h, hd)
    dob = dout.reshape(b, nq, q_block, h, hd)
    ob = out.reshape(b, nq, q_block, h, hd)
    delta = torch.einsum("bnqhd,bnqhd->bnhq", dob.float(), ob.float())
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)

    def dlogits_of(q_blk, k_blk, v_blk, lse_blk, delta_blk, do_blk, bias):
        """p and dlogits of (query blocks) x (key blocks); the blocked axis
        of each operand is 1, the rest as in the reference's tile."""
        raw = torch.einsum("bnqhd,bnkhd->bnhqk", q_blk, k_blk).float() * scale
        if softcap is not None:
            capped = torch.tanh(raw / softcap)
            logits = capped * softcap
        else:
            logits = raw
        logits = logits + bias[None, :, None]
        p = torch.exp(logits - lse_blk[..., None])
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", do_blk, v_blk).float()
        dl = p * (dp - delta_blk[..., None])
        if softcap is not None:
            dl = dl * (1.0 - capped * capped)
        return p, dl

    dq = torch.zeros((b, nq, q_block, h, hd), dtype=torch.float32, device=q.device)
    for kj in range(nk):
        k_blk = _repeat_kv(k[:, kj * kv_block:(kj + 1) * kv_block], n_rep)
        v_blk = _repeat_kv(v[:, kj * kv_block:(kj + 1) * kv_block], n_rep)
        _, dl = dlogits_of(qb, k_blk[:, None].expand(-1, nq, -1, -1, -1),
                           v_blk[:, None].expand(-1, nq, -1, -1, -1), lse, delta, dob,
                           _mask_bias(q_pos, k_pos[kj * kv_block:(kj + 1) * kv_block],
                                      causal, window).reshape(nq, q_block, kv_block))
        dq = dq + torch.einsum("bnhqk,bkhd->bnqhd", dl.to(k_blk.dtype), k_blk).float() * scale
    dq = dq.reshape(b, sq, h, hd).to(q.dtype)

    kb = _repeat_kv(k, n_rep).reshape(b, nk, kv_block, h, hd)
    vb = _repeat_kv(v, n_rep).reshape(b, nk, kv_block, h, hd)
    dk = torch.zeros((b, nk, kv_block, h, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for qi in range(nq):
        q_blk, do_blk = qb[:, qi:qi + 1], dob[:, qi:qi + 1]
        p, dl = dlogits_of(q_blk, kb, vb, lse[:, qi:qi + 1], delta[:, qi:qi + 1],
                           do_blk,
                           _mask_bias(q_pos[qi * q_block:(qi + 1) * q_block], k_pos, causal,
                                      window).reshape(q_block, nk, kv_block).transpose(0, 1))
        dv = dv + torch.einsum("bnhqk,bnqhd->bnkhd", p.to(do_blk.dtype),
                               do_blk.expand(-1, nk, -1, -1, -1)).float()
        dk = dk + torch.einsum("bnhqk,bnqhd->bnkhd", dl.to(q_blk.dtype),
                               q_blk.expand(-1, nk, -1, -1, -1)).float() * scale
    dk = dk.reshape(b, sk, kv, n_rep, hd).sum(3).to(k.dtype)
    dv = dv.reshape(b, sk, kv, n_rep, hd).sum(3).to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The streaming forward, saving ``(q, k, v, out, lse)``; the recompute
    backward.  ``setup_context`` keeps it a new-style function, and both
    directions are plain PyTorch, so ``torch.vmap`` runs them through a
    generated rule (the exact tier's per-sample pass)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window, softcap, q_block, kv_block, q_offset=0):
        return _flash_forward(q, k, v, causal, window, softcap, q_block, kv_block, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *args = inputs  # causal, window, softcap, q_block, kv_block[, q_offset]
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = tuple(args)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, out, lse, dout.contiguous(), *ctx.args),
                *[None] * len(ctx.args))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_block: int = 512,
                    kv_block: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Streaming-softmax attention (B, Sq, H, hd) with the flash recompute
    backward, as the reference's ``flash_attention``: keys at ``arange``,
    queries at ``q_offset + arange`` (a context-parallel rank's rows; 0 in
    self-attention), the softcap before the causal / sliding-window mask,
    probabilities cast to v's type before the value product.  Sq and Sk
    must be multiples of ``q_block`` and ``kv_block``."""
    sq, sk = q.shape[1], k.shape[1]
    if sq % q_block or sk % kv_block:
        raise ValueError(f"flash_attention: Sq {sq} and Sk {sk} must tile by q_block "
                         f"{q_block} and kv_block {kv_block}")
    return _FlashAttention.apply(q, k, v, bool(causal), window, softcap, int(q_block),
                                 int(kv_block), int(q_offset))[0]


def resolve_impl(cfg, s: int) -> str:
    """Resolve ``cfg.attn_impl`` for a length-``s`` self-attention call site,
    as the reference does: 'auto' flips from dense to flash above
    ``cfg.flash_threshold`` when the length tiles by ``cfg.flash_q_block``;
    'dense' / 'flash' / 'pallas' pass through.  'pallas' is the kernel lane
    (``kernels/attention.py``), 'flash' :func:`flash_attention`, 'dense'
    :func:`attention`."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = ("flash" if s > cfg.flash_threshold and s % cfg.flash_q_block == 0
                else "dense")
    return impl
