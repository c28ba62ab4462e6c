"""Plain PyTorch versions of the kernels: float32 oracles.

Counterparts of ``psgn_ref``, ``psgn_gram_ref``, ``quantize_int8_ref``,
``dequantize_int8_ref``, ``attention_ref`` and ``paged_decode_ref`` in
``repro/kernels/ref.py``, of the flash backward's
recompute (``_recompute_dlogits`` / ``_flash_backward`` in
``repro/kernels/attention.py``), ``psgn_fused_ref``, the sum over
stacked layers ``psgn_fused`` computes, ``split_bf16``, the split of a
float32 operand that the psgn kernels' split route contracts on the tensor
cores, and ``psgn_gram_split_ref``, the gram kernel's split route.  They
are what the wrappers in ``kernels/attention.py``, ``kernels/psgn.py`` and
``kernels/quant.py`` run for a tensor on the CPU, and what the CUDA kernels
are held against on the card: every input is
upcast to float32; in attention the softcap comes before the mask, and the
softmax (or its recompute) runs over the whole key axis at once.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def psgn_ref(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(B,) per-sample ``||X_b^T Delta_b||_F^2`` in float32, forming the
    per-sample gradient (the thing the kernels avoid).  x (B, S, Din),
    delta (B, S, Dout)."""
    g = torch.einsum("bsi,bsj->bij", x.float(), delta.float())
    return (g * g).sum(dim=(1, 2))


def psgn_gram_ref(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The same value through the Gram identity
    ``sum_{t,t'} (x_t . x_t') (d_t . d_t')`` (an independent derivation)."""
    xf, df = x.float(), delta.float()
    gx = torch.einsum("bsi,bti->bst", xf, xf)
    gd = torch.einsum("bsi,bti->bst", df, df)
    return (gx * gd).sum(dim=(1, 2))


def psgn_fused_ref(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(B,) sum over L stacked layers of :func:`psgn_ref`, layer 0 first.
    x (L, B, S, Din), delta (L, B, S, Dout)."""
    total = psgn_ref(x[0], delta[0])
    for layer in range(1, x.shape[0]):
        total = total + psgn_ref(x[layer], delta[layer])
    return total


def _cut(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` cut to its top 16 bits (a bf16 value, held in float32)."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def _bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """The bf16 whose bits are the top half of float32 ``v``'s."""
    return (v.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """(3, *x.shape) bf16 terms hi, mid, lo of float32 ``x``, the split of
    ``csrc/psgn_split.cu`` bit for bit: hi is x cut to its top 16 bits, mid
    the remainder ``x - hi`` cut the same way, lo the remainder of that
    (both subtractions exact in float32).  ``hi + mid + lo == x`` wherever x
    is a multiple of 2^-133, bf16's least subnormal (every ``|x| >=
    2^-110``); below that the sum is x cut toward zero to such a multiple.
    A non-finite x gives (x, 0, 0), a NaN with its quiet bit set."""
    v = x.float().contiguous()
    r = v - _cut(v)
    s = r - _cut(r)
    terms = torch.stack([_bf16_bits(v), _bf16_bits(r), _bf16_bits(s)])
    bad = ~torch.isfinite(v)
    if bad.any():
        hi = (v.view(torch.int32) >> 16) | torch.where(torch.isnan(v), 0x40, 0)
        terms[0] = torch.where(bad, hi.to(torch.int16), terms[0].view(torch.int16)).view(
            torch.bfloat16)
        terms[1:, bad] = 0
    return terms


#: the term pairs (a, b) whose Grams ``V_a V_b^T`` the split route sums for
#: a float32 operand, terms 0, 1, 2 being hi, mid, lo: every pair with a + b
#: <= 2, closed under swapping so the sum stays symmetric; a bf16 operand
#: takes the first, hi.hi, alone
GRAM_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))


def gram_pairs(dtype: torch.dtype) -> tuple[tuple[int, int], ...]:
    """The term pairs an operand's Gram sums on the split route: 6 for
    float32 (:data:`GRAM_PAIRS`), hi.hi alone for bf16."""
    return GRAM_PAIRS if dtype == torch.float32 else GRAM_PAIRS[:1]


def psgn_gram_split_ref(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """(B,) float32: the gram route's split arithmetic, each float32 operand
    split into bf16 terms (:func:`split_bf16`), its Gram the sum of the term
    products of :func:`gram_pairs` in float32 (bf16 products are exact
    there), then ``sum(Gx * Gd)``.  Off :func:`psgn_gram_ref` by the pairs
    left out (mid.lo, lo.mid, lo.lo: below 2^-21 of |v|^2 each) and the
    order of the sums."""
    grams = []
    for v in (x, delta):
        terms = split_bf16(v).float() if v.dtype == torch.float32 else v.float()[None]
        grams.append(sum(torch.einsum("bsi,bti->bst", terms[a], terms[b])
                         for a, b in gram_pairs(v.dtype)))
    return (grams[0] * grams[1]).sum(dim=(1, 2))


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8 of x (R, C): ``(q int8 (R, C), scales f32 (R,))``
    with ``scale = max(absmax, 1e-12) / 127`` and ``q = clip(round(x /
    scale), -127, 127)``, rounding half to even, all in float32.  A NaN
    or an infinity in a row makes its scale NaN or infinite and its codes
    0 (a NaN code casts to 0), as in the reference."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1).clamp_min(1e-12)
    # a tensor divisor: on a card, division by a Python scalar runs as a
    # product with its float32 reciprocal, one ulp off the division
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per row in float32, cast to ``dtype``."""
    return (q.float() * scales[:, None]).to(dtype)


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """``tanh`` taken in float64 and rounded to ``x``'s type: the correctly
    rounded value of every element, whichever float32 tanh path the CPU
    takes in this process.  The plain versions are the oracle the card is
    held against at 1e-4, so their softcap must not move between runs."""
    return torch.tanh(x.double()).to(x.dtype)


def _repeat(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return torch.repeat_interleave(x, n_rep, dim=2) if n_rep > 1 else x


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      k_valid: torch.Tensor, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention at explicit positions.

    The mask is the reference kernel's ``_block_bias``: a valid key, a valid
    query row (``q_pos >= 0``; a padded row attends nothing and comes out as
    the mean of v, whatever the form), ``rel >= 0`` under causality and ``rel
    < window`` where a window is set.  (``repro/kernels/ref.py`` leaves
    padded rows live, which differs only without causality.)  Returns
    ``(out (B, Sq, H, hd) float32, lse (B, H, Sq) float32)``, where ``lse =
    max + log(max(sum, 1e-30))`` of the masked logits, the row statistic the
    streaming kernel writes beside its output."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    kr = _repeat(k.float(), n_rep)
    vr = _repeat(v.float(), n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * hd ** -0.5
    if softcap is not None:
        logits = _tanh(logits / softcap) * softcap
    rel = q_pos[:, None].long() - k_pos[None, :].long()
    ok = k_valid.bool()[None, :] & (q_pos[:, None] >= 0)
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


def flash_grads_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor, dout: torch.Tensor, *,
                    window: int | None = None, softcap: float | None = None,
                    causal: bool = True, q_offset: int = 0,
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash-attention backward from the forward's ``lse`` and
    ``delta = rowsum(dout * out)`` (both (B, H, Sq) float32), causal or
    not: the Sq queries at positions ``q_offset + arange(Sq)`` against the
    Sk keys at ``arange(Sk)`` (self-attention at ``q_offset = 0``, Sk =
    Sq; a context-parallel rank's rows otherwise).

    Follows ``_recompute_dlogits`` and ``_flash_backward`` of
    ``repro/kernels/attention.py``, casts included: dots in float32 from the
    inputs' values, the softcap before the mask, ``p`` forced to 0 where the
    mask is false, ``dlogits`` rounded to q's type before the dq and dk
    products and ``p`` to dout's type before the dv product, per-query-head
    dk/dv summed onto their KV head.  Returns float32 ``(dq (B, Sq, H, hd),
    dk (B, Sk, KV, hd), dv (B, Sk, KV, hd))``; the caller casts."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = hd ** -0.5
    kr = _repeat(k.float(), n_rep)
    vr = _repeat(v.float(), n_rep)
    raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if softcap is not None:
        capped = _tanh(raw / softcap)
        logits = capped * softcap
    else:
        logits = raw
    rel = (torch.arange(sq, device=q.device) + q_offset)[:, None] \
        - torch.arange(sk, device=q.device)[None, :]
    ok = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    if window is not None:
        ok = ok & (rel < window)
    p = torch.where(ok, torch.exp(logits - lse[..., None]), torch.zeros_like(logits))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr)
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - capped * capped)
    ds_q = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q, kr) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_q, q.float()) * scale
    return (dq, dk.reshape(b, sk, kv, n_rep, hd).sum(3),
            dv.reshape(b, sk, kv, n_rep, hd).sum(3))


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout * out)`` in float32, (B, H, S): the backward's
    row statistic, taken outside the kernels as the reference does."""
    return torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float()).contiguous()


def flash_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                       window: int | None = None, softcap: float | None = None,
                       causal: bool = True, q_offset: int = 0,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``(dq, dk, dv)`` of flash attention from its saved ``(q, k,
    v, out, lse)`` and the output gradient (see :func:`flash_grads_ref`)."""
    return flash_grads_ref(q, k, v, lse, flash_delta(out, dout), dout,
                           window=window, softcap=softcap, causal=causal, q_offset=q_offset)


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
        logits = _tanh(logits / softcap) * softcap
    pos = torch.arange(n_max * blk, device=q.device)
    ok = pos[None, :] < lengths.reshape(-1, 1).long()  # (B, S)
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", probs, gv)
