"""Serving attention kernels: chunk attention and fused paged decode.

Wrappers over the hand-written CUDA kernels in ``csrc/`` (built by
``_build.py``), with the signatures and layouts of
``repro/kernels/attention.py``:

  chunk_attention         q (B, C, H, hd), k/v (B, Sk, KV, hd) at explicit
                          absolute positions with a key-validity mask — the
                          chunked-prefill attention.  ``chunk_attention_fwd``
                          also returns the (B, H, C) float32 lse.
  paged_decode_attention  q (B, 1, H, hd) against the shared pool
                          (num_blocks, block, KV, hd) through per-row block
                          tables and lengths, the gather inside the kernel.

A tensor on the CPU goes to the plain version (``kernels/ref.py``), cast to
q's type.  A tensor on the card goes to the kernel, or the wrapper raises: a
failed build, a refused launch, an unsupported shape or a card below sm_90
is an error, never a fall back to the plain version.  Each wrapper counts
its kernel launches in a plain integer attribute (``chunk_attention.launches``,
``paged_decode_attention.launches``), so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_HEAD_DIMS = (32, 64, 128)
#: the decode kernel's per-thread output registers hold (H / KV) * hd <= this
DECODE_MAX_GROUP = 2048


def _check_cuda(name: str, tensors: dict[str, torch.Tensor], dtype) -> None:
    dev = next(iter(tensors.values())).device
    resolve_device(dev)  # raises below sm_90
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} has no kernel (float32, bfloat16)")


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _cap(softcap: float | None) -> float:
    if softcap is None:
        return 0.0
    if softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return float(softcap)


def chunk_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        k_valid: torch.Tensor, *, window: int | None = None,
                        softcap: float | None = None,
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal streaming attention at explicit positions: ``(out, lse)``.

    q (B, C, H, hd); k, v (B, Sk, KV, hd); q_pos (C,), k_pos (Sk,) absolute
    positions; k_valid (Sk,) — False/0 for padding or garbage key rows.
    Query rows with q_pos < 0 are padding.  Returns out (B, C, H, hd) in q's
    type and lse (B, H, C) float32."""
    b, c, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, hd) or v.shape != k.shape or h % kv:
        raise ValueError(f"chunk_attention: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q_pos.shape != (c,) or k_pos.shape != (sk,) or k_valid.shape != (sk,):
        raise ValueError("chunk_attention: q_pos must be (C,), k_pos and "
                         "k_valid (Sk,)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        out, lse = ref.attention_ref_lse(q, k, v, q_pos, k_pos, k_valid,
                                         causal=True, window=window,
                                         softcap=softcap)
        return out.to(q.dtype), lse
    if q.device.type != "cuda":
        raise ValueError(f"chunk_attention: no path for device {q.device}")
    if hd not in CHUNK_HEAD_DIMS:
        raise ValueError(f"chunk_attention: head dim {hd} has no kernel "
                         f"instance (built: {CHUNK_HEAD_DIMS})")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("chunk_attention: q, k and v must share one dtype")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    k_valid = k_valid.to(torch.int32).contiguous()
    _check_cuda("chunk_attention", {"q": q, "k": k, "v": v, "q_pos": q_pos,
                                    "k_pos": k_pos, "k_valid": k_valid}, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, c), dtype=torch.float32, device=q.device)
    lib = _build.library("chunk_attention")
    rc = lib.chunk_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_pos.data_ptr(), k_pos.data_ptr(), k_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, c, sk, h, kv, hd, hd ** -0.5,
        _cap(softcap), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "chunk_attention", rc)
    chunk_attention.launches += 1
    return out, lse


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    k_valid: torch.Tensor, *, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Causal attention at explicit positions with a key-validity mask (the
    paged chunked-prefill layout): (B, C, H, hd) in q's type."""
    return chunk_attention_fwd(q, k, v, q_pos, k_pos, k_valid, window=window,
                               softcap=softcap)[0]


chunk_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: float | None = None) -> torch.Tensor:
    """Fused paged decode attention: (B, 1, H, hd) in q's type.

    q (B, 1, H, hd); pool_k/pool_v (num_blocks, block, KV, hd), the SHARED
    pool; tables (B, n_max) int — row b's logical block i lives at pool block
    ``tables[b, i]``, dead entries are the sentinel 0; lengths (B,) int —
    the valid context per row.  Only entries ``i < ceil(length / block)``
    are read, and positions ``>= length`` are masked."""
    b, one, h, hd = q.shape
    nb, blk, kv, _ = pool_k.shape
    if one != 1 or pool_k.shape != (nb, blk, kv, hd) or pool_v.shape != pool_k.shape \
            or h % kv:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} with pool "
                         f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_decode_attention: tables must be (B, n_max), "
                         "lengths (B,)")
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, pool_k, pool_v, tables, lengths,
                                    softcap=softcap).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no path for device {q.device}")
    if hd % 8 or (h // kv) * hd > DECODE_MAX_GROUP:
        raise ValueError(f"paged_decode_attention: head dim {hd} with "
                         f"{h // kv} heads per KV head has no kernel instance")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and the pool must share one dtype")
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    _check_cuda("paged_decode_attention",
                {"q": q, "pool_k": pool_k, "pool_v": pool_v, "tables": tables,
                 "lengths": lengths}, q.dtype)
    out = torch.empty_like(q)
    lib = _build.library("paged_decode")
    rc = lib.paged_decode_fwd(
        _DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kv, hd, nb, blk, tables.shape[1], hd ** -0.5, _cap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "paged_decode", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    chunk_attention.launches = 0
    paged_decode_attention.launches = 0


def launch_counts() -> dict[str, int]:
    return {"chunk_attention": chunk_attention.launches,
            "paged_decode_attention": paged_decode_attention.launches}
