"""Attention kernels: chunk attention, fused paged decode, and flash
attention with its recompute backward.

Wrappers over the hand-written CUDA kernels in ``csrc/`` (built by
``_build.py``), with the signatures and layouts of
``repro/kernels/attention.py``:

  chunk_attention         q (B, C, H, hd), k/v (B, Sk, KV, hd) at explicit
                          absolute positions with a key-validity mask — the
                          chunked-prefill attention.  ``chunk_attention_fwd``
                          also returns the (B, H, C) float32 lse.
  paged_decode_attention  q (B, 1, H, hd) against the shared pool
                          (num_blocks, block, KV, hd) through per-row block
                          tables and lengths, the gather inside the kernel,
                          split over the context by :func:`decode_plan`.
  flash_dq, flash_dkv     the flash backward's two passes for causal
                          self-attention: dq (B, S, H, hd), and dk, dv
                          (B, S, KV, hd) summed over each KV head's query
                          heads, all float32, from the forward's lse and
                          ``delta = rowsum(dout * out)``.
  flash_attention         the training attention: an autograd function whose
                          forward is the chunk kernel at positions
                          ``arange(S)`` and whose backward is the two
                          kernels above.

A tensor on the CPU goes to the plain version (``kernels/ref.py``), cast to
q's type.  A tensor on the card goes to the kernel, or the wrapper raises: a
failed build, a refused launch, an unsupported shape or a card below sm_90
is an error, never a fall back to the plain version.  Each wrapper counts
its kernel launches in a plain integer attribute (``chunk_attention.launches``,
``paged_decode_attention.launches``, ``flash_dq.launches``,
``flash_dkv.launches``), so a run can show that its path went through the
kernels.

The chunk forward, dq and dk/dv have two routes, chosen by
:func:`attention_plan` from the type and head dim before any launch:

  tc   bf16 at head dims 64 and 128: wgmma tensor-core kernels fed by TMA,
       ``csrc/chunk_attention_tc.cu`` (64-row warpgroups, 128-key tiles,
       key tiles skipped by position), ``csrc/flash_dq_tc.cu`` (128 query
       rows over 64-key tiles) and ``csrc/flash_dkv_tc.cu`` (64-key blocks
       over 64-row query tiles);
  fma  float32, and head dim 32: the float32 FMA kernels
       ``csrc/chunk_attention.cu``, ``csrc/flash_dq.cu`` and
       ``csrc/flash_dkv.cu``.

This is a dispatch decided up front, not a fallback: a tensor-core launch
that fails raises.  ``chunk_attention.routes``, ``flash_dq.routes`` and
``flash_dkv.routes`` count launches by route (``{"tc": n, "fma": m}``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_HEAD_DIMS = (32, 64, 128)
#: head dims the tensor-core kernels are instantiated for
TC_HEAD_DIMS = (64, 128)
#: keys the tensor-core chunk kernel lists per block (512 tiles of 128)
TC_MAX_KEYS = 512 * 128
#: the decode kernel's per-thread output registers hold (H / KV) * hd <= this
DECODE_MAX_GROUP = 2048
#: context tokens a decode split takes at least, where the table allows
DECODE_SPLIT_TOKENS = 64


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


def attention_plan(dtype: torch.dtype, hd: int) -> str:
    """The route of a chunk-forward, dq or dk/dv call on the card: "tc"
    (tensor cores) for bf16 at head dims 64 and 128, "fma" (float32 FMA
    kernels) for float32 and for head dim 32.  float32 stays off the tensor
    cores: TF32 would miss the 1e-4 its card tests hold.  Raises for a type
    or head dim that has no kernel."""
    if dtype not in _DTYPES:
        raise TypeError(f"attention: dtype {dtype} has no kernel (float32, bfloat16)")
    if hd not in CHUNK_HEAD_DIMS:
        raise ValueError(f"attention: head dim {hd} has no kernel instance "
                         f"(built: {CHUNK_HEAD_DIMS})")
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "fma"


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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("chunk_attention: q, k and v must share one dtype")
    route = attention_plan(q.dtype, hd)
    if route == "tc" and sk > TC_MAX_KEYS:
        raise ValueError(f"chunk_attention: {sk} keys, the tensor-core kernel takes "
                         f"at most {TC_MAX_KEYS}")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    k_valid = k_valid.to(torch.int32).contiguous()
    _check_cuda("chunk_attention", {"q": q, "k": k, "v": v, "q_pos": q_pos,
                                    "k_pos": k_pos, "k_valid": k_valid}, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, c), dtype=torch.float32, device=q.device)
    name = "chunk_attention_tc" if route == "tc" else "chunk_attention"
    lib = _build.library(name)
    rc = getattr(lib, f"{name}_fwd")(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_pos.data_ptr(), k_pos.data_ptr(), k_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, c, sk, h, kv, hd, hd ** -0.5,
        _cap(softcap), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, name, rc)
    chunk_attention.launches += 1
    chunk_attention.routes[route] += 1
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
chunk_attention.routes = {"tc": 0, "fma": 0}

#: argument types of ``chunk_attention_tc_key_tiles(counts, reset)``
KEY_TILES_ARGTYPES = [ctypes.c_void_p, ctypes.c_int]


def tc_key_tiles(*, reset: bool = False) -> tuple[int, int]:
    """(key tiles listed, key tiles in all), summed over the blocks of every
    tensor-core chunk launch on the current card since the last reset, as
    the kernel's blocks counted them: a listed tile is one a block loaded
    and multiplied, the others it skipped by position.  ``reset`` zeroes the
    counts after the read.  Waits for the card."""
    lib = _build.library("chunk_attention_tc")
    fn = lib.chunk_attention_tc_key_tiles
    fn.argtypes, fn.restype = KEY_TILES_ARGTYPES, ctypes.c_int
    counts = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    rc = fn(counts, int(reset))
    if rc != 0:
        msg = lib.chunk_attention_tc_error(rc).decode()
        raise RuntimeError(f"chunk_attention_tc_key_tiles failed: {msg} (cudaError {rc})")
    return int(counts[0]), int(counts[1])


def decode_plan(b: int, kv: int, n_max: int, blk: int, sms: int) -> int:
    """The number of splits of the paged decode kernel's context: about two
    blocks per SM over the ``b * kv`` (row, KV head) pairs, ``ceil(2 sms /
    (b kv))``, at least 1 and at most the table's groups of
    ``DECODE_SPLIT_TOKENS`` tokens, ``ceil(n_max blk / 64)``.  A pure
    function of shapes: it reads nothing on the card, so it costs no sync."""
    most = math.ceil(n_max * blk / DECODE_SPLIT_TOKENS)
    return max(1, min(math.ceil(2 * sms / (b * kv)), most))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           softcap: float | None = None) -> torch.Tensor:
    """Fused paged decode attention: (B, 1, H, hd) in q's type.

    q (B, 1, H, hd); pool_k/pool_v (num_blocks, block, KV, hd), the SHARED
    pool; tables (B, n_max) int — row b's logical block i lives at pool block
    ``tables[b, i]``, dead entries are the sentinel 0; lengths (B,) int —
    the valid context per row.  Only entries ``i < ceil(length / block)``
    are read, and positions ``>= length`` are masked.  On the card the
    context is split :func:`decode_plan` ways (recorded in
    ``paged_decode_attention.splits``), each split's partial softmax in a
    float32 workspace combined in split order."""
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
    n_max = tables.shape[1]
    splits = decode_plan(b, kv, n_max, blk, _sms(q.device.index))
    out = torch.empty_like(q)
    # the splits' partials: acc (n_rep * hd), then m and l (n_rep each)
    part = torch.empty(b * kv * splits * (h // kv) * (hd + 2) if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    lib = _build.library("paged_decode")
    rc = lib.paged_decode_fwd(
        _DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        b, h, kv, hd, nb, blk, n_max, splits, hd ** -0.5, _cap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "paged_decode", rc)
    paged_decode_attention.launches += 1
    paged_decode_attention.splits = splits
    return out


paged_decode_attention.launches = 0
#: the split count of the last card launch (0 before any)
paged_decode_attention.splits = 0


def _check_backward(name: str, q, k, v, dout, lse, delta) -> None:
    """Shapes of a flash backward call: causal self-attention, so Sk == S."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if k.shape != (b, s, kv, hd) or v.shape != k.shape or dout.shape != q.shape \
            or h % kv:
        raise ValueError(f"{name}: q/dout {tuple(q.shape)}, {tuple(dout.shape)} with "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if lse.shape != (b, h, s) or delta.shape != (b, h, s):
        raise ValueError(f"{name}: lse and delta must be (B, H, S) = {(b, h, s)}")


def _backward_launch(name: str, q, k, v, dout, lse, delta, outs, window, softcap,
                     lib_name: str | None = None):
    """Validate a card call of ``flash_dq``/``flash_dkv`` and launch it from
    library ``lib_name`` (``name`` unless given), entry ``<lib_name>_bwd``."""
    hd = q.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {q.device}")
    if hd not in CHUNK_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} has no kernel instance "
                         f"(built: {CHUNK_HEAD_DIMS})")
    if k.dtype != q.dtype or v.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v and dout must share one dtype")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_cuda(name, {"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
                       "delta": delta}, q.dtype)
    b, s, h, hd = q.shape
    lib_name = lib_name or name
    lib = _build.library(lib_name)
    rc = getattr(lib, f"{lib_name}_bwd")(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, s, h, k.shape[2], hd, hd ** -0.5, _cap(softcap), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, lib_name, rc)


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
             lse: torch.Tensor, delta: torch.Tensor, *, window: int | None = None,
             softcap: float | None = None) -> torch.Tensor:
    """dq of causal flash attention, float32 (B, S, H, hd).

    q, dout (B, S, H, hd); k, v (B, S, KV, hd); ``lse`` the forward's and
    ``delta = rowsum(dout * out)``, both (B, H, S) float32."""
    _check_backward("flash_dq", q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return ref.flash_grads_ref(q, k, v, lse, delta, dout, window=window,
                                   softcap=softcap)[0]
    route = attention_plan(q.dtype, q.shape[-1]) if q.device.type == "cuda" else "fma"
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _backward_launch("flash_dq", q, k, v, dout, lse, delta, (dq,), window, softcap,
                     "flash_dq_tc" if route == "tc" else "flash_dq")
    flash_dq.launches += 1
    flash_dq.routes[route] += 1
    return dq


flash_dq.launches = 0
flash_dq.routes = {"tc": 0, "fma": 0}


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, *, window: int | None = None,
              softcap: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of causal flash attention, float32 (B, S, KV, hd) each,
    summed over the query heads of each KV head.  Arguments as
    :func:`flash_dq`."""
    _check_backward("flash_dkv", q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        _, dk, dv = ref.flash_grads_ref(q, k, v, lse, delta, dout, window=window,
                                        softcap=softcap)
        return dk, dv
    route = attention_plan(q.dtype, q.shape[-1]) if q.device.type == "cuda" else "fma"
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    _backward_launch("flash_dkv", q, k, v, dout, lse, delta, (dk, dv), window, softcap,
                     "flash_dkv_tc" if route == "tc" else "flash_dkv")
    flash_dkv.launches += 1
    flash_dkv.routes[route] += 1
    return dk, dv


flash_dkv.launches = 0
flash_dkv.routes = {"tc": 0, "fma": 0}


class _FlashAttention(torch.autograd.Function):
    """Causal self-attention: the chunk kernel forward at positions
    ``arange(S)`` with every key valid, saving ``(q, k, v, out, lse)``; the
    recompute backward ``delta = rowsum(dout * out)`` (plain torch, as the
    reference does) then the dq and dk/dv kernels.  On the CPU both
    directions take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap):
        s = q.shape[1]
        if k.shape[1] != s:
            raise ValueError(f"flash_attention: self-attention needs Sk == Sq, got "
                             f"{k.shape[1]} and {s}")
        pos = torch.arange(s, dtype=torch.int32, device=q.device)
        valid = torch.ones(s, dtype=torch.int32, device=q.device)
        out, lse = chunk_attention_fwd(q, k, v, pos, pos, valid, window=window,
                                       softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        kw = dict(window=ctx.window, softcap=ctx.softcap)
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_backward_ref(q, k, v, out, lse, dout, **kw)
        else:
            delta = ref.flash_delta(out, dout)
            dq = flash_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = flash_dkv(q, k, v, dout, lse, delta, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Flash self-attention with the recompute backward, (B, S, H, hd) in
    q's type: scale ``hd**-0.5``, the softcap before the causal /
    sliding-window mask, as ``repro/kernels/attention.py::flash_attention``.
    Only the causal form has kernels: ``causal=False`` raises."""
    if not causal:
        raise NotImplementedError(
            "non-causal flash attention (encoder configs) is not ported to "
            "repro_torch yet (ROADMAP.md, Queue B 1)")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 window, softcap)
