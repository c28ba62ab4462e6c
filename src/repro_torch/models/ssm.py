"""Mamba-1 (selective SSM) block: parameters, the chunked scan for prefill
and training, and the O(1)-state decode step.

Counterpart of ``repro/models/ssm.py``, the same function step for step.
The recurrence  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t  is linear in
h, so a sequence runs in chunks of ``chunk`` steps: inside a chunk a
log-depth doubling scan (the reference's ``jax.lax.associative_scan``;
``log2(chunk)`` levels of a few elementwise ops over the chunk axis), and a
Python loop over the chunks threads the boundary state, as the reference's
``lax.scan`` does.  Live memory is O(B * chunk * d_inner * d_state).  The
reference runs it in XLA, on no Pallas kernel, and so does the port: plain
PyTorch.

Types, as the reference keeps them: the projections and the depthwise
convolution in the compute type; ``dt``, ``B``, ``C``, the scan and the
state ``h`` in float32; each chunk's ``y`` cast to the compute type before
``+ D * x``; ``y.to(dtype) * silu(z)``.  The doubling scan adds in another
order than JAX's scan, so float32 results agree to rounding, not bit for
bit.

Under autograd the doubling scan keeps two (B, chunk, d_inner, d_state)
float32 tensors a level.  With ``remat`` (``transformer`` passes
``cfg.remat``) each chunk step is checkpointed where gradients are on: only
the boundary ``h`` and the chunk's inputs are kept, and the backward runs
the chunk's scan again.  That changes no result.  Inside a ``torch.func``
transform (the exact tier's per-sample pass) the steps run without the
checkpoint, which torch.func cannot run: that pass keeps every chunk's
scan.

``Mamba`` holds the parameters in the reference's layout: bias-free
``nn.Linear`` ``in_proj``, ``x_proj`` and ``out_proj``, ``dt_proj`` with
its bias, the raw ``conv_kernel`` (K, d_inner) and ``conv_bias``, and
``A_log`` (d_inner, d_state) and ``D`` kept in float32 whatever the
model's type, so ``interop`` carries them without a rule of their own.

Channel-parallel (``mamba_apply_tp``, tensor-parallel training): the SSM is
diagonal over channels, so tp rank t of T runs the mixer on its ``c =
d_inner/T`` channels ``[t c, (t+1) c)`` from the shards the reference's
specs give it (``conv_kernel``, ``conv_bias``, ``A_log``, ``D``, the
columns of ``x_proj`` and ``dt_proj``'s rows: those channels; ``out_proj``
row-parallel).  Two collectives besides Megatron's pair around it:
``in_proj``'s column shard holds the contiguous rows ``[2 t c, 2 (t+1)
c)`` of ``[x | z]``, not the rank's channels, so one exchange over tp
(``dist.plan.permute_blocks``) gives each rank its ``[x_t | z_t]`` rows;
and ``x_proj`` contracts ``d_inner``, so each rank's partial ``(dt_in, B,
C)`` is summed over tp in float32, with a backward that sums too (every
rank's channels read the whole of it).  ``collective_counts`` counts them
by kind.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.plan import permute_blocks
from repro_torch.models.layers import dense, in_func_transform, silu

#: the channel-parallel mixer's collectives, by kind (``collective_counts``): the
#: forwards' ``in_proj`` exchange (by the bytes a rank sends), ``x_proj``
#: all-reduce and ``out_proj`` all-reduce, and in the backward the exchange
#: back and the all-reduces of ``tp.copy`` (the mixer's input and the summed
#: ``x_proj``)
TP_KINDS = ("in_proj_exchange", "x_proj_all_reduce", "out_proj_all_reduce",
            "in_proj_exchange_back", "copy_back")
_TP_COUNTS: dict[str, dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in TP_KINDS}


def collective_counts() -> dict[str, dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` of :data:`TP_KINDS` since the last
    :func:`reset_collective_counts` (a remat recompute issues and counts
    the forward's again)."""
    return {k: dict(v) for k, v in _TP_COUNTS.items()}


def reset_collective_counts() -> None:
    for v in _TP_COUNTS.values():
        v.update(calls=0, bytes=0)


def _count(kind: str, t: torch.Tensor) -> None:
    _TP_COUNTS[kind]["calls"] += 1
    _TP_COUNTS[kind]["bytes"] += t.numel() * t.element_size()


class Mamba(nn.Module):
    """One layer's Mamba mixer (``d_inner = expand * d_model``; ``dt_rank``
    0 means ``ceil(d_model / 16)``)."""

    def __init__(self, d_model: int, d_state: int = 16, expand: int = 2, conv_dim: int = 4,
                 dt_rank: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or max(1, math.ceil(d_model / 16))
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False, dtype=dtype)
        self.conv_kernel = nn.Parameter(torch.empty(conv_dim, d_inner, dtype=dtype))
        self.conv_bias = nn.Parameter(torch.empty(d_inner, dtype=dtype))
        self.x_proj = nn.Linear(d_inner, dt_rank + 2 * d_state, bias=False, dtype=dtype)
        self.dt_proj = nn.Linear(dt_rank, d_inner, bias=True, dtype=dtype)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state, dtype=torch.float32))
        self.D = nn.Parameter(torch.empty(d_inner, dtype=torch.float32))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False, dtype=dtype)


@torch.no_grad()
def mamba_init_(layer: Mamba, generator: torch.Generator | None = None) -> None:
    """The reference's ``mamba_init`` distributions: the projections dense
    N(0, 1/d_in) with a zero ``dt_proj`` bias, ``conv_kernel`` N(0, 1) / K
    (drawn in float32, then cast), a zero ``conv_bias``, ``A_log = log(1 ..
    d_state)`` on every channel and ``D = 1``."""
    for lin in (layer.in_proj, layer.x_proj, layer.dt_proj, layer.out_proj):
        lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
    layer.dt_proj.bias.zero_()
    k, d_inner = layer.conv_kernel.shape
    conv = torch.randn(k, d_inner, generator=generator, device=layer.conv_kernel.device)
    layer.conv_kernel.copy_(conv / k)
    layer.conv_bias.zero_()
    d_state = layer.A_log.shape[1]
    a = torch.arange(1, d_state + 1, dtype=torch.float32, device=layer.A_log.device)
    layer.A_log.copy_(torch.log(a).expand(d_inner, d_state))
    layer.D.fill_(1.0)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 init_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal convolution over (B, L, C), kernel (K, C), in
    ``x``'s type; ``init_state`` (B, K-1, C) is the history before ``x``
    (zeros when None)."""
    k = kernel.shape[0]
    if init_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+K-1, C)
    kernel = kernel.to(x.dtype)
    # summed tap by tap from 0, the reference's order
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(k))
    return out + bias.to(x.dtype)


def _ssm_params(layer: Mamba, x: torch.Tensor, tp=None):
    """x (..., d_inner) -> (dt (..., d_inner), B (..., d_state), C (...,
    d_state)), all float32; the softplus of dt in float32.  Under ``tp``
    x holds the rank's ``c`` channels and the layer their shards: ``x_proj``'s
    partial product summed over tp in float32 and cast once (it rounds as
    the whole product does), behind ``tp.copy`` so that its gradient sums
    too; ``dt`` of the rank's channels, with their part of the replicated
    bias."""
    d_state = layer.A_log.shape[1]
    dt_rank = layer.dt_proj.in_features
    bias = layer.dt_proj.bias
    if tp is None:
        proj = dense(x, layer.x_proj.weight)
    else:
        proj = tp.reduce(dense(x.float(), layer.x_proj.weight))
        _count("x_proj_all_reduce", proj)
        proj = tp.copy(proj, _TP_COUNTS["copy_back"]).to(x.dtype)
        c = x.shape[-1]
        bias = bias.narrow(0, tp.rank * c, c)
    dt_in, b, c = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = dense(dt_in, layer.dt_proj.weight, bias)
    return F.softplus(dt.float()), b.float(), c.float()


def _scan_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """``h_t = a_t * h_{t-1} + bx_t`` within a chunk, from ``h0``.

    a, bx (B, L, d_inner, d_state); h0 (B, d_inner, d_state).  A doubling
    scan over the chunk axis: at d = 1, 2, 4, ... ``b[t] += a[t] * b[t-d]``
    then ``a[t] *= a[t-d]`` (the pairs' associative combine), out of place
    so autograd runs through it.  Returns (h_all (B, L, d_inner, d_state),
    h_last)."""
    n = a.shape[1]
    b = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)  # fold h0
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        if 2 * d < n:  # the last level's products are never read
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def channel_rows(w: torch.Tensor, tp) -> torch.Tensor:
    """tp rank ``tp.rank``'s ``[x_t | z_t]`` rows (2c, d) of ``in_proj``'s
    weight (2 d_inner, d) from its column shard ``w`` (rows ``[2 t c, 2
    (t+1) c)``): cut the whole into 2T blocks of c rows, block j < T the x
    of channels j, block T + j their z; rank t takes blocks t and T + t,
    one exchange over tp (``dist.plan.permute_blocks``, its backward the
    inverse), counted in ``collective_counts``."""
    t = tp.size
    perm = [b for r in range(t) for b in (r, t + r)]
    return permute_blocks(w, perm, tp.mesh, tp.axes, _TP_COUNTS["in_proj_exchange"],
                          _TP_COUNTS["in_proj_exchange_back"])


def _inputs(layer: Mamba, x: torch.Tensor, conv_state: torch.Tensor | None = None, tp=None):
    """``in_proj``, the convolution (after ``conv_state``) and the SSM's
    parameters of x (B, L, d_model): (xi before the convolution, the gate
    z, xi after it, dt, B, C); under ``tp`` on the rank's channels."""
    w = layer.in_proj.weight if tp is None else channel_rows(layer.in_proj.weight, tp)
    xi, z = dense(x, w).chunk(2, dim=-1)
    xc = silu(_causal_conv(xi, layer.conv_kernel, layer.conv_bias, conv_state))
    return (xi, z, xc) + _ssm_params(layer, xc, tp)


def _chunk_step(h: torch.Tensor, a: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, x: torch.Tensor, dtype: torch.dtype):
    """One chunk: discretise (``a_bar = exp(dt * A)``, ``bx = dt * B * x``),
    scan from ``h``, read out ``y = C . h``; (h_last, y in ``dtype``)."""
    a_bar = torch.exp(dt[..., None] * a)  # (B, chunk, d_inner, d_state)
    bx = (dt * x.float())[..., None] * b[..., None, :]
    h_all, h_last = _scan_chunk(a_bar, bx, h)
    y = torch.einsum("blds,bls->bld", h_all, c)
    # the state stays float32 across chunks; each chunk's y is cast, as in
    # the reference
    return h_last, y.to(dtype)


def _scan(layer: Mamba, h: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
          cmat: torch.Tensor, xi: torch.Tensor, chunk: int, remat: bool):
    """The chunk steps over the sequence from the state ``h``: (the final
    state, y (B, L, d_inner) in ``xi``'s type).  With ``remat`` each step
    is checkpointed where gradients are on, outside ``torch.func``
    transforms."""
    a = -torch.exp(layer.A_log.float())  # (d_inner, d_state)
    ckpt = remat and torch.is_grad_enabled() and not in_func_transform()
    ys = []
    for i in range(0, dt.shape[1], chunk):
        args = (h, a, dt[:, i:i + chunk], bmat[:, i:i + chunk], cmat[:, i:i + chunk],
                xi[:, i:i + chunk], xi.dtype)
        if ckpt:
            h, y_c = checkpoint(_chunk_step, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, y_c = _chunk_step(*args)
        ys.append(y_c)
    return h, torch.cat(ys, dim=1)


def mamba_apply(layer: Mamba, x: torch.Tensor, *, chunk: int = 256,
                return_state: bool = False, state: dict | None = None,
                remat: bool = False):
    """The block over ``x`` (B, L, d_model) in chunks of ``min(chunk, L)``
    steps (``L`` a multiple of it, else ValueError, as the reference
    asserts).  ``state`` ({"h" (B, d_inner, d_state) float32, "conv" (B,
    K-1, d_inner)}, as returned with ``return_state=True`` or from
    ``mamba_decode_init``) resumes a sequence mid-stream, so chunked prefill
    gives what one full-length call gives.  ``remat`` checkpoints each chunk
    step where gradients are on.  Returns the output (B, L, d_model), and
    with ``return_state`` the final state too."""
    out, h, xi_preconv = _mix(layer, x, chunk, remat, state)
    if not return_state:
        return out
    dtype = x.dtype
    k = layer.conv_kernel.shape[0]
    if state is not None:  # a chunk shorter than K-1 still needs K-1 rows of history
        xi_preconv = torch.cat([state["conv"].to(dtype), xi_preconv], dim=1)
    return out, {"h": h, "conv": xi_preconv[:, -(k - 1):, :]}


def _mix(layer: Mamba, x: torch.Tensor, chunk: int, remat: bool, state: dict | None = None,
         tp=None):
    """:func:`mamba_apply`'s body: (the output, the final ``h``, xi before
    the convolution); under ``tp`` the rank's channels' partial output."""
    b, l, _ = x.shape
    dtype = x.dtype
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of the ssm chunk {chunk}")
    xi_preconv, z, xi, dt, bmat, cmat = _inputs(
        layer, x, None if state is None else state["conv"], tp)
    d_inner, d_state = layer.A_log.shape
    h = (torch.zeros((b, d_inner, d_state), dtype=torch.float32, device=x.device)
         if state is None else state["h"].float())
    h, y = _scan(layer, h, dt, bmat, cmat, xi, chunk, remat)
    y = y.float() + layer.D * xi.float()
    return dense(y.to(dtype) * silu(z), layer.out_proj.weight), h, xi_preconv


def mamba_apply_tp(layer: Mamba, x: torch.Tensor, tp, *, chunk: int = 256,
                   remat: bool = False) -> torch.Tensor:
    """:func:`mamba_apply` channel-parallel over ``tp``
    (``dist.sharding.TensorParallel``; the module docstring): ``layer``
    holds tp rank ``tp.rank``'s resident shards of its ``c = d_inner/T``
    channels (``dist.sharding.TpSplit.role``; ``dt_proj``'s bias whole),
    ``x`` (B, L, d_model) the normed input, the same on every tp rank.
    ``tp.copy(x)``, the rank's ``[x_t | z_t]`` rows of ``in_proj``
    (:func:`channel_rows`), the convolution, ``x_proj`` summed over tp, the
    scan over its channels, its rows of ``out_proj``, then one all-reduce:
    the whole output on every rank."""
    out, _, _ = _mix(layer, tp.copy(x, _TP_COUNTS["copy_back"]), chunk, remat, tp=tp)
    out = tp.reduce(out)
    _count("out_proj_all_reduce", out)
    return out


def mamba_decode_init(batch: int, d_model: int, d_state: int, expand: int, conv_dim: int,
                      dtype: torch.dtype = torch.float32, *,
                      device: torch.device | str) -> dict:
    """Zero decode state: ``{"h" (B, d_inner, d_state) float32, "conv" (B,
    K-1, d_inner) dtype}``."""
    d_inner = expand * d_model
    return {"h": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, conv_dim - 1, d_inner), dtype=dtype, device=device)}


def mamba_decode_step(layer: Mamba, state: dict, x: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """One token for every row: x (B, 1, d_model) -> (out (B, 1, d_model),
    new state); the state's size does not depend on the context."""
    dtype = x.dtype
    xi, z = dense(x, layer.in_proj.weight).chunk(2, dim=-1)  # (B, 1, d_inner)
    conv_in = torch.cat([state["conv"].to(dtype), xi], dim=1)  # (B, K, d_inner)
    xi = silu((conv_in * layer.conv_kernel.to(dtype)).sum(dim=1, keepdim=True)
              + layer.conv_bias.to(dtype))
    dt, bmat, cmat = _ssm_params(layer, xi)  # (B, 1, .)
    a = -torch.exp(layer.A_log.float())
    a_bar = torch.exp(dt[..., None] * a)[:, 0]  # (B, d_inner, d_state)
    bx = ((dt * xi.float())[..., None] * bmat[..., None, :])[:, 0]
    h = a_bar * state["h"] + bx
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])[:, None, :]  # (B, 1, d_inner)
    y = y + layer.D * xi.float()
    out = dense(y.to(dtype) * silu(z), layer.out_proj.weight)
    return out, {"h": h, "conv": conv_in[:, 1:, :]}
