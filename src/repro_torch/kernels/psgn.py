"""Per-sample gradient squared norms of dense layers.

For a dense layer ``y = x @ W`` applied over a sequence, the per-sample
gradient is ``G_b = X_b^T Delta_b`` (Din, Dout), from the saved input
activation and the upstream output gradient (which the probe trick of
``models/probes.py`` delivers).  DiveBatch needs ``||G_b||_F^2``, never
``G_b`` itself.  Counterpart of ``repro/kernels/psgn.py``; wrappers over the
hand-written CUDA kernels in ``csrc/psgn_direct.cu`` and ``csrc/psgn_gram.cu``
(built by ``_build.py``):

  psgn_direct  ||X^T D||_F^2 tile by tile, a loop over S inside each
               (Din, Dout) tile: x (B, S, Din), delta (B, S, Dout).
  psgn_gram    the same value as sum_{t,t'} (x_t . x_t')(d_t . d_t'), tile
               pairs of sequence positions, each contracting the full widths.
  psgn_fused   the sum over L stacked same-shape layers of psgn_direct, in
               one launch: x (L, B, S, Din), delta (L, B, S, Dout).

Each returns (B,) float32; inputs are float32 or bfloat16 (x and delta may
differ) and the products accumulate in float32.  The block keywords keep the
reference's signatures: they tile the TPU kernels, not these (the CUDA
kernels tile 128 x 128, :data:`TILE`).

A tensor on the CPU goes to the plain version (``kernels/ref.py``).  A
tensor on the card goes to the kernel, or the wrapper raises: a failed build,
a refused launch, an unsupported type or a card below sm_90 is an error,
never a fall back to the plain version.  Each wrapper counts its kernel
launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.attention import _DTYPES, _check_cuda, _raise_on

#: the CUDA kernels' output tile (``kTile`` in ``csrc/psgn_tile.cuh``); it
#: sizes the per-sample partials the kernels write
TILE = 128


def _check_pair(name: str, x: torch.Tensor, delta: torch.Tensor, ndim: int) -> None:
    if x.dim() != ndim or delta.dim() != ndim or x.shape[:-1] != delta.shape[:-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and delta {tuple(delta.shape)} "
                         f"must be {ndim}-D and agree on all but the last axis")
    if 0 in x.shape or 0 in delta.shape:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}, {tuple(delta.shape)}")


def _launch(name: str, lib_name: str, x: torch.Tensor, delta: torch.Tensor,
            dims: tuple[int, ...], n_partials: int) -> torch.Tensor:
    """Validate a card call and launch the entry of library ``lib_name`` on
    (x, delta), whose batch axis is x's third from last; ``dims`` are the
    entry's shape arguments.  Returns the (B,) float32 result."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {x.device}")
    if delta.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {delta.dtype} has no kernel (float32, bfloat16)")
    _check_cuda(name, {"x": x, "delta": delta}, x.dtype)
    b = x.shape[-3]
    partials = torch.empty((b, n_partials), dtype=torch.float32, device=x.device)
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    lib = _build.library(lib_name)
    rc = getattr(lib, f"{lib_name}_fwd")(
        _DTYPES[x.dtype], _DTYPES[delta.dtype], x.data_ptr(), delta.data_ptr(),
        partials.data_ptr(), out.data_ptr(), *dims, n_partials,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(lib, lib_name, rc)
    return out


def _tiles(n: int) -> int:
    return -(-n // TILE)


def _direct_launch(name: str, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    n_l, b, s, d_in = x.shape
    d_out = delta.shape[-1]
    return _launch(name, "psgn_direct", x, delta, (n_l, b, s, d_in, d_out),
                   n_l * _tiles(d_in) * _tiles(d_out))


def psgn_direct(x: torch.Tensor, delta: torch.Tensor, *, block_i: int = 128,
                block_j: int = 128, block_s: int = 512) -> torch.Tensor:
    """(B,) per-sample ``||X_b^T Delta_b||_F^2`` (float32).  x (B, S, Din),
    delta (B, S, Dout)."""
    _check_pair("psgn_direct", x, delta, 3)
    if x.device.type == "cpu":
        return ref.psgn_ref(x, delta)
    out = _direct_launch("psgn_direct", x[None], delta[None])
    psgn_direct.launches += 1
    return out


psgn_direct.launches = 0


def psgn_gram(x: torch.Tensor, delta: torch.Tensor, *, block_si: int = 256,
              block_sj: int = 256) -> torch.Tensor:
    """(B,) per-sample ``sum_{t,t'} (x_t . x_t')(d_t . d_t')``, equal to
    ``||X_b^T Delta_b||_F^2`` (float32).  x (B, S, Din), delta (B, S, Dout)."""
    _check_pair("psgn_gram", x, delta, 3)
    if x.device.type == "cpu":
        return ref.psgn_gram_ref(x, delta)
    b, s, d_in = x.shape
    n_t = _tiles(s)
    out = _launch("psgn_gram", "psgn_gram", x, delta, (b, s, d_in, delta.shape[-1]),
                  n_t * (n_t + 1) // 2)
    psgn_gram.launches += 1
    return out


psgn_gram.launches = 0


def psgn_fused(x: torch.Tensor, delta: torch.Tensor, *, block_i: int = 128,
               block_j: int = 128, block_s: int = 512) -> torch.Tensor:
    """(B,) sum over L stacked same-shape layers of per-sample
    ``||X^T D||_F^2``, in one launch.  x (L, B, S, Din), delta (L, B, S, Dout)."""
    _check_pair("psgn_fused", x, delta, 4)
    if x.device.type == "cpu":
        return ref.psgn_fused_ref(x, delta)
    out = _direct_launch("psgn_fused", x, delta)
    psgn_fused.launches += 1
    return out


psgn_fused.launches = 0
