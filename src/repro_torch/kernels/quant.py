"""Row-wise int8 quantisation: the gradient compressor's kernel.

Counterpart of ``repro/kernels/quant.py``.  The cross-pod gradient
compressor (``dist/compression.py``) quantises every gradient leaf to int8
with one float32 absmax scale (the leaf viewed as one row) before the
exchange across pods, with error feedback keeping SGD unbiased over time
(QSGD-style; Alistarh et al.).

  quantize_int8    x (R, C) float32 or bfloat16 -> (q int8 (R, C), scales
                   f32 (R,)), ``scale_r = max(max_c |x_rc|, 1e-12) / 127``,
                   ``q = clip(round(x / scale_r), -127, 127)``, round half
                   to even.  As in the reference, a row holding a NaN gets
                   a NaN scale, one holding an infinity (and no NaN) an
                   infinite scale, and every code of such a row is 0.  A
                   wrapper over the hand-written CUDA kernel in
                   ``csrc/quant_int8.cu`` (built by ``_build.py``), which
                   picks its design from C: a row of at most 32768
                   elements takes one launch, a block per row, x read
                   once; a longer row takes two passes over 16384-element
                   chunks (its absmax, then its codes), x read twice.
  dequantize_int8  ``q * scale`` per row, plain ops (as in the reference).

A tensor on the CPU goes to the plain version (``kernels/ref.py``).  A
tensor on the card goes to the kernel, or the wrapper raises: a failed
build, a refused launch, an unsupported type or a card below sm_90 is an
error, never a fall back to the plain version.  The wrapper counts its
calls of the kernel's entry in ``quantize_int8.launches``.  ``block_rows``
keeps the reference's signature: it tiles the TPU kernel, not this one.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels.attention import _DTYPES, _raise_on


def quantize_int8(x: torch.Tensor, *, block_rows: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q int8 (R, C), scales float32 (R,))."""
    if x.dim() != 2:
        raise ValueError(f"quantize_int8: x must be 2-D (R, C), got {tuple(x.shape)}")
    if 0 in x.shape:
        raise ValueError(f"quantize_int8: empty input {tuple(x.shape)}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if x.device.type == "cpu":
        return ref.quantize_int8(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8: no path for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_int8: dtype {x.dtype} has no kernel (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: x must be contiguous")
    r, c = x.shape
    if r * c >= 2 ** 31:
        raise ValueError(f"quantize_int8: {r} x {c} elements exceed the kernel's int32 range")
    resolve_device(x.device)  # raises below sm_90
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((r,), dtype=torch.float32, device=x.device)
    amax = torch.empty((r,), dtype=torch.int32, device=x.device)
    lib = _build.library("quant_int8")
    rc = lib.quant_int8_fwd(_DTYPES[x.dtype], x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                            amax.data_ptr(), r, c,
                            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, "quant_int8", rc)
    quantize_int8.launches += 1
    return q, scales


quantize_int8.launches = 0


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per row, cast to ``dtype`` (plain ops on every device)."""
    return ref.dequantize_int8(q, scales, dtype)
