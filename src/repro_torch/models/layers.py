"""Primitive layers as plain functions on tensors: dense, embed, norms,
rotary embeddings, activations.

Counterpart of ``repro/models/layers.py``.  The reference passes parameter
dicts with ``(d_in, d_out)`` kernels; here weights are tensors in
``nn.Linear``'s ``(d_out, d_in)`` layout (``models/transformer.py`` holds
them in modules), and every op keeps the reference's precision: norms and
RoPE compute in float32 and cast back to the input's type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
          probe: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T (+ bias) (+ probe)`` with the weight, bias and probe
    cast to ``x``'s type.  A zero ``probe`` leaves the value unchanged; its
    gradient is the gradient of the layer's output (``models/probes.py``)."""
    y = x @ weight.to(x.dtype).t()
    if bias is not None:
        y = y + bias.to(x.dtype)
    if probe is not None:
        y = y + probe.to(x.dtype)
    return y


def embed(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the ``(vocab, d)`` embedding table."""
    return weight[ids]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": torch.relu}
