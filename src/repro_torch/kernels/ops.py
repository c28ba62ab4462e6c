"""Cost-model dispatch over the per-sample gradient-norm kernels, and the
int8 quantisation entry points.

Counterpart of ``repro/kernels/ops.py``.  The reference's ``interpret``
switch has no counterpart: the tensors' device decides (the kernels on the
card, their plain versions on the CPU; ``kernels/psgn.py``,
``kernels/quant.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import psgn as psgn_kernels
from repro_torch.kernels import quant as quant_kernels


def choose_method(s: int, d_in: int, d_out: int) -> str:
    """FLOP-count dispatch between the two per-sample-grad-norm kernels:
    direct ~ 2*S*Din*Dout, gram ~ 2*S^2*(Din+Dout); a tie goes to direct."""
    direct = 2.0 * s * d_in * d_out
    gram = 2.0 * s * s * (d_in + d_out)
    return "direct" if direct <= gram else "gram"


def _round_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def persample_sq_norm(x: torch.Tensor, delta: torch.Tensor,
                      method: str = "auto") -> torch.Tensor:
    """(B,) per-sample squared Frobenius norm of the dense-layer gradient.

    x (B, S, Din) or (B, Din); delta (B, S, Dout) or (B, Dout).  2-D inputs
    (no sequence axis) factorise exactly: ``||x_b delta_b^T||_F^2 =
    ||x_b||^2 * ||delta_b||^2``, no kernel needed."""
    if x.dim() == 2:
        xn = x.float().square().sum(dim=-1)
        dn = delta.float().square().sum(dim=-1)
        return xn * dn
    _, s, d_in = x.shape
    d_out = delta.shape[-1]
    if method == "auto":
        method = choose_method(s, d_in, d_out)
    x, delta = x.contiguous(), delta.contiguous()
    if method == "direct":
        return psgn_kernels.psgn_direct(
            x, delta,
            block_s=min(512, _round_pow2(s)),
            block_i=min(128, _round_pow2(d_in)),
            block_j=min(128, _round_pow2(d_out)),
        )
    if method == "gram":
        blk = min(256, _round_pow2(s))
        return psgn_kernels.psgn_gram(x, delta, block_si=blk, block_sj=blk)
    raise ValueError(f"unknown method {method!r}")


def _bias_sq_norm(d: torch.Tensor) -> torch.Tensor:
    """(B,) per-sample sq-norm of the BIAS gradient of the same layer: the
    per-sample bias gradient is the sequence sum of the output delta."""
    df = d.float()
    if df.dim() == 3:
        df = df.sum(dim=1)
    return df.square().sum(dim=-1)


def group_layers(acts: dict, deltas: dict) -> dict[tuple, list[str]]:
    """The grouping of :func:`persample_sq_norm_tree`, in ``acts`` order:
    layers with a sequence axis whose cost model picks direct are keyed by
    their shapes and dtypes (a group of two or more is one fused launch);
    every other layer is ``("solo", name)``."""
    groups: dict[tuple, list[str]] = {}
    for name, x in acts.items():
        d = deltas[name]
        if x.dim() == 3 and choose_method(x.shape[1], x.shape[2], d.shape[2]) == "direct":
            key = (tuple(x.shape), tuple(d.shape), x.dtype, d.dtype)
        else:
            key = ("solo", name)
        groups.setdefault(key, []).append(name)
    return groups


def persample_sq_norm_tree(acts: dict, deltas: dict, scale: float = 1.0, *,
                           bias: bool = False) -> torch.Tensor:
    """Sum per-sample sq-norms over a dict of dense layers (the gram-tier
    total), (B,) float32.

    ``deltas`` are probe gradients of a MEAN loss: ``scale`` (the batch
    size) undoes the 1/B factor.  Same-shape layers that the cost model
    sends to the direct kernel go to ``psgn_fused_layers`` as one group,
    one launch instead of one per layer; on the tensor-core route the
    kernel reads each layer in place (the reference stacks them).  ``bias=True``
    adds each layer's bias-gradient sq-norm ``||sum_s d_s||^2`` (exact for
    bias-complete dense models; a probe sees the same delta its bias does).
    Groups and their members are summed in ``acts`` order, as the
    reference does."""
    total = None
    for key, names in group_layers(acts, deltas).items():
        if key[0] != "solo" and len(names) >= 2:
            v = psgn_kernels.psgn_fused_layers(
                [acts[n].contiguous() for n in names],
                [(deltas[n] * scale).contiguous() for n in names])
        else:
            v = None
            for n in names:
                vi = persample_sq_norm(acts[n], deltas[n] * scale)
                v = vi if v is None else v + vi
        if bias:
            for n in names:
                v = v + _bias_sq_norm(deltas[n] * scale)
        total = v if total is None else total + v
    return total


quantize_int8 = quant_kernels.quantize_int8
dequantize_int8 = quant_kernels.dequantize_int8
