"""ResNet-20-family CNN for the CIFAR reproduction (He et al. 2016).

Counterpart of ``repro/models/resnet.py``.  GroupNorm replaces BatchNorm so
per-sample gradients are well defined.  Widths and stages follow the CIFAR
ResNet-20 recipe: 3 stages of n basic blocks, widths (w, 2w, 4w), n =
(depth - 2) / 6.

Parameters are an ``nn.Module`` whose names follow the reference's tree
(``stem.conv``, ``stages.<s>.<b>.conv1``, ``norm1.scale``, ``proj``,
``head``); convolution weights are ``(c_out, c_in, k, k)``, the layout
``F.conv2d`` takes (the reference's are HWIO; ``interop`` converts).
Activations stay NHWC as in the reference: a convolution sees them through
a permuted view, so cuDNN runs them channels-last.  Padding is the
reference's ``"SAME"``: for a stride-2 3x3 convolution on an even input XLA
pads (0, 1), not (1, 1), so the pads are computed and applied explicitly.
``resnet_loss`` is per-sample when ``example["x"]`` is one image (H, W, C),
for the exact tier's ``torch.func.vmap``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.layers import NormParams, dense, group_norm


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with ``(c_out, c_in, k, k)`` ``w``, "SAME"."""
    k = w.shape[-1]
    (hl, hh), (wl, wh) = (_same_pads(x.shape[1], k, stride),
                          _same_pads(x.shape[2], k, stride))
    xc = x.permute(0, 3, 1, 2)
    if hl or hh or wl or wh:
        xc = F.pad(xc, (wl, wh, hl, hh))
    return F.conv2d(xc, w.to(x.dtype), stride=stride).permute(0, 2, 3, 1)


def _gn_groups(c: int) -> int:
    for g in (8, 4, 2, 1):
        if c % g == 0:
            return g
    return 1


def _gn(norm: NormParams, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, norm.scale, norm.bias, _gn_groups(x.shape[-1]))


def _conv_weight(c_in: int, c_out: int, k: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty((c_out, c_in, k, k), dtype=dtype, device=device))


class Stem(nn.Module):
    def __init__(self, width: int, dtype, device):
        super().__init__()
        self.conv = _conv_weight(3, width, 3, dtype, device)
        self.norm = NormParams(width, dtype, with_bias=True, device=device)


class Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, dtype, device):
        super().__init__()
        self.conv1 = _conv_weight(c_in, c_out, 3, dtype, device)
        self.norm1 = NormParams(c_out, dtype, with_bias=True, device=device)
        self.conv2 = _conv_weight(c_out, c_out, 3, dtype, device)
        self.norm2 = NormParams(c_out, dtype, with_bias=True, device=device)
        self.proj = (_conv_weight(c_in, c_out, 1, dtype, device)
                     if stride != 1 or c_in != c_out else None)


class ResNet(nn.Module):
    def __init__(self, depth: int = 20, num_classes: int = 10, width: int = 16,
                 dtype=torch.float32, device=None):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"depth must be 6n+2, got {depth}")
        n = (depth - 2) // 6
        self.stem = Stem(width, dtype, device)
        stages = []
        c_in = width
        for s, c_out in enumerate((width, 2 * width, 4 * width)):
            blocks = []
            for b in range(n):
                blocks.append(Block(c_in, c_out, 2 if (s > 0 and b == 0) else 1,
                                    dtype, device))
                c_in = c_out
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.head = nn.Linear(c_in, num_classes, dtype=dtype, device=device)


def resnet_init(gen: torch.Generator, depth: int = 20, num_classes: int = 10,
                width: int = 16, dtype=torch.float32,
                device: torch.device | str = "cuda") -> ResNet:
    """He-normal convolutions, a normal / sqrt(c) head, zero biases, unit
    norm scales, on ``device`` (the card unless the caller asks for the
    CPU).  The numbers are drawn on the generator's device, so one seed
    gives the same weights on every ``device``."""
    device = resolve_device(device)
    model = ResNet(depth, num_classes, width, dtype, device)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=gen.device) * std

    with torch.no_grad():
        convs = [model.stem.conv] + [w for blk in (b for st in model.stages for b in st)
                                     for w in (blk.conv1, blk.conv2, blk.proj)
                                     if w is not None]
        for w in convs:
            w.copy_(normal(w.shape, math.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3]))))
        head = model.head
        head.weight.copy_(normal(head.weight.shape, 1.0 / math.sqrt(head.in_features)))
        head.bias.zero_()
    return model


def resnet_forward(params: ResNet, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) -> logits (B, num_classes)."""
    h = torch.relu(_gn(params.stem.norm, _conv(x, params.stem.conv)))
    for stage in params.stages:
        for blk in stage:
            # downsampling blocks are exactly those with a channel-increasing
            # projection
            c_out, c_in = blk.conv1.shape[:2]
            stride = 2 if blk.proj is not None and c_in != c_out else 1
            y = torch.relu(_gn(blk.norm1, _conv(h, blk.conv1, stride)))
            y = _gn(blk.norm2, _conv(y, blk.conv2))
            sc = _conv(h, blk.proj, stride) if blk.proj is not None else h
            h = torch.relu(y + sc)
    pooled = h.mean(dim=(1, 2))
    return dense(pooled, params.head.weight, params.head.bias)


def resnet_loss(params: ResNet, example: dict) -> torch.Tensor:
    """Per-sample (x of one image, (H, W, C)) or batch-mean softmax cross
    entropy, in float32."""
    x = example["x"]
    if x.dim() == 3:
        x = x[None]
    logits = resnet_forward(params, x).float()
    y = example["y"].reshape(-1).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, y[:, None])[:, 0]
    return (lse - tgt).mean()


def resnet_batch_loss(params: ResNet, batch: dict) -> torch.Tensor:
    return resnet_loss(params, batch)


def resnet_accuracy(params: ResNet, batch: dict) -> torch.Tensor:
    logits = resnet_forward(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()
