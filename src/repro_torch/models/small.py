"""The paper's experimental models: logistic regression and a 2-layer MLP
(Section 5.1), with gram-estimator probe support.

Counterpart of ``repro/models/small.py``.  Parameters are ``nn.Module``s
whose dense layers are ``nn.Linear`` (``(d_out, d_in)`` weights; the
reference's ``(d_in, d_out)`` kernels convert through ``interop``).  The
functions keep the reference's signatures: ``*_loss(params, example)`` is
per-sample (a scalar for one example, so the exact tier can take
per-sample gradients of it under ``torch.func.vmap``), ``*_batch_loss``
the mean over a batch, and ``mlp_batch_loss_with_probes(params, probes,
batch)`` adds zero probes on every dense output and returns the saved
input activations, so one backward pass yields (X, Delta) per layer.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.layers import dense


def _bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # numerically stable binary cross entropy.  A sample whose hidden units
    # are all dead has a logit of exactly 0; there the subgradients follow
    # JAX's: maximum splits the gradient at the tie, and |l| takes slope +1
    # (torch's abs has slope 0 at 0)
    absl = torch.where(logit >= 0, logit, -logit)
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * y
            + torch.log1p(torch.exp(-absl)))


def _linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
            device: torch.device) -> nn.Linear:
    """The reference's ``dense_init``: normal / sqrt(d_in) weights, zero bias.
    The numbers are drawn on the generator's device, so one generator seed
    gives the same weights on every ``device``."""
    lin = nn.Linear(d_in, d_out, dtype=dtype, device=device)
    with torch.no_grad():
        w = torch.randn((d_out, d_in), generator=gen, device=gen.device) / math.sqrt(d_in)
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


def _apply(lin: nn.Linear, x: torch.Tensor, probe: torch.Tensor | None = None) -> torch.Tensor:
    return dense(x, lin.weight, lin.bias, probe)


# ---------------------------------------------------------------------------
# Logistic regression (the convex case)
# ---------------------------------------------------------------------------


class Logreg(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.linear = nn.Linear(d, 1, dtype=dtype, device=device)


def logreg_init(gen: torch.Generator, d: int, dtype=torch.float32,
                device: torch.device | str = "cuda") -> Logreg:
    """On ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    model = Logreg(d, dtype, device="meta")
    model.linear = _linear(gen, d, 1, dtype, device)
    return model


def logreg_loss(params: Logreg, example: dict) -> torch.Tensor:
    logit = _apply(params.linear, example["x"])[..., 0]
    return _bce_with_logits(logit.float(), example["y"].float()).mean()


def logreg_batch_loss(params: Logreg, batch: dict) -> torch.Tensor:
    return logreg_loss(params, batch)


def logreg_accuracy(params: Logreg, batch: dict) -> torch.Tensor:
    logit = _apply(params.linear, batch["x"])[..., 0]
    return ((logit > 0).to(torch.int32) == batch["y"]).float().mean()


# ---------------------------------------------------------------------------
# 2-layer MLP (the nonconvex case)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, 1, dtype=dtype, device=device)


def mlp_init(gen: torch.Generator, d: int, hidden: int | None = None,
             dtype=torch.float32, device: torch.device | str = "cuda") -> MLP:
    """On ``device`` (the card unless the caller asks for the CPU); hidden
    defaults to ``max(4, d // 8)``, as in the reference."""
    device = resolve_device(device)
    hidden = hidden or max(4, d // 8)
    model = MLP(d, hidden, dtype, device="meta")
    model.fc1 = _linear(gen, d, hidden, dtype, device)
    model.fc2 = _linear(gen, hidden, 1, dtype, device)
    return model


def mlp_forward(params: MLP, x: torch.Tensor, probes: dict | None = None,
                acts: dict | None = None) -> torch.Tensor:
    p1 = probes.get("fc1") if probes else None
    p2 = probes.get("fc2") if probes else None
    if acts is not None:
        acts["fc1"] = x
    h = torch.relu(_apply(params.fc1, x, p1))
    if acts is not None:
        acts["fc2"] = h
    return _apply(params.fc2, h, p2)[..., 0]


def mlp_loss(params: MLP, example: dict) -> torch.Tensor:
    logit = mlp_forward(params, example["x"])
    return _bce_with_logits(logit.float(), example["y"].float()).mean()


def mlp_batch_loss(params: MLP, batch: dict) -> torch.Tensor:
    return mlp_loss(params, batch)


def mlp_batch_loss_with_probes(params: MLP, probes: dict, batch: dict):
    """Returns (loss, acts).  The gradient w.r.t. the probes is the upstream
    activation gradient, scaled by 1/B because the loss is a mean (callers
    rescale)."""
    acts: dict = {}
    logit = mlp_forward(params, batch["x"], probes=probes, acts=acts)
    loss = _bce_with_logits(logit.float(), batch["y"].float()).mean()
    return loss, acts


def mlp_probe_specs(params: MLP, batch_size: int) -> dict:
    dev = params.fc1.weight.device
    return {
        "fc1": torch.zeros((batch_size, params.fc1.out_features), dtype=torch.float32,
                           device=dev),
        "fc2": torch.zeros((batch_size, 1), dtype=torch.float32, device=dev),
    }


def mlp_accuracy(params: MLP, batch: dict) -> torch.Tensor:
    logit = mlp_forward(params, batch["x"])
    return ((logit > 0).to(torch.int32) == batch["y"]).float().mean()
