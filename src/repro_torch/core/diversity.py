"""Gradient-diversity estimation (the paper's core quantity).

Counterpart of ``repro/core/diversity.py``.  Gradient diversity (Yin et al.
2018, Definition 1):

    Delta_S(theta) = sum_i ||g_i||^2 / || sum_i g_i ||^2

DiveBatch (Algorithm 1) accumulates, across all microbatches of an epoch,
the running sum of gradients (``grad_sum``, a tree like the parameters) and
the running sum of per-sample (exact/gram) or microbatch-sum (moment)
gradient squared norms (``sq_norm_sum``), and at the epoch boundary sets
m_{k+1} = min(m_max, delta * n * Delta_hat).

The moment tier recovers sum_i ||g_i||^2 from microbatch-sum norms with
E||sum_{i<=m} g_i||^2 = m E||g||^2 + m(m-1) ||mu||^2: zero extra backward
work.  The gram tier, and the exact tier on its probe path, run in the
train step (``train/step.py``, ``models/probes.py``); the exact tier's vmap
path, :func:`persample_sq_norms`, takes per-sample gradients through
``torch.func.vmap(grad(...))`` over ``functional_call``.

The state lives on the device; the scalars are 0-d float32 tensors and the
estimates are computed there, so a boundary reads one stacked result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.utils import pytree as ptu

EPS = 1e-20


@dataclasses.dataclass
class DiversityState:
    """Within-epoch accumulators.  Reset at every epoch boundary.

    grad_sum      running sum over all per-sample gradients seen this epoch
                  (each microbatch contributes ``microbatch_size * mean_grad``).
    sq_norm_sum   exact/gram: running sum_i ||g_i||^2;
                  moment: running sum_j ||microbatch_sum_grad_j||^2.
    mb_count      number of microbatches accumulated (moment estimator).
    sample_count  number of samples accumulated.
    """

    grad_sum: dict
    sq_norm_sum: torch.Tensor
    mb_count: torch.Tensor
    sample_count: torch.Tensor

    def _replace(self, **kw) -> "DiversityState":
        return dataclasses.replace(self, **kw)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def init_state(params: Any, accum_dtype: torch.dtype = torch.float32) -> DiversityState:
    grad_sum = ptu.tree_zeros_like(params, dtype=accum_dtype)
    dev = ptu.leaves(grad_sum)[0].device
    return DiversityState(grad_sum=grad_sum, sq_norm_sum=_zero(dev),
                          mb_count=_zero(dev), sample_count=_zero(dev))


@torch.no_grad()
def reset_state(state: DiversityState) -> DiversityState:
    """Zero the accumulators IN PLACE (the reference returns fresh zeros)
    and return the same state."""
    torch._foreach_zero_(ptu.leaves(state.grad_sum))
    for t in (state.sq_norm_sum, state.mb_count, state.sample_count):
        t.zero_()
    return state


@torch.no_grad()
def accumulate(state: DiversityState, mean_grad: Any, microbatch_size: int,
               persample_sq_norm_sum: torch.Tensor | None = None) -> DiversityState:
    """Fold one microbatch's gradient statistics into the state, in place.

    mean_grad              the microbatch's mean gradient (the tensors the
                           optimizer consumes), a tree like ``grad_sum``.
    microbatch_size        samples in the microbatch.
    persample_sq_norm_sum  sum_i ||g_i||^2 over the microbatch from an exact
                           or gram estimator; None takes the moment
                           statistic ||m * mean_grad||^2."""
    m = float(microbatch_size)
    acc = ptu.leaves(state.grad_sum)
    torch._foreach_add_(acc, [g.to(a.dtype) for a, g in zip(acc, ptu.leaves(mean_grad))],
                        alpha=m)
    if persample_sq_norm_sum is None:
        contrib = (m * m) * ptu.tree_sq_norm(mean_grad)
    else:
        contrib = torch.as_tensor(persample_sq_norm_sum, dtype=torch.float32)
    state.sq_norm_sum.add_(contrib)
    state.mb_count.add_(1.0)
    state.sample_count.add_(m)
    return state


def diversity_exact(state: DiversityState) -> torch.Tensor:
    """Delta_hat for the exact/gram tiers: sq_norm_sum / ||grad_sum||^2."""
    return state.sq_norm_sum / ptu.tree_sq_norm(state.grad_sum).clamp_min(EPS)


def diversity_moment(state: DiversityState) -> torch.Tensor:
    """Delta_hat from microbatch-sum norms (no per-sample work).

    With J microbatches of (average) size m, n = J*m samples:
        Q := sum_j ||S_j||^2,  E[Q] = J*m*E2 + J*m*(m-1)*M
        R := ||sum_i g_i||^2,  E[R] = n*E2 + n*(n-1)*M
    where E2 = E||g||^2 and M = ||mu||^2.  Solving:
        M  = (R - Q) / (n*(n - m))        (clamped at >= 0)
        E2 = Q/n - (m - 1)*M              (clamped at >= eps)
    and Delta_hat = n*E2 / R.  A single-microbatch window (n == m) falls
    back to treating the microbatch statistic as exact: Q / R.
    """
    n = state.sample_count.clamp_min(1.0)
    j = state.mb_count.clamp_min(1.0)
    m = n / j
    q = state.sq_norm_sum
    r = ptu.tree_sq_norm(state.grad_sum)
    big_m = ((r - q) / (n * (n - m)).clamp_min(EPS)).clamp_min(0.0)
    e2 = (q / n - (m - 1.0) * big_m).clamp_min(EPS)
    r_safe = r.clamp_min(EPS)
    return torch.where(n - m < 0.5, q / r_safe, n * e2 / r_safe)


def estimate(state: DiversityState, estimator: str) -> torch.Tensor:
    if estimator in ("exact", "gram"):
        return diversity_exact(state)
    if estimator == "moment":
        return diversity_moment(state)
    raise ValueError(f"unknown estimator {estimator!r}")


# ---------------------------------------------------------------------------
# Per-sample gradient helpers (exact tier + Oracle)
# ---------------------------------------------------------------------------


class _Bound(nn.Module):
    """``loss_fn(model, example)`` as a module's forward, so
    ``torch.func.functional_call`` can swap the model's parameters."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, example):
        return self.loss_fn(self.model, example)


def persample_grads(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    params: nn.Module, batch: dict) -> dict[str, torch.Tensor]:
    """``vmap(grad)``: per-sample gradients ``{name: (B, *shape)}`` of
    ``loss_fn(params, example) -> scalar`` over the batch's leading axis,
    through ``torch.func`` on ``functional_call``."""
    bound = _Bound(params, loss_fn)
    names = [n for n, _ in params.named_parameters()]
    values = {n: p.detach() for n, p in params.named_parameters()}

    def one(pvals: dict, example: dict) -> torch.Tensor:
        return torch.func.functional_call(
            bound, {f"model.{n}": v for n, v in pvals.items()}, (example,))

    grads = torch.func.vmap(torch.func.grad(one), in_dims=(None, 0))(values, batch)
    return {n: grads[n] for n in names}


def persample_sq_norms(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                       params: nn.Module, batch: dict) -> torch.Tensor:
    """(B,) float32 per-sample gradient squared norms (the exact tier)."""
    total = None
    for g in persample_grads(loss_fn, params, batch).values():
        v = g.float().square().reshape(g.shape[0], -1).sum(dim=-1)
        total = v if total is None else total + v
    return total


@torch.no_grad()
def dataset_diversity(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                      params: nn.Module, batches) -> torch.Tensor:
    """ORACLE: exact Delta_S(theta) over an iterable of batches (one pass).

    Every gradient is taken at the same fixed params (unlike DiveBatch's
    within-epoch accumulation): the paper's Oracle baseline.  The gradient
    sum is the sum of the per-sample gradients (the reference takes ``B``
    times the gradient of the batch mean)."""
    total_sq = None
    grad_sum = None
    for batch in batches:
        grads = persample_grads(loss_fn, params, batch)
        sq = sum(g.float().square().reshape(g.shape[0], -1).sum(-1)
                 for g in grads.values()).sum()
        gs = [g.float().sum(dim=0) for g in grads.values()]
        total_sq = sq if total_sq is None else total_sq + sq
        grad_sum = gs if grad_sum is None else [a + b for a, b in zip(grad_sum, gs)]
    if grad_sum is None:
        raise ValueError("dataset_diversity: empty dataset")
    return total_sq / ptu.tree_sq_norm(grad_sum).clamp_min(EPS)
