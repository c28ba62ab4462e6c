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
train step (``train/step.py``, ``models/probes.py``); ``persample_sq_norms``,
the exact tier's vmap path, comes with the paper's small models
(ROADMAP.md, Queue A 4).

The state lives on the device; the scalars are 0-d float32 tensors and the
estimates are computed there, so a boundary reads one stacked result.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

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


def persample_sq_norms(*args, **kwargs):
    """Per-sample gradient squared norms (the exact tier's vmap path)."""
    raise NotImplementedError(
        "persample_sq_norms (the exact tier's vmap path, torch.func) is not "
        "ported to repro_torch yet (ROADMAP.md, Queue A 4: the paper's own models)")
