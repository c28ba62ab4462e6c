"""Functional optimizers over parameter trees: ``sgd`` and ``adamw``.

Counterpart of ``repro/optim/optimizer.py``, with the same interface:

    opt = sgd(momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    apply_updates(params, updates)

``lr`` is an argument of ``update``, not part of the transform, so the
adaptation layer changes it between steps freely.  Trees are lists of
tensors in the parameters' order (``utils.pytree.leaves``); the optimizer
state is updated IN PLACE and returned (the reference returns new arrays),
and ``apply_updates`` adds into the parameters in place.  State is kept in
the parameter's dtype unless ``state_dtype`` says otherwise, as in the
reference (bf16 momenta for bf16 weights).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils import pytree as ptu

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[..., tuple[list, Any]]  # (grads, state, params, lr)
    name: str = "optimizer"


@torch.no_grad()
def apply_updates(params: Tree, updates: list) -> None:
    """``p += u`` for every parameter, in place (``u`` cast to p's dtype)."""
    ps = ptu.leaves(params)
    torch._foreach_add_(ps, [u.to(p.dtype) for p, u in zip(ps, updates)])


def _zeros(params: Tree, state_dtype) -> list:
    return [torch.zeros_like(p, dtype=state_dtype or p.dtype) for p in ptu.leaves(params)]


# ---------------------------------------------------------------------------
# SGD (+ momentum, + weight decay): the paper's optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SGDState:
    momentum: list  # zeros-like params (empty when momentum == 0)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0, nesterov: bool = False,
        state_dtype: torch.dtype | None = None) -> Optimizer:
    use_momentum = momentum != 0.0

    def init(params: Tree) -> SGDState:
        return SGDState(momentum=_zeros(params, state_dtype) if use_momentum else [])

    @torch.no_grad()
    def update(grads: list, state: SGDState, params: Tree, lr) -> tuple[list, SGDState]:
        lr = float(lr)
        grads = list(grads)
        if weight_decay:
            grads = [g + weight_decay * p.to(g.dtype)
                     for g, p in zip(grads, ptu.leaves(params))]
        ps = ptu.leaves(params)
        # -lr * x is formed in float32 and rounded to the parameter's dtype,
        # where the reference's apply_updates rounds it
        if not use_momentum:
            return [(g.float() * -lr).to(p.dtype) for g, p in zip(grads, ps)], state
        mom = state.momentum
        torch._foreach_mul_(mom, momentum)
        torch._foreach_add_(mom, [g.to(m.dtype) for m, g in zip(mom, grads)])
        if nesterov:
            return [((m * momentum + g.to(m.dtype)).float() * -lr).to(p.dtype)
                    for m, g, p in zip(mom, grads, ps)], state
        return [(m.float() * -lr).to(p.dtype) for m, p in zip(mom, ps)], state

    return Optimizer(init=init, update=update, name=f"sgd(m={momentum},wd={weight_decay})")


# ---------------------------------------------------------------------------
# AdamW: for the "DiveBatch composes with Adam-family" extension
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    mu: list
    nu: list
    count: int


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype: torch.dtype | None = None) -> Optimizer:
    def init(params: Tree) -> AdamWState:
        return AdamWState(mu=_zeros(params, state_dtype), nu=_zeros(params, state_dtype),
                          count=0)

    @torch.no_grad()
    def update(grads: list, state: AdamWState, params: Tree, lr) -> tuple[list, AdamWState]:
        lr = float(lr)
        state.count += 1
        # the bias corrections in float32, as the reference computes them
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** state.count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** state.count
        updates = []
        for m, v, g, p in zip(state.mu, state.nu, grads, ptu.leaves(params)):
            g = g.to(m.dtype)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            step = (m.float() / c1.item()) / ((v.float() / c2.item()).sqrt() + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            updates.append((-lr * step).to(p.dtype))
        return updates, state

    return Optimizer(init=init, update=update, name=f"adamw(wd={weight_decay})")
