"""The train step: microbatch gradient accumulation with the in-step
DiveBatch diversity accumulation.

Counterpart of ``repro/train/step.py``.  Batch-size adaptivity at scale is
adapting ``num_micro`` (the accumulation length): the microbatch shape is
fixed, the global batch is ``num_micro * micro_batch``, and
``train/engine.py::StepEngine`` keys its step programs by the pow2
``num_micro`` bucket.

The diversity tier runs inside the step:

  moment  Q += ||microbatch_sum_grad||^2 per microbatch: zero extra backward
          work, the tier used at 7B..1T scale.

The per-sample tiers (``estimator="exact"`` / ``"gram"``) come with the
gram/exact tiers on transformer probes (ROADMAP.md, Queue A) and raise here.

What differs from the reference: the step runs eagerly, a Python loop over
microbatches in place of ``lax.scan``, and updates the state's tensors in
place (the counterpart of donation).  As in the reference, gradients
accumulate in float32, and the param-sized diversity
accumulator ``grad_sum`` is updated once per step, outside the microbatch
loop, with ``global_batch * mean_grad`` (equal to the sum of the
microbatches' ``m * g_j``).  The step reads nothing back to the host: the
loss comes back as a device scalar.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import diversity
from repro_torch.models import transformer as tf
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils import pytree as ptu

TIERS_NOT_PORTED = ("exact", "gram")


def _to_micro(x: torch.Tensor, num_micro: int) -> torch.Tensor:
    """``(B, ...) -> (num_micro, B // num_micro, ...)``."""
    b = x.shape[0]
    if b % num_micro != 0:
        raise ValueError(
            f"global batch {b} is not divisible by the num_micro bucket "
            f"{num_micro}; batch sizes must land on the bucket lattice "
            f"(core/batch_policy.bucket)"
        )
    return x.reshape(num_micro, b // num_micro, *x.shape[1:])


def _check_estimator(estimator: str) -> None:
    if estimator in TIERS_NOT_PORTED:
        raise NotImplementedError(
            f"estimator={estimator!r} is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue A: gram/exact tiers)")
    if estimator != "moment":
        raise ValueError(f"unknown in-step estimator {estimator!r}")


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    num_micro: int,
    *,
    estimator: str = "moment",
) -> Callable[[TrainState, dict, float], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch, lr) -> (state, metrics)`` over the
    transformer LM loss.  ``batch`` holds tensors (or arrays) with a leading
    global-batch axis; they move to the parameters' device.  ``metrics``
    holds device scalars: ``loss`` (the mean over microbatches) and
    ``grad_norm_sq``."""
    _check_estimator(estimator)

    def train_step(state: TrainState, batch: dict, lr) -> tuple[TrainState, dict]:
        params = ptu.leaves(state.params)
        dev = params[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        micro = {k: _to_micro(v, num_micro) for k, v in batch.items()}
        global_batch = next(iter(batch.values())).shape[0]
        micro_global = float(global_batch // num_micro)

        grads_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        sq_sum = torch.zeros((), dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(num_micro):
            loss, _ = tf.loss_fn(cfg, state.params, {k: v[j] for k, v in micro.items()})
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for a, g in zip(grads_acc, grads):
                    a.add_(g)
                # the moment statistic ||m * g_j||^2
                sq_sum += (micro_global * micro_global) * ptu.tree_sq_norm(grads)
                loss_sum += loss.detach().float()
            del grads, loss
        with torch.no_grad():
            torch._foreach_div_(grads_acc, float(num_micro))
            grads = grads_acc
            div = state.div_state
            torch._foreach_add_(ptu.leaves(div.grad_sum), grads, alpha=float(global_batch))
            div.sq_norm_sum += sq_sum
            div.mb_count += float(num_micro)
            div.sample_count += float(global_batch)
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params, lr)
            apply_updates(state.params, updates)
            del updates
            metrics = {"loss": loss_sum / num_micro, "grad_norm_sq": ptu.tree_sq_norm(grads)}
        state.opt_state = opt_state
        state.step += 1
        return state, metrics

    return train_step


def epoch_end_host(state: TrainState, estimator: str = "moment") -> tuple[float, TrainState]:
    """Host-side epoch boundary: read the diversity estimate (one scalar
    device -> host transfer) and zero the accumulators in place.  Returns
    ``(Delta_hat, state)``."""
    delta = float(diversity.estimate(state.div_state, estimator))
    diversity.reset_state(state.div_state)
    return delta, state
