"""The train step: microbatch gradient accumulation with the in-step
DiveBatch diversity accumulation.

Counterpart of ``repro/train/step.py``.  Batch-size adaptivity at scale is
adapting ``num_micro`` (the accumulation length): the microbatch shape is
fixed, the global batch is ``num_micro * micro_batch``, and
``train/engine.py::StepEngine`` keys its step programs by the pow2
``num_micro`` bucket.

The diversity tier runs inside the step (``estimator``):

  moment  Q += ||microbatch_sum_grad||^2 per microbatch: zero extra backward
          work, the tier used at 7B..1T scale.
  gram    Q += probe-trick per-sample norms (``kernels/psgn.py``) from one
          extra probe-gradient pass after each microbatch's main gradient:
          exact for the dense weights that dominate.
  exact   with ``psn_impl="vmap"``: per-sample gradients of
          ``example_loss`` through ``torch.func`` (``core/diversity.py``),
          for ``ModelFns`` models; with ``psn_impl="kernel"``: the gram
          tier's probe pass plus each probed layer's bias term.

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
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tf
from repro_torch.models.probes import probe_grads
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils import pytree as ptu


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


def _check_estimator(estimator: str, example_loss, probe_loss, probe_specs,
                     psn_impl: str) -> str:
    """The reference's checks and messages; returns the resolved psn_impl."""
    if psn_impl not in ("auto", "vmap", "kernel"):
        raise ValueError(f"unknown psn_impl {psn_impl!r}")
    if psn_impl == "auto":
        psn_impl = "vmap" if example_loss is not None else "kernel"
    if estimator == "exact":
        if psn_impl == "vmap" and example_loss is None:
            raise ValueError("estimator='exact' needs example_loss")
        if psn_impl == "kernel" and (probe_loss is None or probe_specs is None):
            raise ValueError(
                "estimator='exact' with psn_impl='kernel' needs "
                "probe_loss and probe_specs"
            )
    if estimator == "gram" and (probe_loss is None or probe_specs is None):
        raise ValueError("estimator='gram' needs probe_loss and probe_specs")
    if estimator not in ("exact", "gram", "moment"):
        raise ValueError(f"unknown in-step estimator {estimator!r}")
    return psn_impl


def make_train_step(
    cfg: ModelConfig | None,
    optimizer: Optimizer,
    num_micro: int,
    *,
    diversity_on: bool = True,
    loss_fn: Callable | None = None,
    estimator: str = "moment",
    example_loss: Callable | None = None,
    probe_loss: Callable | None = None,
    probe_specs: Callable | None = None,
    psn_chunk: int | None = None,
    psn_impl: str = "auto",
) -> Callable[[TrainState, dict, float], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch, lr) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` defaults to the transformer LM loss
    (``cfg`` required then).  ``batch`` holds tensors (or arrays)
    with a leading global-batch axis; they move to the parameters' device.
    ``metrics`` holds device scalars: ``loss`` (the mean over microbatches)
    and ``grad_norm_sq``.

    ``estimator`` selects the in-step tier (see the module docstring):
    "moment" needs nothing extra; "exact" with ``psn_impl="vmap"`` needs
    ``example_loss(params, example)``; "gram", and "exact" with
    ``psn_impl="kernel"``, need ``probe_loss(params, probes, batch) ->
    (loss, acts)`` and ``probe_specs(params, batch_size) -> probes``
    (``models/probes.py``, ``models/small.py``).  ``psn_impl="auto"``
    resolves as in the reference: vmap when ``example_loss`` is given, else
    kernel.  ``psn_chunk`` bounds the vmap width: per-sample gradients are
    formed ``psn_chunk`` samples at a time.  The vmap path runs on
    ``ModelFns`` models; on the LM loss it raises (``torch.func`` cannot
    transform the old-style autograd functions ``xent_chunked`` and
    ``flash_attention`` are made of)."""
    if loss_fn is None:
        if cfg is None:
            raise ValueError("make_train_step needs cfg or loss_fn")
        base_loss = lambda p, b: tf.loss_fn(cfg, p, b)[0]  # noqa: E731
    else:
        base_loss = loss_fn
    if diversity_on:
        psn_impl = _check_estimator(estimator, example_loss, probe_loss, probe_specs,
                                    psn_impl)
        if estimator == "exact" and psn_impl == "vmap" and loss_fn is None:
            raise NotImplementedError(
                "psn_impl='vmap' on the transformer LM: torch.func cannot transform "
                "the old-style autograd functions of xent_chunked and flash_attention; "
                "use psn_impl='kernel' with probes")

    def _probe_sq_norms(params, mb: dict, *, bias: bool) -> torch.Tensor:
        """One probe-gradient pass -> the summed per-sample sq-norms through
        the psgn kernels (same-shape layers fused into one launch)."""
        bsz = next(iter(mb.values())).shape[0]
        _, acts, pgrads = probe_grads(probe_loss, params, probe_specs(params, bsz), mb)
        return kernel_ops.persample_sq_norm_tree(acts, pgrads, scale=float(bsz),
                                                 bias=bias).sum()

    def _vmap_sq_norms(params, mb: dict) -> torch.Tensor:
        """The exact tier's vmap path, ``psn_chunk`` samples at a time."""
        n = next(iter(mb.values())).shape[0]
        chunk = min(psn_chunk or n, n)
        total = torch.zeros((), dtype=torch.float32, device=ptu.leaves(params)[0].device)
        for i in range(0, n, chunk):
            sub = {k: v[i:i + chunk] for k, v in mb.items()}
            total = total + diversity.persample_sq_norms(example_loss, params, sub).sum()
        return total

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
            mb = {k: v[j] for k, v in micro.items()}
            loss = base_loss(state.params, mb)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for a, g in zip(grads_acc, grads):
                    a.add_(g)
                if diversity_on and estimator == "moment":  # ||m * g_j||^2
                    sq_sum += (micro_global * micro_global) * ptu.tree_sq_norm(grads)
                loss_sum += loss.detach().float()
            # the main pass's graph is gone (autograd.grad freed it): the probe
            # pass never holds activations beside it
            del grads, loss
            if diversity_on and estimator != "moment":
                if estimator == "exact" and psn_impl == "vmap":
                    sq_sum += _vmap_sq_norms(state.params, mb)
                else:
                    sq_sum += _probe_sq_norms(state.params, mb,
                                              bias=estimator == "exact")
        with torch.no_grad():
            torch._foreach_div_(grads_acc, float(num_micro))
            grads = grads_acc
            if diversity_on:
                div = state.div_state
                torch._foreach_add_(ptu.leaves(div.grad_sum), grads,
                                    alpha=float(global_batch))
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
