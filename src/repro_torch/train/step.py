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
          ``psn_chunk`` samples at a time, on ``ModelFns`` models and the
          LM loss alike; with ``psn_impl="kernel"``: the gram tier's probe
          pass plus each probed layer's bias term.

What differs from the reference: the step runs eagerly, a Python loop over
microbatches in place of ``lax.scan``, and updates the state's tensors in
place (the counterpart of donation).  As in the reference, gradients
accumulate in float32, and the param-sized diversity
accumulator ``grad_sum`` is updated once per step, outside the microbatch
loop, with ``global_batch * mean_grad`` (equal to the sum of the
microbatches' ``m * g_j``).  The step reads nothing back to the host: the
loss comes back as a device scalar.

Data parallelism (``dp_size``): without a rank plan the step lays each
microbatch out as the reference's sharded program does (``_to_micro``) and
runs it whole.  Under a rank plan (``plan=``, a ``dist.ShardingPlan``
whose mesh holds ``(rank, device)`` entries) each rank runs only its share:
rank r's rows are the contiguous block ``[r B/dp, (r+1) B/dp)``, cut into
``num_micro`` pieces, so each microbatch holds the reference's samples.
Each microbatch's gradient is then averaged over the dp group, in its own
type, before it reaches the accumulator and the moment tier's ``||m
g_j||^2`` (which needs the global microbatch's gradient); the exact and
gram tiers reduce their scalar ``sq_sum`` once a step and the gradient once
a step, as does a step with ``diversity_on=False``.

Sharded state: when the parameters are shards (``dist.sharding.
layout_of(state.params)``, a rank rung's layout, ``elastic.reshard``) the
forward gathers each block's shards on entry and the gather's backward
reduce-scatters each microbatch's gradient over the data-parallel axes, so
the gradients come out as shards of the global microbatch's mean; only
the leaves the specs leave whole over a data-parallel axis are then
all-reduced (``StateLayout.finish_grads``: per microbatch for the moment
tier, once a step otherwise).  The accumulator, the momenta and
``grad_sum`` are shards; the moment tier's ``||m g_j||^2`` and
``grad_norm_sq`` sum the shards' partial norms over the mesh in one scalar
all-reduce, each element counted once (``StateLayout.sq_norm``).  The gram
tier's probe pass gathers each block whole; the exact tier's vmap runs on
parameters gathered whole outside the transform (so no collective is ever
vmapped), and holds them for the pass: the memory of whole parameters, as
without sharding.  Under ``cfg.moe_impl == "ep"`` the experts stay on
their ranks and the tokens travel (``models/moe_ep.py``); the loss runs
under ``use_plan(plan)`` so the MoE FFN sees the plan.

Tensor-parallel compute: on a sharded state whose plan's tp axes span
several ranks, the LM loss splits each block's attention heads and FFN
widths over them (``models/transformer.py``); the gradients come out as
the rank's shards and the reductions above are unchanged (tp is not a
data axis: no mean over it).  The gram tier's probe pass splits likewise,
and each microbatch's per-sample norms are summed over tp once
(``probes.tp_sum``).  The exact tier's main pass splits like the moment
tier's; its vmap pass runs on the parameters gathered whole, unsplit.

MoE models (``moe_groups``): the LM loss routes each microbatch's tokens in
``moe_groups`` groups.  Under a rank plan a rank holds ``1/dp`` of each
microbatch, a whole number of the reference's groups when ``dp`` divides
``moe_groups``, so it routes ``moe_groups / dp`` groups of its share: the
reference's grouping of the global microbatch.  Other values are refused
(routing across ranks would need the tokens of other ranks).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import diversity
from repro_torch.dist import sharding
from repro_torch.dist.plan import ShardingPlan, all_reduce_mean, use_plan
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tf
from repro_torch.models.moe_ep import expert_parallel
from repro_torch.models.probes import probe_grads, tp_sum
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils import pytree as ptu


def _micro_size(x: torch.Tensor, num_micro: int) -> int:
    b = x.shape[0]
    if b % num_micro != 0:
        raise ValueError(
            f"global batch {b} is not divisible by the num_micro bucket "
            f"{num_micro}; batch sizes must land on the bucket lattice "
            f"(core/batch_policy.bucket)"
        )
    return b // num_micro


def _to_micro(x: torch.Tensor, num_micro: int, dp_size: int = 1) -> torch.Tensor:
    """``(B, ...) -> (num_micro, B // num_micro, ...)``, the reference's
    relayout: with ``dp_size > 1`` (and a microbatch it divides) the batch
    splits as ``(dp, num_micro, m / dp)`` and each microbatch gathers its
    rows from every dp block."""
    m = _micro_size(x, num_micro)
    if dp_size > 1 and m % dp_size == 0:
        x = x.reshape(dp_size, num_micro, m // dp_size, *x.shape[1:])
        return x.transpose(0, 1).reshape(num_micro, m, *x.shape[3:])
    return x.reshape(num_micro, m, *x.shape[1:])


def _rank_micro(x: torch.Tensor, num_micro: int, dp_size: int,
                positions: list[int]) -> torch.Tensor:
    """This rank's share of each microbatch, ``(num_micro, len(positions) *
    m / dp, ...)``: the rows of dp blocks ``positions`` of ``_to_micro``'s
    layout.  Raises when a microbatch does not split over the dp shards."""
    m = _micro_size(x, num_micro)
    if m % dp_size:
        raise ValueError(
            f"a microbatch of {m} does not split over the {dp_size} data-parallel "
            f"shards; batch sizes must land on the bucket lattice "
            f"(core/batch_policy.bucket) with a granule that is a multiple of "
            f"{dp_size}")
    x = x.reshape(dp_size, num_micro, m // dp_size, *x.shape[1:])[positions]
    return x.transpose(0, 1).reshape(num_micro, len(positions) * (m // dp_size),
                                     *x.shape[3:])


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
    dp_size: int = 1,
    moe_groups: int = 1,
    plan: ShardingPlan | None = None,
    diversity_on: bool = True,
    loss_fn: Callable | None = None,
    estimator: str = "moment",
    example_loss: Callable | None = None,
    probe_loss: Callable | None = None,
    probe_specs: Callable | None = None,
    psn_chunk: int | None = None,
    psn_impl: str = "auto",
    on_microbatch: Callable[[int], None] | None = None,
) -> Callable[[TrainState, dict, float], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch, lr) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` defaults to the transformer LM loss
    (``cfg`` required then; its MoE FFNs route in ``moe_groups`` groups of
    a microbatch's tokens).  ``batch`` holds tensors (or arrays)
    with a leading global-batch axis; they move to the parameters' device.
    ``metrics`` holds device scalars: ``loss`` (the mean over microbatches)
    and ``grad_norm_sq``; on the LM loss also the means of its ``ce_loss``
    and ``moe_aux``.

    ``estimator`` selects the in-step tier (see the module docstring):
    "moment" needs nothing extra; "exact" with ``psn_impl="vmap"`` needs
    ``example_loss(params, example)``; "gram", and "exact" with
    ``psn_impl="kernel"``, need ``probe_loss(params, probes, batch) ->
    (loss, acts)`` and ``probe_specs(params, batch_size) -> probes``
    (``models/probes.py``, ``models/small.py``).  ``psn_impl="auto"``
    resolves as in the reference: vmap when ``example_loss`` is given, else
    kernel.  ``psn_chunk`` bounds the vmap width: per-sample gradients are
    formed ``psn_chunk`` samples at a time.  On the LM loss the vmap path
    runs ``vmap(grad(example_loss))`` through the model: the layers run
    without remat there, and the kernel lane launches each attention kernel
    once per layer for the ``psn_chunk`` samples (``models/transformer.py``).

    ``dp_size`` is the data-parallel width the batch is laid out for; with
    a rank ``plan`` the step runs this rank's share and reduces over the
    plan's dp group (the module docstring), and ``dp_size`` must be 1 or
    the plan's."""
    if loss_fn is None and cfg is None:
        raise ValueError("make_train_step needs cfg or loss_fn")
    if diversity_on:
        psn_impl = _check_estimator(estimator, example_loss, probe_loss, probe_specs,
                                    psn_impl)

    group = plan.mesh.group(plan.dp) if plan is not None and plan.mesh.ranked else None
    if group is not None:
        if dp_size not in (1, plan.dp_size):
            raise ValueError(f"dp_size {dp_size} against the plan's {plan.dp_size}")
        dp_size = plan.dp_size
        positions = plan.mesh.local_positions(plan.dp)
        n_ranks = len(plan.mesh.group_ranks(plan.dp))
    if loss_fn is None:
        local_groups = moe_groups
        # moe_impl="ep" routes each rank's tokens over the expert ranks, no groups
        if group is not None and cfg.num_experts and not (
                cfg.moe_impl == "ep" and expert_parallel(plan)):
            if moe_groups % dp_size:
                raise ValueError(
                    f"moe_groups {moe_groups} does not split over the {dp_size} "
                    f"data-parallel ranks: each rank routes whole groups of its share")
            local_groups = moe_groups * len(positions) // dp_size

        def base_loss(p, b):
            return tf.loss_fn(cfg, p, b, moe_groups=local_groups)
    else:
        def base_loss(p, b):
            return loss_fn(p, b), {}
    # the moment tier needs each global microbatch's gradient
    reduce_each = group is not None and diversity_on and estimator == "moment"
    # the MoE FFN reads the plan (moe_impl="ep" routes over its expert axis)
    planned = (lambda: use_plan(plan)) if group is not None else contextlib.nullcontext

    def dp_mean(grads, layout):
        """Each rank's gradients -> the global microbatch mean."""
        if layout is not None:
            return layout.finish_grads(grads)
        return all_reduce_mean(grads, group, n_ranks)

    def _probe_sq_norms(params, mb: dict, *, bias: bool) -> torch.Tensor:
        """One probe-gradient pass -> the summed per-sample sq-norms through
        the psgn kernels (same-shape layers fused into one launch); on a tp
        plan each rank's layers' part, summed over tp (``probes.tp_sum``)."""
        bsz = next(iter(mb.values())).shape[0]
        with planned():  # the probes take the plan's tp widths
            _, acts, pgrads = probe_grads(probe_loss, params, probe_specs(params, bsz), mb)
        norms = kernel_ops.persample_sq_norm_tree(acts, pgrads, scale=float(bsz), bias=bias)
        return tp_sum(params, norms, bsz, next(iter(mb.values())).device).sum()

    def _vmap_sq_norms(params, mb: dict) -> torch.Tensor:
        """The exact tier's vmap path, ``psn_chunk`` samples at a time."""
        n = next(iter(mb.values())).shape[0]
        chunk = min(psn_chunk or n, n)
        total = torch.zeros((), dtype=torch.float32, device=ptu.leaves(params)[0].device)
        layout = sharding.layout_of(params)
        whole = None if layout is None else {
            name: layout.unshard(name, p.detach()) for name, p in params.named_parameters()}
        for i in range(0, n, chunk):
            sub = {k: v[i:i + chunk] for k, v in mb.items()}
            total = total + diversity.persample_sq_norms(example_loss, params, sub,
                                                         whole).sum()
        return total

    def train_step(state: TrainState, batch: dict, lr) -> tuple[TrainState, dict]:
        params = ptu.leaves(state.params)
        dev = params[0].device
        layout = sharding.layout_of(state.params)
        if layout is not None and group is None:
            raise ValueError("a sharded state steps under its rank plan (plan=)")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if group is not None:
            micro = {k: _rank_micro(v, num_micro, dp_size, positions)
                     for k, v in batch.items()}
        else:
            micro = {k: _to_micro(v, num_micro, dp_size) for k, v in batch.items()}
        global_batch = next(iter(batch.values())).shape[0]
        micro_global = float(global_batch // num_micro)

        grads_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        sq_sum = torch.zeros((), dtype=torch.float32, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        extra_sum: dict = {}
        for j in range(num_micro):
            if on_microbatch is not None:
                on_microbatch(j)
            mb = {k: v[j] for k, v in micro.items()}
            with planned():
                loss, extra = base_loss(state.params, mb)
                grads = torch.autograd.grad(loss, params)
            if reduce_each:
                grads = dp_mean(grads, layout)
            with torch.no_grad():
                for a, g in zip(grads_acc, grads):
                    a.add_(g)
                if diversity_on and estimator == "moment":  # ||m * g_j||^2
                    sq_sum += (micro_global * micro_global) * ptu.tree_sq_norm(grads, layout)
                loss_sum += loss.detach().float()
                for k, v in extra.items():
                    extra_sum[k] = extra_sum.get(k, 0.0) + v.detach().float()
            # the main pass's graph is gone (autograd.grad freed it): the probe
            # pass never holds activations beside it
            del grads, loss, extra
            if diversity_on and estimator != "moment":
                if estimator == "exact" and psn_impl == "vmap":
                    with planned():
                        sq_sum += _vmap_sq_norms(state.params, mb)
                else:
                    sq_sum += _probe_sq_norms(state.params, mb,
                                              bias=estimator == "exact")
        if on_microbatch is not None:
            on_microbatch(num_micro)
        with torch.no_grad():
            if group is not None:
                if not reduce_each:
                    grads_acc = dp_mean(grads_acc, layout)
                # summed over the ranks: the loss and its metrics, and a
                # per-sample tier's sq_sum (the moment tier's is global already)
                sums = all_reduce_mean([torch.stack([loss_sum, sq_sum, *extra_sum.values()])],
                                       group, 1)[0]
                loss_sum = sums[0] / n_ranks
                if not reduce_each:
                    sq_sum = sums[1]
                extra_sum = {k: sums[2 + i] / n_ranks for i, k in enumerate(extra_sum)}
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
            metrics = {"loss": loss_sum / num_micro,
                       "grad_norm_sq": ptu.tree_sq_norm(grads, layout),
                       **{k: v / num_micro for k, v in extra_sum.items()}}
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
