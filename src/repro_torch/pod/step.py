"""The cross-pod train step: the (pod, data) shards of a rung, with the
gradient mean across pods routed through the error-feedback int8
compressor.

Counterpart of ``repro/pod/step.py``, whose step is one ``shard_map``
program over the rung's mesh.  Here the shards run in mesh order on the
rung's virtual devices, which are one physical device (the one parameter
replica lives there):

  1. each (pod, data) shard's loss and gradient, the batch split pod-major
     as ``P((pod, data))`` splits it;
  2. the exact float32 mean within each pod (the reference's ``pmean`` over
     ``data``: the pod's shards summed in order, divided by their count);
  3. the pod means cross pods through ``dist.compression`` (int8 payload +
     float32 scale per leaf, one ``quantize_int8`` launch per pod and leaf),
     residuals per pod in ``TrainState.err_state``;
  4. the update, computed once from the compressed mean.

Diversity accumulates in the same step, as in the reference: the ``moment``
tier treats each pod's uncompressed mean as one microbatch (``mb_count +=
pods``), the ``exact`` tier sums the per-sample squared norms over every
shard.  The ``gram`` tier raises, as it does in the reference.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import diversity
from repro_torch.dist.compression import pod_exchange
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils import pytree as ptu


def make_pod_train_step(
    rung,
    optimizer: Optimizer,
    *,
    loss_fn: Callable,
    example_loss: Callable | None = None,
    diversity_on: bool = True,
    estimator: str = "moment",
    compress: bool = True,
    pod_axis: str = "pod",
    data_axis: str = "data",
) -> Callable[[TrainState, dict, float], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch, lr) -> (state, metrics)`` for a
    cross-pod ``Rung`` (its mesh must carry ``(pod_axis, data_axis)``).

    ``loss_fn(params, batch) -> scalar`` is the mean loss over a batch
    shard; ``example_loss`` is required for the exact tier.  With
    ``compress=True`` ``state.err_state`` must hold the stacked per-pod
    residuals (``PodLadder.adapt_state`` installs them); ``compress=False``
    runs the same step with an exact float32 mean across pods.  ``metrics``
    holds device scalars ``loss`` (the mean over all shards) and
    ``grad_norm_sq``, and with compression ``scales``, the ``(pods,
    leaves)`` float32 scales of this step's exchange."""
    mesh = rung.plan.mesh
    if pod_axis not in mesh.shape or data_axis not in mesh.shape:
        raise ValueError(f"cross-pod step needs a mesh with axes ({pod_axis!r}, "
                         f"{data_axis!r}), got {tuple(mesh.shape)}")
    pods = int(mesh.shape[pod_axis])
    dpp = int(mesh.shape[data_axis])
    if pods < 2:
        raise ValueError(f"cross-pod step needs a pods>=2 mesh axis, got {pods}")
    if estimator == "gram":
        raise NotImplementedError(
            "the gram tier's probe kernels are not wired across pods; use "
            "'moment' (production) or 'exact' (reference) on cross-pod rungs"
        )
    if estimator not in ("exact", "moment"):
        raise ValueError(f"unknown cross-pod estimator {estimator!r}")
    if estimator == "exact" and example_loss is None:
        raise ValueError("estimator='exact' needs example_loss")
    device = mesh.physical_device()  # raises for a rung over several cards
    n_shards = pods * dpp

    def train_step(state: TrainState, batch: dict, lr) -> tuple[TrainState, dict]:
        params = ptu.leaves(state.params)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        global_b = next(iter(batch.values())).shape[0]
        if global_b % n_shards:
            raise ValueError(f"global batch {global_b} does not split over the "
                             f"{pods} x {dpp} (pod, data) shards")
        local_b = global_b // n_shards
        if compress and state.err_state is None:
            raise ValueError(
                "compress=True needs TrainState.err_state (the stacked "
                "per-pod residuals PodLadder.adapt_state installs)")

        pod_grads, losses, sq = [], [], torch.zeros((), dtype=torch.float32, device=device)
        for p in range(pods):
            acc = None
            for d in range(dpp):
                k = p * dpp + d  # P((pod, data)): pod-major
                shard = {n: v[k * local_b:(k + 1) * local_b] for n, v in batch.items()}
                loss = loss_fn(state.params, shard)
                grads = torch.autograd.grad(loss, params)
                losses.append(loss.detach().float())
                with torch.no_grad():
                    acc = [g.clone() for g in grads] if acc is None else \
                        [a + g for a, g in zip(acc, grads)]
                del grads, loss
                if diversity_on and estimator == "exact":
                    sq = sq + diversity.persample_sq_norms(
                        example_loss, state.params, shard).sum()
            with torch.no_grad():
                pod_grads.append([a / dpp for a in acc])  # within-pod exact mean

        with torch.no_grad():
            metrics = {}
            if compress:
                err = [[e[p] for e in state.err_state] for p in range(pods)]
                mean, new_err, metrics["scales"] = pod_exchange(pod_grads, err, device)
                for p in range(pods):  # residuals stay per pod, stepped in place
                    for e, ne in zip(state.err_state, new_err[p]):
                        e[p].copy_(ne)
            else:
                mean = [sum(gs[1:], gs[0]) / pods for gs in zip(*pod_grads)]

            if diversity_on:
                b = float(global_b)
                if estimator == "moment":
                    # one "microbatch" per pod: the UNCOMPRESSED pod mean is
                    # the small-batch statistic, so quantisation noise never
                    # enters Q
                    m_pod = float(global_b // pods)
                    for g in pod_grads:
                        sq = sq + (m_pod * m_pod) * ptu.tree_sq_norm(g)
                    mb = float(pods)
                else:
                    mb = 1.0  # the decode expects m=1 small batches
                div = state.div_state
                torch._foreach_add_(ptu.leaves(div.grad_sum), mean, alpha=b)
                div.sq_norm_sum += sq
                div.mb_count += mb
                div.sample_count += b

            updates, opt_state = optimizer.update(mean, state.opt_state, state.params, lr)
            apply_updates(state.params, updates)
            metrics["loss"] = torch.stack(losses).mean()
            metrics["grad_norm_sq"] = ptu.tree_sq_norm(mean)
        state.opt_state = opt_state
        state.step += 1
        return state, metrics

    return train_step
