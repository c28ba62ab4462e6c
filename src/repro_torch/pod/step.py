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

On a rank mesh (``dist.plan.RankDevice`` entries) each pod is a rank: a
rank runs its own pods' shards in mesh order on its device, and step 3's
gather is one all-gather over the pod process group
(``compression.ranked_pod_exchange``), which also carries each shard's
loss and diversity term, so every rank forms the same loss, ``sq_norm_sum``
and update, to the bit of the one-process step.  A rank keeps its own pods'
residuals.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import diversity
from repro_torch.dist.compression import pod_exchange, ranked_pod_exchange
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.utils import pytree as ptu


def _nth(pod_ranks: list[int], p: int) -> int:
    """Pod p's position among its rank's pods."""
    return pod_ranks[:p].count(pod_ranks[p])


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
    device = mesh.physical_device()  # raises for a local rung over several cards
    n_shards = pods * dpp
    group = None
    local_pods = list(range(pods))
    if mesh.ranked:
        if not compress:
            raise NotImplementedError(
                "an uncompressed cross-pod mean across ranks is not ported "
                "(ROADMAP.md, Queue A 5); use compress=True")
        by_pod = np.moveaxis(mesh.ranks, mesh.axis_names.index(pod_axis), 0).reshape(pods, -1)
        if any(len(set(row.tolist())) != 1 for row in by_pod):
            raise NotImplementedError(
                "a pod spanning several ranks is not ported (ROADMAP.md, Queue A 5): "
                "give each pod's entries one rank")
        pod_ranks = [int(row[0]) for row in by_pod]
        local_pods = [p for p in range(pods) if pod_ranks[p] == mesh.rank]
        group = mesh.group(pod_axis)

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

        # this process's pods: their within-pod means, each shard's loss, and
        # the diversity terms (per shard on the exact tier, per pod on the
        # moment tier: the UNCOMPRESSED pod mean is the small-batch
        # statistic, so quantisation noise never enters Q)
        pod_grads, losses, terms = [], [], []
        for p in local_pods:
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
                    terms.append(diversity.persample_sq_norms(
                        example_loss, state.params, shard).sum())
            with torch.no_grad():
                pod_grads.append([a / dpp for a in acc])  # within-pod exact mean
        m_pod = float(global_b // pods)
        with torch.no_grad():
            if diversity_on and estimator == "moment":
                terms = [(m_pod * m_pod) * ptu.tree_sq_norm(g) for g in pod_grads]

            metrics = {}
            if group is not None:
                err = [[e[i] for e in state.err_state] for i in range(len(local_pods))]
                extras = torch.stack(losses + terms)
                mean, new_err, metrics["scales"], extra, _ = ranked_pod_exchange(
                    pod_grads, err, group, pod_ranks, extras)
                # every shard's loss and term, in pod order: a rank's extras
                # are its pods' losses, then their terms
                n_loc, width = len(local_pods), len(terms) // len(local_pods)
                losses, terms = [], []
                for p in range(pods):
                    v, i = extra[pod_ranks[p]], _nth(pod_ranks, p)
                    losses += list(v[:n_loc * dpp].reshape(n_loc, dpp)[i])
                    if width:
                        terms += list(v[n_loc * dpp:].reshape(n_loc, width)[i])
            elif compress:
                err = [[e[p] for e in state.err_state] for p in range(pods)]
                mean, new_err, metrics["scales"] = pod_exchange(pod_grads, err, device)
            else:
                mean = [sum(gs[1:], gs[0]) / pods for gs in zip(*pod_grads)]
            if compress:
                for i in range(len(local_pods)):  # residuals stay per pod, in place
                    for e, ne in zip(state.err_state, new_err[i]):
                        e[i].copy_(ne)

            if diversity_on:
                b = float(global_b)
                sq = torch.zeros((), dtype=torch.float32, device=device)
                for t in terms:
                    sq = sq + t
                # one "microbatch" per pod on the moment tier; the exact
                # tier's decode expects m=1 small batches
                mb = float(pods) if estimator == "moment" else 1.0
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
