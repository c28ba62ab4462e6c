"""Error-feedback gradient compression for the cross-pod gradient exchange.

Counterpart of ``repro/dist/compression.py``.  Between pods the gradient
exchange crosses the slow network, so it travels as int8 with one float32
absmax scale per leaf, 4x fewer bytes than float32; error feedback (Seide
et al. 2014; Karimireddy et al. 2019) carries each round's quantisation
residual into the next round's quantiser input, so the transmitted signal
integrates to the true signal over time.

``_quantize``             per-tensor absmax int8 of one leaf, on the
                          hand-written kernel (``kernels/quant.py``) with
                          the leaf viewed as one row.
``compress_leaf``         one leaf with error feedback: the dequantised
                          transmit value and the new residual.
``compressed_pod_mean``   each pod quantises its leaves (folding in its own
                          residual) on its own device; the all-gather
                          brings every pod's int8 payload and scale to
                          where the mean is formed, where they are
                          dequantised and averaged with plain ops.  Pods of
                          one process (virtual devices) gather by a copy;
                          pods that are ranks gather over the pod process
                          group (``group=``): one flat all-gather of the
                          rank's codes and scales, as bytes.
``make_compressed_pod_mean``  the same over trees whose leaves carry a
                          leading pod axis, on a mesh's pod axis.

Production caller: ``repro_torch.pod.step.make_pod_train_step``, the step
``PodLadder`` builds for every cross-pod rung, with the residuals kept in
``TrainState.err_state``.  Trees are lists or dicts of tensors
(``utils.pytree``); residuals are float32 whatever the gradients' type.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import quant as quant_kernels
from repro_torch.utils import pytree as ptu

Tree = Any

_QMAX = 127.0


def _rebuild(like: Tree, leaves: list) -> Tree:
    """``leaves`` in the structure of ``like`` (a dict keeps its keys)."""
    if isinstance(like, dict):
        return dict(zip(like.keys(), leaves))
    return list(leaves)


def init_error_state(grads: Tree) -> Tree:
    """Zero float32 residuals, one per gradient leaf."""
    return _rebuild(grads, [torch.zeros_like(g, dtype=torch.float32)
                            for g in ptu.leaves(grads)])


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: ``(q int8 shaped like x, scale float32 0-d)``,
    ``scale = max(max|x|, 1e-12) / 127``."""
    q, scales = quant_kernels.quantize_int8(x.reshape(1, -1))
    return q.reshape(x.shape), scales.reshape(())


@torch.no_grad()
def compress_leaf(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise one gradient leaf with error feedback.

    Returns ``(dequantized, new_err)``: ``dequantized`` is what the wire
    carries (reconstructed to g's type), ``new_err`` the float32 residual
    to feed back next round.  Works on any shape, scalars included."""
    x = g.float() + err.float()
    q, scale = _quantize(x)
    deq = q.float() * scale
    return deq.to(g.dtype), x - deq


@torch.no_grad()
def pod_exchange(grads: Sequence[Tree], err: Sequence[Tree],
                 device: torch.device | str | None = None
                 ) -> tuple[list[torch.Tensor], list[list[torch.Tensor]], torch.Tensor]:
    """The body of :func:`compressed_pod_mean` over leaf lists, also
    returning the ``(pods, leaves)`` float32 scales that crossed the wire."""
    pods = len(grads)
    if pods < 1 or len(err) != pods:
        raise ValueError(f"{pods} gradient trees against {len(err)} residual trees")
    leaves = [ptu.leaves(g) for g in grads]
    err_leaves = [ptu.leaves(e) for e in err]
    if any(len(e) != len(leaves[0]) for e in leaves + err_leaves):
        raise ValueError("grads/err tree mismatch")
    dev = torch.device(device) if device is not None else leaves[0][0].device
    codes, scales, new_errs = _quantize_pods(leaves, err_leaves)
    # the all-gather: int8 payload + scale
    codes = [[q.to(dev) for q in qs] for qs in codes]
    scales = [[s.to(dev) for s in ss] for ss in scales]
    means, stacked = _pod_mean(codes, scales, leaves[0])
    return means, new_errs, stacked


def _quantize_pods(leaves: list[list[torch.Tensor]], err_leaves: list[list[torch.Tensor]]):
    """Each pod's leaves with its residual folded in, quantised:
    ``(codes[p][i], scales[p][i], new residuals[p][i])``."""
    codes, scales, new_errs = [], [], []
    for g, e in zip(leaves, err_leaves):
        qs, ss, es = [], [], []
        for gi, ei in zip(g, e):
            x = gi.float() + ei.float()
            q, scale = _quantize(x)
            qs.append(q)
            ss.append(scale)
            es.append(x - q.float() * scale)
        codes.append(qs)
        scales.append(ss)
        new_errs.append(es)
    return codes, scales, new_errs


def _pod_mean(codes, scales, like: list[torch.Tensor]):
    """Dequantise every pod's codes and average over the pods in pod order:
    ``(means in each leaf's type, (pods, leaves) scales)``."""
    means, stacked = [], []
    for i, t in enumerate(like):
        s_all = torch.stack([s[i] for s in scales])
        deq = torch.stack([q[i] for q in codes]).float() * s_all.reshape((-1,) + (1,) * t.dim())
        means.append(deq.mean(dim=0).to(t.dtype))
        stacked.append(s_all)
    return means, torch.stack(stacked, dim=1)


@torch.no_grad()
def ranked_pod_exchange(grads: Sequence[Tree], err: Sequence[Tree], group,
                        pod_ranks: Sequence[int], extras: torch.Tensor | None = None):
    """The cross-pod exchange when pods are ranks.

    ``grads[k]``, ``err[k]`` are the trees of this rank's pods, in pod order;
    ``pod_ranks[p]`` is pod p's rank (every rank of ``group`` holds the same
    number of pods).  Each rank quantises its own leaves, folding in its own
    residuals, on its own device; the int8 codes (as bytes), the float32
    scales and ``extras`` (a float32 vector of the rank's own per-step
    values, the same length on every rank) cross as ONE all-gather over
    ``group``; every rank then dequantises and averages in pod order with
    :func:`pod_exchange`'s ops, so the mean has the same bits on every rank
    and as on one process.  Returns ``(means, new residual leaves of this
    rank's pods, (pods, leaves) scales, {rank: its extras}, bytes gathered
    per rank)``."""
    leaves = [ptu.leaves(g) for g in grads]
    err_leaves = [ptu.leaves(e) for e in err]
    codes, scales, new_errs = _quantize_pods(leaves, err_leaves)
    like = leaves[0]
    n_local, n_leaves = len(leaves), len(like)
    extras = extras if extras is not None else torch.zeros(0, device=like[0].device)
    # float32 first (aligned at byte 0), then the int8 codes
    floats = torch.cat([torch.stack([s for ss in scales for s in ss]),
                        extras.float().reshape(-1)])
    payload = torch.cat([floats.view(torch.uint8)]
                        + [q.reshape(-1).view(torch.uint8) for qs in codes for q in qs])
    ranks = sorted(set(int(r) for r in pod_ranks))
    gathered = [torch.empty_like(payload) for _ in ranks]
    dist.all_gather(gathered, payload, group=group)
    n_floats = floats.numel()
    per_rank = {}
    for r, buf in zip(ranks, gathered):
        f = buf[:4 * n_floats].view(torch.float32)
        s = f[:n_local * n_leaves].reshape(n_local, n_leaves)
        off, qs_r = 4 * n_floats, []
        for _ in range(n_local):
            qs = []
            for t in like:
                qs.append(buf[off:off + t.numel()].view(torch.int8).view(t.shape))
                off += t.numel()
            qs_r.append(qs)
        per_rank[r] = (qs_r, [list(row) for row in s], f[n_local * n_leaves:])
    all_codes, all_scales, seen = [], [], {r: 0 for r in ranks}
    for r in pod_ranks:
        qs_r, ss_r, _ = per_rank[int(r)]
        all_codes.append(qs_r[seen[int(r)]])
        all_scales.append(ss_r[seen[int(r)]])
        seen[int(r)] += 1
    means, stacked = _pod_mean(all_codes, all_scales, like)
    return (means, new_errs, stacked, {r: v[2] for r, v in per_rank.items()},
            payload.numel())


def compressed_pod_mean(grads: Sequence[Tree], err: Sequence[Tree],
                        device: torch.device | str | None = None, *, group=None,
                        pod_ranks: Sequence[int] | None = None
                        ) -> tuple[Tree, list[Tree]]:
    """The compressed mean over pods.

    ``grads[p]`` and ``err[p]`` are pod p's gradient and residual trees, on
    pod p's device.  Each pod quantises its leaves (folding in its carried
    residual) where they lie; the int8 tensors and their scalar scales are
    gathered onto ``device`` (default: pod 0's), the only cross-pod bytes,
    dequantised there and averaged over the pods in pod order.  Returns
    ``(mean tree on device, [new residual tree of pod p])``; each residual
    stays with its pod.  With ``group`` (the pod process group) and
    ``pod_ranks`` (each pod's rank), ``grads`` and ``err`` are this rank's
    pods only, the gather is :func:`ranked_pod_exchange`'s, and the
    residuals returned are this rank's."""
    if group is not None:
        means, new_errs = ranked_pod_exchange(grads, err, group, pod_ranks)[:2]
    else:
        means, new_errs, _ = pod_exchange(grads, err, device)
    return (_rebuild(grads[0], means),
            [_rebuild(err[p], new_errs[p]) for p in range(len(new_errs))])


def make_compressed_pod_mean(mesh, axis_name: str):
    """``(grads, err) -> (mean, new_err)`` over stacked trees.

    Both trees carry a leading pod axis whose length is the mesh's
    ``axis_name`` size; pod p's slice is moved to the mesh's p-th device
    along that axis.  The mean comes back on pod 0's device; the residuals
    stay PER POD (stacked again): each pod's next round folds in its own
    residual, which is what makes the error-feedback argument hold."""
    axis = mesh.axis_names.index(axis_name)
    n = mesh.shape[axis_name]
    pod_devices = [d for d in mesh.devices.swapaxes(0, axis).reshape(n, -1)[:, 0]]

    def fn(grads: Tree, err: Tree) -> tuple[Tree, Tree]:
        g_leaves, e_leaves = ptu.leaves(grads), ptu.leaves(err)
        if any(x.shape[0] != n for x in g_leaves + e_leaves):
            raise ValueError(f"stacked leaves must lead with the {n} pods of "
                             f"axis {axis_name!r}")
        per_pod = [_rebuild(grads, [g[p].to(d) for g in g_leaves])
                   for p, d in enumerate(pod_devices)]
        per_err = [_rebuild(err, [e[p].to(d) for e in e_leaves])
                   for p, d in enumerate(pod_devices)]
        mean, new_err = compressed_pod_mean(per_pod, per_err, pod_devices[0])
        stacked = [torch.stack([ptu.leaves(new_err[p])[i].to(pod_devices[0])
                                for p in range(n)]) for i in range(len(e_leaves))]
        return mean, _rebuild(err, stacked)

    return fn
