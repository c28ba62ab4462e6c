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
                          residual) on its own device; the "all-gather"
                          copies every pod's int8 payload and scale to the
                          device the mean is formed on, where they are
                          dequantised and averaged with plain ops.
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
    means, new_errs, scales = [], [[] for _ in range(pods)], []
    for i, like in enumerate(leaves[0]):
        q_all, s_all = [], []
        for p in range(pods):
            x = leaves[p][i].float() + err_leaves[p][i].float()
            q, scale = _quantize(x)
            new_errs[p].append(x - q.float() * scale)
            q_all.append(q.to(dev))  # the all-gather: int8 payload + scale
            s_all.append(scale.to(dev))
        s_all = torch.stack(s_all)
        deq = torch.stack(q_all).float() * s_all.reshape((-1,) + (1,) * like.dim())
        means.append(deq.mean(dim=0).to(like.dtype))
        scales.append(s_all)
    return means, new_errs, torch.stack(scales, dim=1)


def compressed_pod_mean(grads: Sequence[Tree], err: Sequence[Tree],
                        device: torch.device | str | None = None
                        ) -> tuple[Tree, list[Tree]]:
    """The compressed mean over pods.

    ``grads[p]`` and ``err[p]`` are pod p's gradient and residual trees, on
    pod p's device.  Each pod quantises its leaves (folding in its carried
    residual) where they lie; the int8 tensors and their scalar scales are
    gathered onto ``device`` (default: pod 0's), the only cross-pod bytes,
    dequantised there and averaged over the pods in pod order.  Returns
    ``(mean tree on device, [new residual tree of pod p])``; each residual
    stays with its pod."""
    means, new_errs, _ = pod_exchange(grads, err, device)
    return (_rebuild(grads[0], means),
            [_rebuild(err[p], new_errs[p]) for p in range(len(grads))])


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
