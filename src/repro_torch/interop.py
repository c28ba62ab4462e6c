"""Carry parameters and training state between the JAX reference's trees and
the port.

This is the one place that knows how the port's tensors sit in the
reference's trees.  ``layout(model)`` lists, for every leaf of the
reference's parameter tree, its ``/``-joined path, the port parameters it
holds and the change of layout between them:

  * a dense kernel is the reference's ``(d_in, d_out)``, ``nn.Linear``'s
    ``(d_out, d_in)`` in the port (a transpose);
  * a convolution weight is HWIO in the reference, ``(c_out, c_in, k, k)``
    in the port;
  * the transformer's layer ``r * period + p`` is slice ``r`` of the
    reference's pattern position ``pos{p}``, stacked over a leading repeats
    axis;
  * the embedding table is ``embed/embedding``; an embedding-input model's
    frontend is the dense kernel ``frontend/kernel``.

The same layout carries every tree shaped like the parameters: the
optimizer's momenta (a list in ``named_parameters`` order in the port),
the diversity accumulators' ``grad_sum`` (a dict by parameter name).
``reference_state`` gives the reference's ``TrainState`` of a port
``TrainState`` (records with the reference's field names, so a checkpoint
holds the reference's paths: ``opt_state/momentum/<param path>``,
``div_state/grad_sum/...``, ``div_state/sq_norm_sum``, ``step``) and
``load_reference_state`` writes such a tree back into a port state, in
place.

For the parity tests: ``params_from_jax`` / ``small_params_from_jax`` /
``resnet_params_from_jax`` build the port's model holding the weights of a
reference tree (every leaf a numpy array: the caller does
``jax.tree.map(np.asarray, params)``; this module never imports JAX), and
``params_to_numpy`` is the reverse.
"""

from __future__ import annotations

import collections
import functools
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.ckpt.checkpoint import tree_flatten_with_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.models import resnet, small
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizer import AdamWState, SGDState

#: one leaf of the reference's parameter tree: its path, the port
#: parameters it holds (several when ``stacked`` over the leading axis), and
#: the layout change ``form`` ("", "t" or "hwio")
Leaf = collections.namedtuple("Leaf", "path names form stacked")

# the reference's state records (field names and order are the tree paths)
TrainState = collections.namedtuple("TrainState", "params opt_state div_state step err_state")
SGDStateRef = collections.namedtuple("SGDState", "momentum")
AdamWStateRef = collections.namedtuple("AdamWState", "mu nu count")
DiversityState = collections.namedtuple(
    "DiversityState", "grad_sum sq_norm_sum mb_count sample_count")

_TO_REF = {"": lambda t: t, "t": lambda t: t.t(), "hwio": lambda t: t.permute(2, 3, 1, 0)}
_FROM_REF = {"": lambda t: t, "t": lambda t: t.t(), "hwio": lambda t: t.permute(3, 2, 0, 1)}


def _ref_name(name: str, ndim: int) -> tuple[str, str]:
    path = name.replace(".", "/")
    if path == "embed/weight":
        return "embed/embedding", ""
    if path.endswith("/weight") and ndim == 2:
        return path[: -len("weight")] + "kernel", "t"
    return path, "hwio" if ndim == 4 else ""


def layout(model: nn.Module) -> list[Leaf]:
    """The reference's parameter leaves of ``model`` (a transformer, a small
    model or a ResNet)."""
    period = model.cfg.period if isinstance(model, tf.Transformer) else None
    groups: dict[str, Leaf] = {}
    for name, p in model.named_parameters():
        ref, stacked = name, False
        if period is not None and name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            ref, stacked = f"pos{int(i) % period}.{rest}", True
        path, form = _ref_name(ref, p.dim())
        if path in groups:
            groups[path].names.append(name)
        else:
            groups[path] = Leaf(path, [name], form, stacked)
    return list(groups.values())


def _to_ref(tensors: list, form: str, stacked: bool) -> torch.Tensor:
    ts = [_TO_REF[form](t.detach()) for t in tensors]
    return torch.stack(ts) if stacked else ts[0].contiguous()


def _nest(pairs) -> dict:
    """A nested tree from ``(path, leaf)`` pairs; a dict keyed 0..n-1 becomes
    a list (the reference's sequences)."""
    root: dict = {}
    for path, leaf in pairs:
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out) and \
                sorted(int(k) for k in out) == list(range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


def to_reference(model: nn.Module, named: dict, *, lazy: bool = False) -> dict:
    """The reference's tree of ``named`` (port parameter name -> tensor, a
    tree shaped like ``model``'s parameters).  ``lazy`` leaves are functions
    that form the leaf when called (``ckpt`` calls them one at a time)."""
    pairs = []
    for leaf in layout(model):
        fn = functools.partial(_to_ref, [named[n] for n in leaf.names], leaf.form,
                               leaf.stacked)
        pairs.append((leaf.path, fn if lazy else fn()))
    return _nest(pairs)


@torch.no_grad()
def from_reference(model: nn.Module, named: dict, tree: Any) -> None:
    """Write the reference tree ``tree`` into ``named``'s tensors in place."""
    flat = dict(tree_flatten_with_paths(tree))
    for leaf in layout(model):
        src = _tensor(flat[leaf.path])
        dst0 = named[leaf.names[0]]
        src = src.to(dst0.device)
        for i, n in enumerate(leaf.names):
            part = src[i] if leaf.stacked else src
            dst = named[n]
            part = _FROM_REF[leaf.form](part)
            if tuple(part.shape) != tuple(dst.shape):
                raise ValueError(f"{leaf.path}: shape {tuple(part.shape)} does not fit "
                                 f"{n} {tuple(dst.shape)}")
            dst.copy_(part)


# ---------------------------------------------------------------------------
# the training state
# ---------------------------------------------------------------------------


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def reference_state(state, *, target: bool = False) -> TrainState:
    """The reference's ``TrainState`` of a port ``TrainState`` (no
    ``err_state``: compression residuals are transient wire state, never
    checkpointed).  Leaves are functions forming each leaf on demand (for
    ``CheckpointManager.save``) or, with ``target``, meta tensors of the
    reference's shapes and the port's dtypes (a restore target)."""
    model = state.params
    params = dict(model.named_parameters())
    names = list(params)

    def tree(named: dict) -> dict:
        if target:
            return to_reference(model, {k: _meta(v) for k, v in named.items()})
        return to_reference(model, named, lazy=True)

    def scalar(t: torch.Tensor):
        return _meta(t) if target else t

    def count(n: int):
        c = torch.tensor(n, dtype=torch.int32)
        return _meta(c) if target else c

    opt = state.opt_state
    if isinstance(opt, SGDState):
        ref_opt = SGDStateRef(tree(dict(zip(names, opt.momentum))) if opt.momentum else ())
    elif isinstance(opt, AdamWState):
        ref_opt = AdamWStateRef(tree(dict(zip(names, opt.mu))),
                                tree(dict(zip(names, opt.nu))), count(opt.count))
    else:
        raise TypeError(f"no reference layout for optimizer state {type(opt).__name__}")
    div = state.div_state
    ref_div = DiversityState(tree(div.grad_sum), scalar(div.sq_norm_sum),
                             scalar(div.mb_count), scalar(div.sample_count))
    return TrainState(tree(params), ref_opt, ref_div, count(int(state.step)), None)


@torch.no_grad()
def load_reference_state(state, *, params: Any, opt_state: Any, div_state: Any,
                         step: int | None = None):
    """Write reference trees (as ``CheckpointManager.restore`` returns them
    for ``reference_state(state, target=True)``'s parts) into the port
    ``state`` in place, on its device; returns the state with ``step`` set
    (unchanged when None)."""
    model = state.params
    named = dict(model.named_parameters())
    names = list(named)
    from_reference(model, named, params)
    opt = state.opt_state
    if isinstance(opt, SGDState):
        if opt.momentum:
            from_reference(model, dict(zip(names, opt.momentum)), opt_state.momentum)
    else:
        from_reference(model, dict(zip(names, opt.mu)), opt_state.mu)
        from_reference(model, dict(zip(names, opt.nu)), opt_state.nu)
        opt.count = int(opt_state.count)
    div = state.div_state
    from_reference(model, div.grad_sum, div_state.grad_sum)
    for name in ("sq_norm_sum", "mb_count", "sample_count"):
        getattr(div, name).copy_(_tensor(getattr(div_state, name)))
    return state if step is None else state._replace(step=int(step))


# ---------------------------------------------------------------------------
# reference trees of numpy arrays (the parity tests)
# ---------------------------------------------------------------------------


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def params_to_numpy(model: nn.Module, cfg: ModelConfig | None = None) -> dict:
    """The reference's parameter tree of ``model``'s weights as numpy arrays
    (bf16 weights come back as float32)."""
    named = dict(model.named_parameters())
    return _nest((leaf.path, _array(_to_ref([named[n] for n in leaf.names], leaf.form,
                                            leaf.stacked)))
                 for leaf in layout(model))


def _load(model: nn.Module, tree: dict, trainable: bool) -> nn.Module:
    from_reference(model, dict(model.named_parameters()), tree)
    return model.requires_grad_(trainable)


def params_from_jax(tree: dict, cfg: ModelConfig, *, trainable: bool = False
                    ) -> tf.Transformer:
    """The port's transformer (on the CPU) holding the weights of ``tree``
    (its dtype: the token table's, or the embedding frontend's)."""
    first = tree["embed"]["embedding"] if "embed" in tree else tree["frontend"]["kernel"]
    model = tf.build(cfg, "cpu", _tensor(first).dtype)
    return _load(model, tree, trainable)


def small_params_from_jax(tree: dict, *, trainable: bool = True):
    """The port's ``Logreg`` (a ``{"linear": ...}`` tree) or ``MLP`` (a
    ``{"fc1": ..., "fc2": ...}`` tree) on the CPU with the weights of
    ``tree``."""
    if set(tree) == {"linear"}:
        model = small.Logreg(np.asarray(tree["linear"]["kernel"]).shape[0])
    elif set(tree) == {"fc1", "fc2"}:
        model = small.MLP(*np.asarray(tree["fc1"]["kernel"]).shape)
    else:
        raise ValueError(f"not a small-model tree: keys {sorted(tree)}")
    return _load(model, tree, trainable)


def small_params_to_numpy(model) -> dict:
    """The reference's tree of a ``Logreg`` or ``MLP`` as numpy arrays."""
    return params_to_numpy(model)


def resnet_params_from_jax(tree: dict, *, trainable: bool = True) -> resnet.ResNet:
    """The port's ``ResNet`` on the CPU with the weights of a reference
    ``resnet_init`` tree (depth, width and classes read off its shapes)."""
    width = np.asarray(tree["stem"]["conv"]).shape[3]
    depth = 6 * len(tree["stages"][0]) + 2
    classes = np.asarray(tree["head"]["kernel"]).shape[1]
    model = resnet.ResNet(depth, classes, width, device="cpu")
    return _load(model, tree, trainable)
