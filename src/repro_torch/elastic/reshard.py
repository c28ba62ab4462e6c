"""State movement between ladder rungs.

Counterpart of ``repro/elastic/reshard.py``.  ``state_shardings`` gives the
specs of a state on a rung (``infer_pspecs``), ``reshard`` moves a full
``TrainState`` (parameters, optimizer state, diversity accumulators,
compression residuals) from one rung's plan onto another's, and ``place``
puts a host tree onto a rung.

A local rung (every entry a ``torch.device`` of this process) lives on one
physical device (``dist.plan.Mesh.physical_device``) and keeps whole
leaves: its entries share the device, so sharding would save no byte.  The
state moves with ``.to(device)``, value-exact.  With ``donate=True`` the
source is moved in place (a module's ``.to`` is in place, tensors already
on the device are kept); with ``donate=False`` the caller's state is copied
first and left as it was.

When source and destination describe the same rung (``same_plan``) the
function is a STRICT no-op: it returns the identical state object.

Between rank rungs (meshes of ``dist.plan.RankDevice`` entries, one per
rank) the state is sharded: each rank of the destination holds the shard
of every leaf that the reference's ``NamedSharding`` would give its device
(``dist.sharding.state_layout``).  The move gathers each sharded leaf whole
over the source rung's groups, broadcasts it from the destination's first
rank over the destination's whole-mesh group (the ranks that enter the
rung receive the state, the others their own bits back), then keeps this
rank's slice of the destination, leaf by leaf.  A rank outside the
destination keeps its state (whole, once it has helped the source gather
it) and waits at the next boundary.  A plan whose specs shard nothing (the
paper's small models; a rung of one rank) keeps whole leaves and moves
them by one broadcast per dtype, as before sharding existed.

A model alone (an ``nn.Module``, the served model's case) moves the same
way without the broadcast: its values are the same on every rank (they are
never stepped), so a rank gathers its shards over the source rung's groups
(:func:`unshard_module`) and keeps its slice of the destination from its
own whole copy; a rank outside the destination keeps the whole model.

``place`` is the restore-time variant: a host tree onto a plan's device, or
the CPU when no plan is given; on a rank rung it slices the tree by the
specs (a ``TrainState`` or a model by their layout, a tree of the
reference's paths by ``infer_pspecs``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.plan import ShardingPlan, broadcast_

Tree = Any
TrainState = Any  # train.state.TrainState (duck-typed: train imports this module)


def _is_train_state(obj: Any) -> bool:
    return isinstance(getattr(obj, "params", None), nn.Module) and hasattr(obj, "div_state")


def same_mesh(a, b) -> bool:
    """True when two meshes list the same devices under the same axes."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    return a == b


def same_plan(a: ShardingPlan | None, b: ShardingPlan | None) -> bool:
    """True when two plans are the same rung: same mesh, same axis roles."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    return (a.dp == b.dp and a.fsdp == b.fsdp and a.tp == b.tp and a.ep == b.ep
            and same_mesh(a.mesh, b.mesh))


def state_shardings(tree: Tree, plan: ShardingPlan) -> dict:
    """The specs of a tree keyed by the reference's paths on ``plan``
    (``infer_pspecs``; optimizer and diversity accumulators shard like
    their parameters, unmatched leaves replicate) as DTensor placements."""
    return sharding.shardings_of(sharding.infer_pspecs(tree, plan), plan)


def _move(obj: Any, device: torch.device) -> Any:
    """``obj`` with every tensor on ``device``; modules move in place."""
    if isinstance(obj, nn.Module):
        return obj.to(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _move(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a named tuple
        return type(obj)(*(_move(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(v, device) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# the parameter-shaped leaves of a state
# ---------------------------------------------------------------------------


def _aligned(state: TrainState) -> list[tuple[list | dict, Any]]:
    """The containers of a state's parameter-shaped leaves, each aligned
    with ``named_parameters``: ``(container, keys)``, the parameters' own
    ``.data`` included (as a list of the parameters)."""
    names = [n for n, _ in state.params.named_parameters()]
    out: list = [(list(state.params.parameters()), None)]
    opt = state.opt_state
    if dataclasses.is_dataclass(opt):
        for f in dataclasses.fields(opt):
            v = getattr(opt, f.name)
            if isinstance(v, list) and len(v) == len(names):
                out.append((v, None))
    out.append((state.div_state.grad_sum, names))
    return out


def _map_aligned(state: TrainState, fn) -> None:
    """Replace every parameter-shaped leaf ``t`` (parameter ``name``) by
    ``fn(name, t)``, leaf by leaf, in a fixed order."""
    names = [n for n, _ in state.params.named_parameters()]
    for container, keys in _aligned(state):
        for i, name in enumerate(names):
            if keys is None:
                t = container[i]
                new = fn(name, t.data if isinstance(t, nn.Parameter) else t)
                if isinstance(t, nn.Parameter):
                    t.data = new
                else:
                    container[i] = new
            else:
                container[keys[i]] = fn(name, container[keys[i]])


def _set_layout(state: TrainState, layout) -> None:
    state.params.shard_layout = layout
    state.div_state.layout = layout


def shard_module(model: nn.Module, plan: ShardingPlan | None) -> nn.Module:
    """Keep this rank's shard of each of ``model``'s whole parameters (in
    place) and attach their layout; a plan that shards nothing leaves the
    model as it is."""
    layout = sharding.state_layout(model, plan)
    if layout is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = layout.shard(name, p.data)
    model.shard_layout = layout
    return model


def unshard_module(model: nn.Module) -> nn.Module:
    """Every parameter of a sharded model whole (gathered over its layout's
    groups, leaf by leaf: a collective over them), in place; the layout
    dropped.  A whole model comes back as it is."""
    layout = sharding.layout_of(model)
    if layout is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = layout.unshard(name, p.data)
        model.shard_layout = None
    return model


def unshard_state(state: TrainState) -> TrainState:
    """Every parameter-shaped leaf whole (gathered over the layout's groups,
    leaf by leaf: a collective over them); the layout dropped."""
    layout = sharding.layout_of(state.params)
    if layout is not None:
        _map_aligned(state, layout.unshard)
        _set_layout(state, None)
    return state


def _other_tensors(state: TrainState) -> list[torch.Tensor]:
    """The state's tensors that are not parameter-shaped, in a fixed order:
    the model's buffers, the optimizer's other tensors, the diversity
    scalars and any compression residuals."""
    n = len(list(state.params.parameters()))
    out = list(state.params.buffers())
    opt = state.opt_state
    if dataclasses.is_dataclass(opt):
        for f in dataclasses.fields(opt):
            v = getattr(opt, f.name)
            if not (isinstance(v, list) and len(v) == n):
                out += _tensors(v)
    div = state.div_state
    out += [div.sq_norm_sum, div.mb_count, div.sample_count]
    return out + _tensors(state.err_state)


def reshard(state: Tree, src_plan: ShardingPlan | None, dst_plan: ShardingPlan | None,
            *, donate: bool = True) -> Tree:
    """Move ``state`` from ``src_plan``'s rung onto ``dst_plan``'s.

    Strict no-op (the very same object) when the rung is unchanged.
    ``dst_plan=None`` leaves the state on its device (whole: a sharded
    state is gathered).  Raises ``NotImplementedError`` for a destination
    over several physical devices."""
    if same_plan(src_plan, dst_plan):
        return state
    if not donate:
        state = copy.deepcopy(state)
    train = _is_train_state(state)
    mesh = dst_plan.mesh if dst_plan is not None else None
    if isinstance(state, nn.Module):
        lay = sharding.layout_of(state)
        if lay is not None and lay.mesh.is_member:
            unshard_module(state)  # a collective over the source rung
        if dst_plan is None or (mesh.ranked and not mesh.is_member):
            return state
        return shard_module(_move(state, mesh.physical_device()), dst_plan)
    if dst_plan is None or (mesh.ranked and not mesh.is_member):
        # outside the rung: gather with the source, then wait at the next boundary
        return unshard_state(state) if train else state
    state = _move(state, mesh.physical_device())
    if not (mesh.ranked and mesh.spans_ranks):
        return unshard_state(state) if train else state
    layout = sharding.state_layout(state.params, dst_plan) if train else None
    group = mesh.group(mesh.axis_names)
    if train:
        unshard_state(state)
    if layout is None:
        tensors = _tensors(state)
        step = getattr(state, "step", None)
        if isinstance(step, int):  # the step count rides as one more tensor
            tensors.append(torch.tensor([step], dtype=torch.int64, device=tensors[0].device))
        broadcast_(tensors, mesh.root, group)
        if isinstance(step, int):
            state = dataclasses.replace(state, step=int(tensors[-1]))
        return state

    def take(name: str, t: torch.Tensor) -> torch.Tensor:
        broadcast_([t], mesh.root, group)
        return layout.shard(name, t)

    with torch.no_grad():
        _map_aligned(state, take)
        rest = _other_tensors(state)
        rest.append(torch.tensor([state.step], dtype=torch.int64, device=rest[0].device))
        broadcast_(rest, mesh.root, group)
    _set_layout(state, layout)
    return dataclasses.replace(state, step=int(rest[-1]))


def _tensors(obj: Any) -> list[torch.Tensor]:
    """Every tensor of ``obj`` (a module's parameters and buffers), in a
    fixed order."""
    if isinstance(obj, nn.Module):
        return [t.data for t in obj.parameters()] + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj.data]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def place(tree: Tree, plan: ShardingPlan | None) -> Tree:
    """Put a host (or device) tree onto ``plan``'s device; the default
    device (the card) when ``plan`` is None.  On a rank rung that shards,
    each rank keeps its slice: a ``TrainState`` or a model by its layout
    (the values must be the same on every rank, as for the reference's
    ``device_put`` of a host tree), a tree of the reference's paths by
    ``infer_pspecs``.  A state already sharded on another rung moves from
    there (``reshard``).  On a rank outside a rank plan's mesh the tree
    stays where it is."""
    if _is_train_state(tree) or isinstance(tree, nn.Module):
        cur = sharding.layout_of(tree.params if _is_train_state(tree) else tree)
        if cur is not None:  # sharded on a rung already: move it from there
            return tree if same_plan(cur.plan, plan) else place(
                reshard(tree, cur.plan, plan), plan)
    if plan is not None and plan.mesh.ranked and not plan.mesh.is_member:
        return tree
    dev = plan.mesh.physical_device() if plan is not None else resolve_device()
    tree = _move(tree, dev)
    if not sharding.shards_state(plan):
        return tree
    if _is_train_state(tree):
        layout = sharding.state_layout(tree.params, plan)
        if layout is not None:
            with torch.no_grad():
                _map_aligned(tree, layout.shard)
            _set_layout(tree, layout)
        return tree
    if isinstance(tree, nn.Module):
        return shard_module(tree, plan)
    from repro_torch.ckpt.checkpoint import _unflatten, tree_flatten_with_paths

    flat = tree_flatten_with_paths(tree)
    tensors = {p: t for p, t in flat if isinstance(t, torch.Tensor)}
    shards = sharding.shard_tree(tensors, plan)
    return _unflatten(tree, iter(shards.get(p, t) for p, t in flat))
