"""State movement between ladder rungs.

Counterpart of ``repro/elastic/reshard.py``.  ``reshard`` moves a full
``TrainState`` (parameters, optimizer state, diversity accumulators,
compression residuals) from one rung's plan onto another's.  Every rung the
port runs lives on one physical device (``dist.plan.Mesh.physical_device``),
and nothing is sharded within it: the state moves with ``.to(device)``,
value-exact.  With ``donate=True`` the source is moved in place (a module's
``.to`` is in place, tensors already on the device are kept); with
``donate=False`` the caller's state is copied first and left as it was.

When source and destination describe the same rung (``same_plan``) the
function is a STRICT no-op: it returns the identical state object.  Between
two rungs over the same physical device nothing moves either (only the
returned object is new when ``donate=False``).

``place`` is the restore-time variant: a host tree (numpy or tensors) onto
a plan's device, or the CPU when no plan is given.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.dist.plan import ShardingPlan

Tree = Any


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


def reshard(state: Tree, src_plan: ShardingPlan | None, dst_plan: ShardingPlan | None,
            *, donate: bool = True) -> Tree:
    """Move ``state`` from ``src_plan``'s rung onto ``dst_plan``'s.

    Strict no-op (the very same object) when the rung is unchanged.
    ``dst_plan=None`` leaves the state on its device.  Raises
    ``NotImplementedError`` for a destination over several physical
    devices."""
    if same_plan(src_plan, dst_plan):
        return state
    if not donate:
        state = copy.deepcopy(state)
    if dst_plan is None:
        return state
    return _move(state, dst_plan.mesh.physical_device())


def place(tree: Tree, plan: ShardingPlan | None) -> Tree:
    """Put a host (or device) tree onto ``plan``'s device; the default
    device (the card) when ``plan`` is None."""
    dev = plan.mesh.physical_device() if plan is not None else resolve_device()
    return _move(tree, dev)
