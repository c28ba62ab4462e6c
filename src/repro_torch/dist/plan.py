"""Sharding plans: which mesh axes carry which kind of parallelism.

Counterpart of ``repro/dist/plan.py``.  A ``ShardingPlan`` names the mesh
axes of data parallelism (``dp``), parameter sharding (``fsdp``), tensor
parallelism (``tp``) and expert parallelism (``ep``); ``use_plan`` makes a
plan current for the dynamic extent of a block (a ``contextvars`` variable,
so nesting behaves like lexical scoping, also across exceptions) and
``current_plan`` reads it.

The port has no ``jax.sharding.Mesh``: its :class:`Mesh` is a numpy array of
``torch.device`` with axis names, the devices a rung's shards run on in
mesh order.  The list may name one physical device many times (virtual
devices: eight of them on one card, or on the CPU in the tests, as the
reference forces eight host devices).  The port runs a mesh whose devices
are all one physical device; one spanning several cards belongs to the
scale-out work over process groups (ROADMAP.md, Queue A 5), and
:meth:`Mesh.physical_device` raises for it.  The reference's
``constrain`` activation hook and its PartitionSpec inference have no
counterpart: nothing is sharded within a device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np
import torch

AxisNames = Any  # str | tuple[str, ...]


class Mesh:
    """Devices arranged on named axes: ``devices`` is an object array of
    ``torch.device`` whose shape gives each axis's size."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not fit the axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(str(a) for a in axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices in mesh order (the last axis fastest)."""
        return list(self.devices.flat)

    def physical_device(self) -> torch.device:
        """The one physical device every entry names; raises
        ``NotImplementedError`` when the mesh spans several."""
        devs = set(self.flat())
        if len(devs) != 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} physical devices ({sorted(map(str, devs))}) "
                "needs process groups, which come with scale-out (ROADMAP.md, Queue A 5); "
                "repro_torch runs the virtual devices of one physical device")
        return devs.pop()

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.flat() == other.flat())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted(set(map(str, self.flat())))})"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Mesh + axis assignment for dp/fsdp/tp/ep parallelism."""

    mesh: Mesh
    dp: tuple[str, ...] = ("data",)
    fsdp: tuple[str, ...] = ("data",)
    tp: AxisNames = "model"
    ep: tuple[str, ...] = ("data",)

    def axis_size(self, axes: AxisNames) -> int:
        """Total number of shards over ``axes`` (a name or tuple of names)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.mesh.shape[a] for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    @property
    def fsdp_size(self) -> int:
        return self.axis_size(self.fsdp)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp)

    @property
    def ep_size(self) -> int:
        return self.axis_size(self.ep)


_ACTIVE: contextvars.ContextVar[ShardingPlan | None] = contextvars.ContextVar(
    "repro_torch_dist_active_plan", default=None)


def current_plan() -> ShardingPlan | None:
    """The innermost active plan, or None outside every ``use_plan``."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_plan(plan: ShardingPlan) -> Iterator[ShardingPlan]:
    """Activate ``plan`` for the dynamic extent of the block; the previous
    plan is restored on exit, also on exceptions."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)
