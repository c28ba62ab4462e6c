"""Production mesh, sharding plan, and the start-up of a process's rank.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a
function over the world's ranks (never module-level state), with the
reference's axes ``(pod,) data, model``; ``make_plan`` is the reference's
rule.  ``init_ranks`` joins this process to its ``torch.distributed``
process group on an explicit backend and returns the device its shards run
on; it refuses two NCCL ranks on one device and never switches backend by
itself.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train_lm --dp 2 --backend gloo
  torchrun --nproc-per-node 2 -m repro_torch.launch.train_lm --tp 2 --backend gloo
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --tp 2 --backend gloo

NCCL wants one card per rank (two ranks on one card fail with "Duplicate
GPU detected"); gloo carries CUDA tensors by staging them through the
host, so several gloo ranks may share one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.plan import Mesh, ShardingPlan, rank_devices, world_size

GIB = 1 << 30

BACKENDS = ("nccl", "gloo")


def rank_device(backend: str, local_rank: int, local_world: int,
                device: torch.device | str = "cuda",
                device_count: int | None = None) -> torch.device:
    """The device of the ``local_rank``-th of ``local_world`` ranks on this
    host.  NCCL takes ``cuda:<local_rank>`` and raises when the host has
    fewer cards than ranks; gloo shares the cards round-robin (or runs on
    the CPU when ``device`` is the CPU)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL carries CUDA tensors only; the CPU takes backend='gloo'")
        return dev
    n = torch.cuda.device_count() if device_count is None else int(device_count)
    if backend == "nccl" and local_world > n:
        raise ValueError(
            f"{local_world} NCCL ranks on this host and {n} card(s): NCCL needs a card "
            f"per rank (two ranks on one device fail with 'Duplicate GPU detected'); "
            f"launch at most {n} ranks per host, or pass backend='gloo'")
    if n == 0:
        resolve_device(dev)  # raises: no card
    return torch.device("cuda", local_rank if backend == "nccl" else local_rank % n)


def init_ranks(backend: str, *, store=None, rank: int | None = None,
               world: int | None = None, device: torch.device | str = "cuda",
               timeout_s: float = 600.0) -> torch.device:
    """Join the default process group on ``backend`` and return this rank's
    device.

    ``rank`` and ``world`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; without a ``store`` the rendezvous is torchrun's
    (``MASTER_ADDR``/``MASTER_PORT``), else the given ``torch.distributed``
    store (a ``FileStore``, say).  A group that is already initialised is
    kept if its backend matches and refused otherwise."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else int(world)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(backend, local_rank, local_world, device)
    if dev.type == "cuda":
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, not {backend}")
        return dev
    kw = {"store": store} if store is not None else {"init_method": "env://"}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def join_world(backend: str, *, ranks: int | None, device: torch.device | str,
               command: str) -> torch.device:
    """Join the world of a CLI launched under torchrun and return this
    rank's device: ``ranks`` of them (at least 2 when None).  Raises, saying
    how to launch ``command``, without a process group of that size."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 0)))
    if (world != ranks) if ranks else (world < 2):
        n = ranks or "N"
        raise RuntimeError(
            f"{command} needs a process group of {n} ranks, found {world or 'none'}: "
            f"launch it with torchrun --nproc-per-node {n} -m {command} ...")
    return init_ranks(backend, device=device)


def rank_setup(backend: str, *, dp: int, device: torch.device | str, elastic: bool,
               granule: int, command: str, tp: int = 0
               ) -> tuple[torch.device, ShardingPlan | None, Any]:
    """``(device, plan, ladder)`` of a CLI's ``--dp`` / ``--tp`` /
    ``--elastic`` under torchrun: this process's rank joins the world on
    ``backend`` (``--dp N`` needs a world of N ranks, N x ``--tp`` with
    both, ``--elastic`` or ``--tp`` alone at least 2).  ``--elastic`` gives
    a ``MeshLadder`` over the world's ranks (with ``--tp N`` its model
    axes ``(("model", N),)``, fixed on every rung); else ``--tp N`` the
    fixed ``(data W/N, model N)`` plan (:func:`make_production_mesh`,
    :func:`make_plan`), and ``--dp`` alone :func:`data_plan`."""
    from repro_torch.elastic import MeshLadder  # elastic imports dist.plan, not this module

    ranks = dp * max(tp, 1) if dp else None
    dev = join_world(backend, ranks=ranks, device=device, command=command)
    if elastic:
        model = (("model", tp),) if tp > 1 else ()
        return dev, None, MeshLadder(rank_devices(dev), granule=granule, model_axes=model)
    if tp:
        return dev, make_plan(make_production_mesh(device=dev, tp=tp)), None
    return dev, data_plan(dev), None


def data_plan(device: torch.device | str) -> ShardingPlan:
    """Data parallelism over the world's ranks: a ``data`` axis with one
    entry per rank, on ``device`` (this rank's), as a ``MeshLadder`` rung
    builds it (``fsdp = ep = data``, no tp axis): the state is sharded over
    the ranks."""
    return ShardingPlan(mesh=Mesh(np.asarray(rank_devices(device), dtype=object), ("data",)),
                        dp=("data",), fsdp=("data",), tp=None, ep=("data",))


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None, tp: int = 1) -> Mesh:
    """The world's ranks as a ``(data, model)`` mesh, or ``(pod, data,
    model)`` with two pods; one entry per rank, each on ``device`` (the
    rank's own; default the card).  The ``model`` axis has ``tp`` ranks
    (the reference's production mesh 16), consecutive ranks: the training
    stack splits each block's heads and FFN widths over them
    (``models/transformer.py``)."""
    world = world_size()
    pods = 2 if multi_pod else 1
    if world % (pods * tp):
        raise ValueError(f"{world} ranks do not split into {pods} pod(s) of model axes of {tp}")
    dev = (torch.device("cpu") if device is not None and torch.device(device).type == "cpu"
           else resolve_device(device or "cuda"))
    shape = ((pods,) if multi_pod else ()) + (world // pods // tp, tp)
    axes = (("pod",) if multi_pod else ()) + ("data", "model")
    return Mesh(np.asarray(rank_devices(dev, world), dtype=object).reshape(shape), axes)


def make_plan(mesh, *, param_bytes: int | None = None,
              fsdp_pod_threshold: int = 2 * GIB) -> ShardingPlan:
    """The sharding plan for a mesh, by the reference's rule.

    On the multi-pod mesh the 'pod' axis always carries data parallelism; it
    is also added to the FSDP/EP axes when the model would otherwise exceed
    ``fsdp_pod_threshold`` parameter bytes per device."""
    axes = mesh.axis_names
    if "pod" in axes:
        dp = ("pod", "data")
        fsdp: tuple[str, ...] = ("data",)
        ep: tuple[str, ...] = ("data",)
        if param_bytes is not None:
            per_device = param_bytes / (mesh.shape["data"] * mesh.shape["model"])
            if per_device > fsdp_pod_threshold:
                fsdp = ("pod", "data")
                ep = ("pod", "data")
        return ShardingPlan(mesh=mesh, dp=dp, fsdp=fsdp, tp="model", ep=ep)
    return ShardingPlan(mesh=mesh, dp=("data",), fsdp=("data",), tp="model", ep=("data",))
