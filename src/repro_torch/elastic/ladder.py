"""The mesh ladder: nested data-parallel sub-meshes of one device list.

Counterpart of ``repro/elastic/ladder.py``.  A ``MeshLadder`` is an ordered
family of ``ShardingPlan``s ("rungs") built from one flat device list: rung
*i* spans the first ``dp_i * model`` devices arranged as ``(dp_i,
*model_axes)``, with the dp widths a power-of-two chain ``1 -> D`` and the
model axes held fixed.  Rung *i*'s devices are a prefix of rung *j*'s for
i < j, so growing the footprint only fans shards out.

``rung_for_batch(m)`` is the elastic policy: the widest rung whose dp width
divides ``m`` and keeps the per-device microbatch at least ``granule``.

The devices are ``torch.device``s, and the list may name one physical
device many times: the default is eight virtual devices on the card (the
reference forces eight host devices).  A rung's step runs its data-parallel
shards on its virtual devices; a local ladder runs the rungs whose devices
are all one physical device (``dist.plan.Mesh.physical_device``).  Over the
world's ranks the list holds ``dist.plan.RankDevice`` entries
(``dist.plan.rank_devices``): every rung's mesh, and so its process groups,
is built at construction on every rank, a rung over several ranks holds
the state sharded by the reference's rules (``fsdp = ep =`` the dp axis,
``tp =`` the model axes: ``elastic.reshard``) and averages its gradients
over its dp group (``engine_for``), and the widest rung's group carries the
run's decisions (``control``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.dist.plan import Mesh, ShardingPlan

#: virtual devices of the default device list, as the reference forces 8
#: host devices in its tests and launchers
DEFAULT_VIRTUAL_DEVICES = 8


def default_devices() -> list:
    """``DEFAULT_VIRTUAL_DEVICES`` virtual devices on the card (raises
    without one, as every entry point does)."""
    return [resolve_device()] * DEFAULT_VIRTUAL_DEVICES


@dataclasses.dataclass(frozen=True)
class Rung:
    """One step of the ladder: a dp width and its sharding plan.

    ``pods`` is the number of pods the rung spans (1 for every base
    ``MeshLadder`` rung; ``repro_torch.pod.PodLadder`` builds cross-pod
    rungs whose mesh carries a ``pods > 1`` leading axis)."""

    index: int
    dp: int
    plan: ShardingPlan
    pods: int = 1

    @property
    def devices(self) -> int:
        return int(self.plan.mesh.size)


class MeshLadder:
    """Ordered ``ShardingPlan`` family over nested sub-meshes.

    Args:
      devices: flat device list (default: :func:`default_devices`). Rung
        *i* uses a prefix of it.
      granule: minimum per-device microbatch a rung may leave (the batch
        policies' lattice granule — pass the same value to both).
      model_axes: ``((name, size), ...)`` non-dp mesh axes held fixed on
        every rung.
      dp_axis: name of the data axis on every rung's mesh.
      dp_widths: explicit dp widths (sorted, deduped); default is the full
        power-of-two chain 1..max plus the (possibly non-pow2) maximum.
    """

    def __init__(
        self,
        devices: Sequence[Any] | None = None,
        *,
        granule: int = 1,
        model_axes: Sequence[tuple[str, int]] = (),
        dp_axis: str = "data",
        dp_widths: Sequence[int] | None = None,
    ):
        devices = list(devices) if devices is not None else default_devices()
        self.granule = int(granule)
        if self.granule < 1:
            raise ValueError(f"granule must be >= 1, got {granule}")
        model_axes = tuple((str(n), int(s)) for n, s in model_axes)
        model = math.prod(s for _, s in model_axes) if model_axes else 1
        max_dp = len(devices) // model
        if max_dp < 1:
            raise ValueError(
                f"{len(devices)} devices cannot carry the fixed model axes "
                f"{model_axes} (need >= {model})"
            )
        if dp_widths is None:
            dp_widths = [1 << i for i in range(max_dp.bit_length()) if 1 << i <= max_dp]
            if dp_widths[-1] != max_dp:
                dp_widths.append(max_dp)  # non-pow2 device counts still top out
        widths = sorted(set(int(w) for w in dp_widths))
        if widths[0] < 1 or widths[-1] > max_dp:
            raise ValueError(f"dp widths {widths} out of range [1, {max_dp}]")

        names = (dp_axis,) + tuple(n for n, _ in model_axes)
        sizes = tuple(s for _, s in model_axes)
        self.rungs: list[Rung] = []
        for i, w in enumerate(widths):
            devs = np.asarray(devices[: w * model], dtype=object).reshape((w,) + sizes)
            plan = ShardingPlan(
                mesh=Mesh(devs, names),
                dp=(dp_axis,),
                fsdp=(dp_axis,),
                tp=tuple(n for n, _ in model_axes) or None,
                ep=(dp_axis,),
            )
            self.rungs.append(Rung(index=i, dp=w, plan=plan))
        #: whether the rungs are rank meshes (``(rank, device)`` entries)
        self.ranked = self.rungs[0].plan.mesh.ranked

    # -- selection -----------------------------------------------------------
    def rung_for_batch(self, m: int) -> Rung:
        """Widest rung whose dp width divides ``m`` and keeps the per-device
        microbatch >= the granule; the narrowest rung when even that is too
        wide (sub-granule batches run dp=1 rather than erroring)."""
        m = int(m)
        best = self.rungs[0]
        for rung in self.rungs:
            if m % rung.dp == 0 and m // rung.dp >= self.granule:
                best = rung
        return best

    def plan_for_batch(self, m: int) -> ShardingPlan:
        return self.rung_for_batch(m).plan

    # -- state hooks ---------------------------------------------------------
    def adapt_state(self, state, src: Rung | None, dst: Rung):
        """Hook for ladder-specific state at a rung transition, called by the
        Trainer AFTER ``elastic.reshard`` moved ``state`` onto ``dst``
        (``src=None`` for the initial placement).  The base ladder carries
        no rung-dependent state: identity.  ``PodLadder`` installs, drops
        or re-zeros the compression residuals (``TrainState.err_state``)."""
        return state

    # -- ranks -----------------------------------------------------------------
    def control(self) -> tuple[object, tuple[int, ...]]:
        """``(group, ranks)`` that the run's decisions are broadcast over (the
        first rank sends): the widest rung's whole-mesh group.  Rank ladders
        only."""
        mesh = self.full.plan.mesh
        return mesh.group(mesh.axis_names), mesh.group_ranks(mesh.axis_names)

    def engine_for(self, fns, optimizer, *, estimator: str = "moment",
                   diversity_on: bool = True, donate: bool = True,
                   psn_chunk: int | None = None):
        """The Trainer's engine: ``StepEngine.for_model_fns`` on a local
        ladder; on a rank ladder a rung-aware one whose rungs over several
        ranks average their gradients over the rung's dp group."""
        from repro_torch.train import step as step_lib
        from repro_torch.train.engine import StepEngine, eval_fn_for

        if not self.ranked:
            return StepEngine.for_model_fns(fns, optimizer, estimator=estimator,
                                            diversity_on=diversity_on, donate=donate,
                                            psn_chunk=psn_chunk)
        injit = ("exact", "gram", "moment")

        def build(key: int, tier: str | None = None, rung: int | None = None):
            est = tier if tier is not None else estimator
            track = diversity_on and est in injit
            plan = self.rungs[rung].plan
            return step_lib.make_train_step(
                None, optimizer, 1, diversity_on=track, loss_fn=fns.batch_loss,
                estimator=est if track else "moment", example_loss=fns.example_loss,
                probe_loss=fns.probe_loss, probe_specs=fns.probe_specs,
                psn_chunk=psn_chunk, plan=plan if plan.mesh.spans_ranks else None)

        eng = StepEngine(build, donate=donate, eval_fn=eval_fn_for(fns))
        if diversity_on and estimator in injit:
            eng.tier = estimator
        return eng

    # -- introspection -------------------------------------------------------
    @property
    def num_rungs(self) -> int:
        return len(self.rungs)

    @property
    def widths(self) -> list[int]:
        return [r.dp for r in self.rungs]

    @property
    def full(self) -> Rung:
        """The widest rung (the fixed-mesh baseline plan)."""
        return self.rungs[-1]

    def __len__(self) -> int:
        return len(self.rungs)

    def __iter__(self) -> Iterator[Rung]:
        return iter(self.rungs)

    def __repr__(self) -> str:
        return f"MeshLadder(dp={self.widths}, granule={self.granule})"
