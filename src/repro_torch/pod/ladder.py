"""PodLadder: a MeshLadder whose top rungs span several pods.

Counterpart of ``repro/pod/ladder.py``.  The within-pod rungs are the
ordinary ``MeshLadder`` over pod 0's devices (dp widths 1..devices_per_pod).
Above them sit *cross-pod* rungs, one per power-of-two pod count (plus a
non-pow2 maximum), whose meshes carry a ``(pod, data)`` axis pair over a
prefix of the pod list.  Every rung's devices are a prefix of the next
rung's.

Cross-pod plans set ``fsdp=()`` (parameters replicated): the cross-pod step
computes one update from one compressed gradient mean and applies it to the
one parameter replica of the rung's physical device.  The compression
error-feedback residuals ride in ``TrainState.err_state``; ``adapt_state``
installs, keeps, drops or re-zeros them at every rung transition (a residual
is meaningless on another pod layout).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.dist.plan import Mesh, ShardingPlan
from repro_torch.elastic.ladder import MeshLadder, Rung
from repro_torch.pod.health import PodHealth
from repro_torch.pod.topology import PodTopology
from repro_torch.utils import pytree as ptu


class PodLadder(MeshLadder):
    """Elastic ladder spanning ``pods`` virtual pods.

    Args:
      pods: number of pods to partition ``devices`` into (>= 2).
      devices: flat device list (default: eight virtual devices on the card).
      granule: minimum per-device microbatch, as in ``MeshLadder``.
      dp_axis / pod_axis: mesh axis names.
      compress: route cross-pod gradient means through the error-feedback
        int8 compressor (``dist.compression``); False runs the same rungs
        with an exact float32 mean across pods.
    """

    def __init__(
        self,
        pods: int = 2,
        devices: Sequence[Any] | None = None,
        *,
        granule: int = 1,
        dp_axis: str = "data",
        pod_axis: str = "pod",
        compress: bool = True,
    ):
        pods = int(pods)
        if pods < 2:
            raise ValueError(f"PodLadder needs pods >= 2, got {pods}")
        topo = PodTopology(pods, devices)
        # within-pod rungs: the ordinary ladder over pod 0's devices
        super().__init__(topo.pods[0], granule=granule, dp_axis=dp_axis)
        self.topology = topo
        self.health = PodHealth(pods)
        self.pod_axis = pod_axis
        self.dp_axis = dp_axis
        self.compress = bool(compress)

        dpp = topo.devices_per_pod
        pod_counts = [1 << i for i in range(1, pods.bit_length()) if (1 << i) <= pods]
        if not pod_counts or pod_counts[-1] != pods:
            pod_counts.append(pods)  # non-pow2 pod counts still top out
        for p in pod_counts:
            devs = np.asarray(topo.devices[: p * dpp], dtype=object).reshape(p, dpp)
            # fsdp=() => params replicated; the batch splits over pod x data
            plan = ShardingPlan(
                mesh=Mesh(devs, (pod_axis, dp_axis)),
                dp=(pod_axis, dp_axis),
                fsdp=(),
                tp=None,
                ep=(dp_axis,),
            )
            self.rungs.append(
                Rung(index=len(self.rungs), dp=p * dpp, plan=plan, pods=p)
            )

    # -- selection -----------------------------------------------------------
    def rung_for_batch(self, m: int) -> Rung:
        """Widest ALL-HEALTHY rung for ``m`` (same divisibility/granule rule
        as the base ladder, filtered through ``health.prefix_healthy``); the
        narrowest healthy rung when nothing fits.  Raises when pod 0 is lost
        — no rung excludes pod 0, so the job cannot degrade further."""
        m = int(m)
        best = None
        for rung in self.rungs:
            if not self.health.prefix_healthy(rung.pods):
                continue
            if best is None:
                best = rung
            if m % rung.dp == 0 and m // rung.dp >= self.granule:
                best = rung
        if best is None:
            raise RuntimeError(
                "no healthy rung left (pod 0 is lost); a degrade-don't-restart "
                "supervisor cannot survive losing the primary pod"
            )
        return best

    # -- state hooks ---------------------------------------------------------
    def adapt_state(self, state, src: Rung | None, dst: Rung):
        """Thread the compression residuals across a rung transition.

        Within-pod rungs carry no residuals (``err_state=None``); a cross-pod
        rung gets freshly zeroed stacked ``(pods, *param_shape)`` float32
        tensors on the state's device.  Residuals survive only a transition
        that keeps the pod layout (src.pods == dst.pods); any other move
        re-zeros them."""
        if dst.pods <= 1 or not self.compress:
            # within-pod rungs, and uncompressed cross-pod rungs (a plain
            # mean), carry no residuals
            if state.err_state is None:
                return state
            return state._replace(err_state=None)
        if src is not None and src.pods == dst.pods and state.err_state is not None:
            return state
        zeros = [torch.zeros((dst.pods, *p.shape), dtype=torch.float32, device=p.device)
                 for p in ptu.leaves(state.params)]
        return state._replace(err_state=zeros)

    # -- engine --------------------------------------------------------------
    def engine_for(
        self,
        fns,
        optimizer,
        *,
        estimator: str = "moment",
        diversity_on: bool = True,
        donate: bool = True,
        psn_chunk: int | None = None,
    ):
        """A rung-aware ``StepEngine``: within-pod rungs build the plain
        ``make_train_step``, cross-pod rungs the compressed step
        (``pod/step.py``).  The Trainer picks this up by duck-typing
        instead of ``StepEngine.for_model_fns``."""
        from repro_torch.pod import step as pod_step
        from repro_torch.train import step as step_lib
        from repro_torch.train.engine import StepEngine, eval_fn_for

        injit = ("exact", "gram", "moment")

        def build(key: int, tier: str | None = None, rung: int | None = None):
            est = tier if tier is not None else estimator
            track = diversity_on and est in injit
            r = self.rungs[rung] if rung is not None else None
            if r is not None and r.pods > 1:
                return pod_step.make_pod_train_step(
                    r,
                    optimizer,
                    loss_fn=fns.batch_loss,
                    example_loss=fns.example_loss,
                    diversity_on=track,
                    estimator=est if track else "moment",
                    compress=self.compress,
                    pod_axis=self.pod_axis,
                    data_axis=self.dp_axis,
                )
            if r is not None:
                r.plan.mesh.physical_device()  # raises over several cards
            return step_lib.make_train_step(
                None,
                optimizer,
                1,
                diversity_on=track,
                loss_fn=fns.batch_loss,
                estimator=est if track else "moment",
                example_loss=fns.example_loss,
                probe_loss=fns.probe_loss,
                probe_specs=fns.probe_specs,
                psn_chunk=psn_chunk,
            )

        eng = StepEngine(build, donate=donate, eval_fn=eval_fn_for(fns))
        if diversity_on and estimator in injit:
            eng.tier = estimator
        return eng

    # -- introspection -------------------------------------------------------
    def __repr__(self) -> str:
        return (
            f"PodLadder(pods={self.topology.num_pods}, dp={self.widths}, "
            f"granule={self.granule}, compress={self.compress})"
        )
