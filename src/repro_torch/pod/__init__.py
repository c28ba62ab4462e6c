"""repro_torch.pod — host-spanning elastic rungs (multi-pod data parallelism).

Counterpart of ``repro/pod``.  ``PodTopology`` partitions a flat list of
(virtual) devices into pods; ``PodLadder`` extends ``elastic.MeshLadder``
with cross-pod rungs whose meshes carry a ``pods > 1`` leading axis, on
which the gradient mean crosses pods through the error-feedback int8
compressor (``dist.compression``, on the ``quantize_int8`` kernel), with the
residuals in ``TrainState.err_state``.  ``PodHealth`` tracks which pods are
alive; ``Trainer.demote`` answers a pod loss by moving the run onto the
widest all-healthy rung instead of restarting.
"""

from repro_torch.pod.health import PodHealth
from repro_torch.pod.ladder import PodLadder
from repro_torch.pod.step import make_pod_train_step
from repro_torch.pod.topology import PodTopology

__all__ = ["PodTopology", "PodHealth", "PodLadder", "make_pod_train_step"]
