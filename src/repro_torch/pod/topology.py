"""Pod topology: pods x devices-per-pod over one flat device list.

Counterpart of ``repro/pod/topology.py``.  The flat device list is cut into
equal contiguous virtual pods, so the cross-pod mesh axis, the compressed
gradient exchange and the degrade path all run in one process.  The list
may name one physical device many times (eight virtual devices on the card,
or on the CPU in the tests), so a device is named by its position in the
list: ``pod_of(i)`` is the pod of the i-th device.
"""

from __future__ import annotations

from typing import Any, Sequence


class PodTopology:
    """Equal partition of a flat device list into ``num_pods`` virtual pods.

    ``pods[i]`` is pod *i*'s device list (contiguous, in order), so pod 0's
    devices are always a prefix of the flat list — the prefix-nesting
    ``MeshLadder`` relies on.  ``devices`` defaults to the ladder's default
    (eight virtual devices on the card)."""

    def __init__(self, num_pods: int, devices: Sequence[Any] | None = None):
        if devices is None:
            from repro_torch.elastic.ladder import default_devices

            devices = default_devices()
        devices = list(devices)
        num_pods = int(num_pods)
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        if len(devices) % num_pods != 0:
            raise ValueError(
                f"{len(devices)} devices do not partition into {num_pods} "
                f"equal pods"
            )
        self.num_pods = num_pods
        self.devices = devices
        self.devices_per_pod = len(devices) // num_pods
        self.pods: list[list[Any]] = [
            devices[i * self.devices_per_pod : (i + 1) * self.devices_per_pod]
            for i in range(num_pods)
        ]

    def pod_of(self, index: int) -> int:
        """Which pod the ``index``-th device of the flat list belongs to."""
        index = int(index)
        if not 0 <= index < len(self.devices):
            raise ValueError(f"device {index} is not in this topology")
        return index // self.devices_per_pod

    def __len__(self) -> int:
        return self.num_pods

    def __repr__(self) -> str:
        return (
            f"PodTopology(num_pods={self.num_pods}, "
            f"devices_per_pod={self.devices_per_pod})"
        )
