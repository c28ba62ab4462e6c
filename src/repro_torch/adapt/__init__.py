"""The tensor-free adaptation signals the serving slice needs (``Clock``,
``ThroughputWindow``); the policy layer comes with the training slice."""

from repro_torch.adapt.signals import Clock, ThroughputWindow

__all__ = ["Clock", "ThroughputWindow"]
