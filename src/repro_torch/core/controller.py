"""The batch -> learning-rate rules the adaptation layer imports.

Counterpart of the pure-Python half of ``repro/core/controller.py``:
``lr_rescale`` (Goyal et al. linear / sqrt / none) and ``step_decay``.  The
reference's deprecated ``AdaptiveBatchController`` shim has no counterpart:
the port builds ``adapt.AdaptationProgram`` directly.
"""

from __future__ import annotations

from typing import Callable


def lr_rescale(rule: str, lr: float, m_old: int, m_new: int) -> float:
    if m_old == m_new or rule == "none":
        return lr
    ratio = m_new / m_old
    if rule == "linear":
        return lr * ratio
    if rule == "sqrt":
        return lr * ratio ** 0.5
    raise ValueError(f"unknown lr rescale rule {rule!r}")


def step_decay(factor: float = 0.75, every: int = 20) -> Callable[[int, float], float]:
    """The paper's synthetic-experiment schedule: lr *= factor every N epochs."""

    def schedule(epoch: int, lr: float) -> float:
        if (epoch + 1) % every == 0:
            return lr * factor
        return lr

    return schedule
