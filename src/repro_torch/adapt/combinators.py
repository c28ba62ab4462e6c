"""The typed learning-rate coupling of the adaptation layer.

Counterpart of ``repro/adapt/combinators.py``, so far only ``LrCoupling``
(the batch -> lr scaling rule and the background decay an
``AdaptationProgram`` applies).  The reference's policy combinators
(``Clamped``, ``BoundedRung``, ``Warmup``, ``Hysteresis``, ``Chain``,
``Switch``) are not ported yet (ROADMAP.md, Queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.controller import lr_rescale, step_decay

__all__ = ["LrCoupling", "lr_rescale", "step_decay"]


@dataclasses.dataclass(frozen=True)
class LrCoupling:
    """How the learning rate follows the batch size.

    rule    'linear' (Goyal et al. scaling), 'sqrt', or 'none'.
    decay   optional background schedule ``(epoch, lr) -> lr`` applied at
            every epoch boundary on top of the coupling (e.g.
            ``step_decay(0.75, 20)``, the paper's synthetic setting).
    """

    rule: str = "none"
    decay: Callable[[int, float], float] | None = None

    def __post_init__(self):
        if self.rule not in ("none", "linear", "sqrt"):
            raise ValueError(f"unknown lr coupling rule {self.rule!r}")

    @classmethod
    def linear(cls, decay=None) -> "LrCoupling":
        return cls("linear", decay)

    @classmethod
    def sqrt(cls, decay=None) -> "LrCoupling":
        return cls("sqrt", decay)

    @classmethod
    def none(cls, decay=None) -> "LrCoupling":
        return cls("none", decay)

    def rescale(self, lr: float, m_old: int, m_new: int) -> float:
        return lr_rescale(self.rule, lr, m_old, m_new)

    def background(self, epoch: int, lr: float) -> float:
        return self.decay(epoch, lr) if self.decay is not None else lr
