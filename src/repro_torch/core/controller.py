"""Epoch-level adaptive-batch controller (a DEPRECATED shim) and the
batch -> learning-rate rules the adaptation layer imports.

A copy of ``repro/core/controller.py`` (pure Python): ``lr_rescale``
(Goyal et al. linear / sqrt / none), ``step_decay``, ``EpochDecision`` and
``AdaptiveBatchController``, a thin shim over an
``repro_torch.adapt.AdaptationProgram`` (a ``FromBatchPolicy``-wrapped
policy plus a typed ``LrCoupling``), which the ``Trainer`` accepts in place
of a program and drives through the same code path.  New code builds an
``AdaptationProgram`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.batch_policy import BatchPolicy


def lr_rescale(rule: str, lr: float, m_old: int, m_new: int) -> float:
    if m_old == m_new or rule == "none":
        return lr
    ratio = m_new / m_old
    if rule == "linear":
        return lr * ratio
    if rule == "sqrt":
        return lr * ratio ** 0.5
    raise ValueError(f"unknown lr rescale rule {rule!r}")


@dataclasses.dataclass
class EpochDecision:
    epoch: int
    batch_size: int
    lr: float
    diversity: float | None
    raw_batch_size: float
    rescaled: bool


class AdaptiveBatchController:
    """DEPRECATED: thin shim over ``repro_torch.adapt.AdaptationProgram``.

    The constructor and ``on_epoch_end``/``state_dict``/``load_state_dict``
    surfaces are unchanged from the pre-redesign controller; all state lives
    in ``self.program`` (the ``Trainer`` drives that program directly, so
    controller views stay consistent whichever way the run was built).
    """

    def __init__(
        self,
        policy: BatchPolicy,
        base_lr: float,
        lr_rule: str = "none",
        lr_schedule: Callable[[int, float], float] | None = None,
        estimator: str = "moment",
    ):
        """``lr_schedule(epoch, lr) -> lr`` is the *background* decay applied
        on top of batch-coupled rescaling (e.g. x0.75 every 20 epochs)."""
        # deferred import: repro_torch.adapt reaches back into repro_torch.core
        from repro_torch.adapt import AdaptationProgram, FromBatchPolicy, LrCoupling
        from repro_torch.adapt.policy import PolicyBase

        self.policy = policy
        wrapped = policy if isinstance(policy, PolicyBase) else FromBatchPolicy(policy)
        self.program = AdaptationProgram(
            wrapped,
            base_lr,
            LrCoupling(rule=lr_rule, decay=lr_schedule),
            estimator=estimator,
        )
        self.base_lr = float(base_lr)
        self.lr_rule = lr_rule
        self.lr_schedule = lr_schedule
        self.estimator = estimator

    # -- program views (the legacy attribute surface) -------------------------
    @property
    def lr(self) -> float:
        return self.program.lr

    @lr.setter
    def lr(self, value: float) -> None:
        self.program.lr = float(value)

    @property
    def epoch(self) -> int:
        return self.program.epoch

    @property
    def batch_size(self) -> int:
        return self.program.batch_size

    @property
    def needs_diversity(self) -> bool:
        return self.program.needs_diversity

    @property
    def compile_bound(self) -> int:
        """Max distinct step compilations this run can cost a StepEngine:
        the policy's bucket-lattice size (pow2 default:
        log2(m_max/granule) + 1; see BatchPolicy.max_buckets)."""
        return self.program.compile_bound

    @property
    def history(self) -> list[EpochDecision]:
        return [
            EpochDecision(
                epoch=a.epoch,
                batch_size=a.batch_size,
                lr=a.lr,
                diversity=a.diversity,
                raw_batch_size=(
                    a.raw_batch_size if a.raw_batch_size is not None
                    else float(a.batch_size)
                ),
                rescaled=a.rescaled,
            )
            for a in self.program.history
            if a.boundary == "epoch"
        ]

    def on_epoch_end(self, diversity: float | None = None) -> EpochDecision:
        from repro_torch.adapt import Clock, Signals

        applied = self.program.observe(
            Signals(diversity=diversity, batch_size=self.batch_size),
            Clock(epoch=self.epoch, step=-1, boundary="epoch"),
        )
        return EpochDecision(
            epoch=applied.epoch,
            batch_size=applied.batch_size,
            lr=applied.lr,
            diversity=applied.diversity,
            raw_batch_size=(
                applied.raw_batch_size if applied.raw_batch_size is not None
                else float(applied.batch_size)
            ),
            rescaled=applied.rescaled,
        )

    # -- checkpointable state (v2 written, v1 accepted) -----------------------
    def state_dict(self) -> dict:
        return self.program.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.program.load_state_dict(state)


def step_decay(factor: float = 0.75, every: int = 20) -> Callable[[int, float], float]:
    """The paper's synthetic-experiment schedule: lr *= factor every N epochs."""

    def schedule(epoch: int, lr: float) -> float:
        if (epoch + 1) % every == 0:
            return lr * factor
        return lr

    return schedule
