"""Step-wise learning-rate multipliers.

Counterpart of ``repro/optim/schedules.py``: each schedule maps a step
count to a float multiplier.  The batch <-> lr coupling lives in
``adapt/combinators.py::LrCoupling``.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]  # step -> multiplier


def constant() -> Schedule:
    return lambda step: 1.0


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        step = float(step)
        warm = min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0), 1.0)
        return warm * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * progress)))

    return fn


def step_decay_steps(decay_factor: float, every_steps: int) -> Schedule:
    return lambda step: decay_factor ** math.floor(float(step) / every_steps)


def make_schedule(name: str, **kw) -> Schedule:
    name = name.lower()
    if name == "constant":
        return constant()
    if name == "warmup_cosine":
        return warmup_cosine(kw["warmup_steps"], kw["total_steps"], kw.get("final_frac", 0.1))
    if name == "step_decay":
        return step_decay_steps(kw.get("decay_factor", 0.75), kw["every_steps"])
    raise ValueError(f"unknown schedule {name!r}")
