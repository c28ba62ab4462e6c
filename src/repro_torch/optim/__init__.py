from repro_torch.optim.optimizer import (
    AdamWState,
    Optimizer,
    SGDState,
    adamw,
    apply_updates,
    sgd,
)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "Optimizer",
    "SGDState",
    "AdamWState",
    "sgd",
    "adamw",
    "apply_updates",
    "make_schedule",
]
