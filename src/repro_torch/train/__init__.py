"""The training path: state, the microbatched step with the in-step
diversity tier, and the bucketed ``StepEngine``."""

from repro_torch.train.engine import (EngineStats, ModelFns, StepEngine, eval_fn_for,
                                      lm_bucket_of)
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import epoch_end_host, make_train_step

__all__ = [
    "TrainState",
    "init_state",
    "make_train_step",
    "epoch_end_host",
    "StepEngine",
    "EngineStats",
    "ModelFns",
    "eval_fn_for",
    "lm_bucket_of",
]
