"""Training state: parameters + optimizer + DiveBatch diversity accumulators.

Counterpart of ``repro/train/state.py``.  ``params`` is the model (an
``nn.Module`` whose parameters take gradients); every other field lives on
the same device and is updated in place by the step, the counterpart of
the reference's buffer donation.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core import diversity
from repro_torch.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: Any
    div_state: diversity.DiversityState
    step: int = 0
    # Cross-pod compression error-feedback residuals (repro_torch.pod): a
    # list of stacked ``(pods, *param_shape)`` float32 tensors on cross-pod
    # rungs, None everywhere else.  Transient wire state, installed and
    # re-zeroed by PodLadder.adapt_state at rung transitions.
    err_state: Any = None

    def _replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_state(params: nn.Module, optimizer: Optimizer,
               div_dtype: torch.dtype = torch.float32) -> TrainState:
    """The state of a run starting from ``params``, which become trainable
    (``requires_grad``) and are trained in place."""
    params.requires_grad_(True)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        div_state=diversity.init_state(params, accum_dtype=div_dtype),
        step=0,
    )
