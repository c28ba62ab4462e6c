"""Training signals for adaptation policies.

Counterpart of ``repro/adapt/signals.py``.  ``Signals`` is the record every
policy observes; ``Clock`` says when (epoch end, every-k-steps tick, or an
external event); ``ThroughputWindow`` is the windowed events/second
estimator (also behind ``ServeStats.tokens_per_sec``).

The device-side inputs come from the ``DiversityState`` accumulators the
train step fills on every step: :func:`read_signals` computes the diversity
estimate, the gradient-noise-scale proxy, the sample count and the
diversity batch bound on the device and brings them to the host in ONE
stacked read.

Gradient-noise scale (McCandlish et al. 2018): ``B_noise = tr(Sigma) /
||mu||^2``, recovered from the same accumulators by the moment inversion of
the ``moment`` diversity tier, with zero additional per-step work.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.core import diversity
from repro_torch.utils import pytree as ptu

EPS = 1e-20

#: boundary kinds a Clock can carry
BOUNDARIES = ("epoch", "tick", "event")


@dataclasses.dataclass(frozen=True)
class Clock:
    """When an observation happens.

    epoch     the epoch the boundary belongs to (the one just finishing for
              ``boundary='epoch'``; the running one for ticks/events).
    step      the global step count at the boundary (host-side counter; no
              device sync).
    boundary  'epoch' | 'tick' | 'event'.
    """

    epoch: int
    step: int
    boundary: str = "epoch"

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"unknown boundary {self.boundary!r}; expected one of {BOUNDARIES}"
            )


@dataclasses.dataclass(frozen=True)
class Signals:
    """What a policy observes at a boundary.  ``None`` = not measured.

    diversity   Delta_hat over the accumulation window (DiveBatch's signal).
    gns         gradient-noise-scale proxy tr(Sigma)/||mu||^2 over the same
                window (GradNoisePolicy's signal).
    loss        most recent per-step mean loss (already host-side).
    throughput  steps/sec over a trailing window (host-side).
    batch_size  the live global batch size.
    samples     samples accumulated since the last reset.
    event       name of the external event for ``boundary='event'``.
    diversity_bound  Yin et al.'s batch-size cap ``n * Delta_hat`` over the
                same window, read in the same transfer.
    """

    diversity: float | None = None
    gns: float | None = None
    loss: float | None = None
    throughput: float | None = None
    batch_size: int = 0
    samples: float = 0.0
    event: str | None = None
    diversity_bound: float | None = None


class ThroughputWindow:
    """Sliding-window rate estimator: events/second over a trailing window.

    ``add(n)`` records ``n`` events now; ``rate()`` is events per second over
    the last ``window_s`` seconds — or over the elapsed time so far when the
    window is not yet full, so early reads are unbiased rather than
    deflated.  The clock is injectable (``clock=`` or per-call ``now=``) so
    the window math is unit-testable without sleeping.
    """

    def __init__(self, window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._samples: collections.deque[tuple[float, float]] = collections.deque()
        self._start: float | None = None

    def _evict(self, now: float) -> None:
        # strict <: the trailing window is the CLOSED interval
        # [now - window_s, now], whose length is exactly the window_s the
        # denominator charges
        edge = now - self.window_s
        while self._samples and self._samples[0][0] < edge:
            self._samples.popleft()

    def add(self, n: float = 1.0, now: float | None = None) -> None:
        """Record ``n`` events at ``now`` (defaults to the injected clock)."""
        now = self._clock() if now is None else float(now)
        if self._start is None:
            self._start = now
        self._samples.append((now, float(n)))
        self._evict(now)

    def rate(self, now: float | None = None) -> float | None:
        """Events/second over the trailing window; None before any event.

        The denominator is ``min(window_s, now - first_event_time)``.  A
        burst whose events all landed at a single instant has no measurable
        span: the rate charges the full window instead (the conservative
        lower bound), so recorded events always yield a finite rate.
        """
        if self._start is None:
            return None
        now = self._clock() if now is None else float(now)
        self._evict(now)
        count = sum(n for _, n in self._samples)
        span = min(self.window_s, now - self._start)
        if span <= 0.0:
            return count / self.window_s
        return count / span


def gns_from_accumulators(div_state: Any, estimator: str = "moment") -> torch.Tensor:
    """tr(Sigma)/||mu||^2 from the ``DiversityState`` accumulators, a 0-d
    device tensor.

    The moment inversion of ``diversity.diversity_moment``: with ``Q`` the
    sum of small-batch squared norms (batch size ``m`` = 1 for the
    exact/gram tiers, the microbatch size for moment) and ``R =
    ||grad_sum||^2``,

        M  = (R - Q) / (n (n - m))      ~ ||mu||^2        (clamped >= 0)
        E2 = Q/n - (m - 1) M            ~ E||g||^2        (clamped >= eps)
        tr(Sigma) = E2 - M

    Degenerate windows (a single small batch, or empty accumulators) give 0.
    """
    n = div_state.sample_count.clamp_min(1.0)
    if estimator in ("exact", "gram"):
        m = torch.ones_like(n)
    else:
        m = n / div_state.mb_count.clamp_min(1.0)
    q = div_state.sq_norm_sum
    r = ptu.tree_sq_norm(div_state.grad_sum, getattr(div_state, "layout", None))
    big_m = ((r - q) / (n * (n - m)).clamp_min(EPS)).clamp_min(0.0)
    e2 = (q / n - (m - 1.0) * big_m).clamp_min(EPS)
    tr_sigma = (e2 - big_m).clamp_min(0.0)
    gns = tr_sigma / big_m.clamp_min(EPS)
    degenerate = (n - m < 0.5) | (r < EPS)
    return torch.where(degenerate, torch.zeros_like(gns), gns)


@torch.no_grad()
def read_signals(state: Any, estimator: str = "moment", *, reset: bool,
                 batch_size: int = 0, loss: float | None = None,
                 throughput: float | None = None,
                 event: str | None = None) -> tuple[Signals, Any]:
    """Read boundary signals off a ``TrainState``'s diversity accumulators.

    Returns ``(signals, state)``.  Exactly ONE device -> host transfer
    whatever the number of scalars (they come back stacked).  With
    ``reset=True`` the accumulators are zeroed in place after the read (the
    epoch-boundary semantics); with ``reset=False`` they are left as they
    are (mid-epoch ticks observe the running window)."""
    div = state.div_state
    est = diversity.estimate(div, estimator)
    scalars = torch.stack([est, gns_from_accumulators(div, estimator), div.sample_count,
                           div.sample_count * est])
    vals = scalars.tolist()  # the single host transfer
    if reset:
        diversity.reset_state(div)
    sig = Signals(
        diversity=vals[0],
        gns=vals[1],
        samples=vals[2],
        loss=loss,
        throughput=throughput,
        batch_size=int(batch_size),
        event=event,
        diversity_bound=vals[3],
    )
    return sig, state
