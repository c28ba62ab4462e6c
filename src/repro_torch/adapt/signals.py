"""The tensor-free part of the reference ``repro.adapt.signals``.

``Clock`` (when a policy observes) and ``ThroughputWindow`` (the windowed
events/second estimator behind ``ServeStats.tokens_per_sec``), copied with
identical semantics.  ``Signals`` and the device-side signal readers belong
to the training slice and are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

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
