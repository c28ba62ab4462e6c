"""The adaptation protocol: ``observe(signals, clock) -> Decision | None``.

A copy of ``repro/adapt/policy.py`` (pure Python), so the same signals give
the same decisions in both packages.

A policy is a host-side object that watches training :class:`Signals` at
boundaries (:class:`Clock`) and emits typed :class:`Decision` records.  This
replaces the epoch-only ``BatchPolicy.on_epoch_end(epoch, diversity)``
funnel: the same protocol expresses epoch-end DiveBatch, every-k-steps
gradient-noise adaptation (Sievert 2021; Lau et al. 2024, AdAdaGrad), and
event-driven resizes from a supervisor Watchdog.

Implementations here:
  FixedPolicy       constant m (the SGD baselines).
  AdaBatchPolicy    multiply m every ``resize_freq`` epochs.
  DiveBatchPolicy   m <- min(m_max, delta * n * Delta_hat)  [Algorithm 1],
                    optionally at tick/event boundaries with the running
                    estimate; ``oracle=True`` selects the OracleDiveBatch
                    rule (the caller feeds exact full-dataset diversity).
  GradNoisePolicy   m tracks the measured gradient-noise scale
                    (``alpha * B_noise``), EMA-smoothed — the
                    Sievert/AdAdaGrad family the epoch-only API could not
                    express.
  FromBatchPolicy   adapter lifting any legacy ``core.BatchPolicy`` into the
                    protocol (the ``AdaptiveBatchController`` shim uses it).

The lr coupling lives in ``combinators.py`` (the reference's other
combinators are not ported yet); ``program.AdaptationProgram`` runs a
policy against the training clock.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

from repro_torch.adapt.signals import Clock, Signals
from repro_torch.core import batch_policy as bp


@dataclasses.dataclass(frozen=True)
class Decision:
    """One typed adaptation decision.  ``None`` fields = leave unchanged.

    batch_size      new global batch size (already on the bucket lattice).
    lr              explicit learning rate; when None the program derives it
                    from the batch change via its ``LrCoupling``.
    estimator       diversity-estimator tier to switch to (exact|gram|moment).
    rung            explicit elastic-ladder rung index (overrides the
                    batch-derived rung; e.g. a straggler event narrowing the
                    footprint).
    reason          provenance string ("divebatch", "gradnoise", ...).
    raw_batch_size  the pre-bucketing target (hysteresis bands compare it
                    against lattice thresholds).
    diversity       the estimate the decision was based on (bookkeeping).
    """

    batch_size: int | None = None
    lr: float | None = None
    estimator: str | None = None
    rung: int | None = None
    reason: str = ""
    raw_batch_size: float | None = None
    diversity: float | None = None


@runtime_checkable
class AdaptationPolicy(Protocol):
    """Structural protocol every policy and combinator satisfies."""

    def observe(self, signals: Signals, clock: Clock) -> Decision | None: ...

    def fires(self, clock: Clock) -> bool: ...

    @property
    def batch_size(self) -> int: ...

    def set_batch_size(self, m: int) -> None: ...

    def state_dict(self) -> dict: ...

    def load_state_dict(self, state: dict) -> None: ...


class PolicyBase:
    """Shared boundary gating: fire on epochs always, on ticks/events by
    flag.  Subclasses implement ``_decide`` and own their batch state."""

    def __init__(self, *, on_epoch: bool = True, on_tick: bool = False,
                 on_event: bool = False):
        self.on_epoch = on_epoch
        self.on_tick = on_tick
        self.on_event = on_event

    def fires(self, clock: Clock) -> bool:
        return {
            "epoch": self.on_epoch,
            "tick": self.on_tick,
            "event": self.on_event,
        }[clock.boundary]

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        if not self.fires(clock):
            return None
        return self._decide(signals, clock)

    def _decide(self, signals: Signals, clock: Clock) -> Decision | None:
        raise NotImplementedError

    @property
    def needs_diversity(self) -> bool:
        return False

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class FromBatchPolicy(PolicyBase):
    """Lift a legacy ``core.batch_policy.BatchPolicy`` into the protocol.

    The inner policy's epoch rule runs at whatever boundaries the flags
    enable (its ``on_epoch_end(epoch, diversity)`` math is boundary-agnostic
    for Fixed/DiveBatch; epoch-counting policies like AdaBatch should keep
    the epoch-only default).  ``state_dict`` passes straight through, so a
    pre-redesign ``{"m": ...}`` checkpoint loads unchanged.
    """

    def __init__(self, inner: bp.BatchPolicy, *, on_epoch: bool = True,
                 on_tick: bool = False, on_event: bool = False):
        super().__init__(on_epoch=on_epoch, on_tick=on_tick, on_event=on_event)
        self.inner = inner

    def _decide(self, signals: Signals, clock: Clock) -> Decision | None:
        info = self.inner.on_epoch_end(clock.epoch, signals.diversity)
        return Decision(
            batch_size=info.batch_size,
            raw_batch_size=info.raw_batch_size,
            diversity=info.diversity,
            reason=info.reason,
        )

    @property
    def batch_size(self) -> int:
        return self.inner.m

    def set_batch_size(self, m: int) -> None:
        self.inner.m = int(m)

    @property
    def needs_diversity(self) -> bool:
        return self.inner.needs_diversity

    @property
    def max_buckets(self) -> int:
        return self.inner.max_buckets

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


class FixedPolicy(FromBatchPolicy):
    def __init__(self, m0: int, m_max: int | None = None, granule: int = 1,
                 bucket_mode: str = "pow2"):
        super().__init__(bp.FixedBatch(m0, max(m_max or m0, m0), granule, bucket_mode))


class AdaBatchPolicy(FromBatchPolicy):
    """Epoch-counting: fires only at epoch boundaries by construction."""

    def __init__(self, m0: int, m_max: int, resize_factor: int = 2,
                 resize_freq: int = 20, granule: int = 1,
                 bucket_mode: str = "pow2"):
        super().__init__(
            bp.AdaBatch(m0, m_max, resize_factor, resize_freq, granule, bucket_mode)
        )


class DiveBatchPolicy(FromBatchPolicy):
    """Algorithm 1, protocol form.  ``on_tick``/``on_event`` let the (memory-
    less) rule also fire mid-epoch on the running diversity estimate.

    ``dataset_size=None`` scales by the samples actually accumulated in the
    observation window (``signals.samples``) instead of a fixed n — the
    streaming/LM regime where an "epoch" is a step interval.
    """

    def __init__(self, m0: int, m_max: int, delta: float,
                 dataset_size: int | None = None, granule: int = 1,
                 bucket_mode: str = "pow2", monotone: bool = False,
                 m_min: int | None = None, *, oracle: bool = False,
                 on_tick: bool = False, on_event: bool = True):
        cls = bp.OracleDiveBatch if oracle else bp.DiveBatch
        inner = cls(m0, m_max, delta, dataset_size or 1, granule, bucket_mode,
                    monotone, m_min)
        super().__init__(inner, on_tick=on_tick, on_event=on_event)
        self._window_sized = dataset_size is None

    def _decide(self, signals: Signals, clock: Clock) -> Decision | None:
        if self._window_sized:
            self.inner.n = max(int(signals.samples), 1)
        return super()._decide(signals, clock)


class GradNoisePolicy(PolicyBase):
    """Track the critical batch size: m <- alpha * B_noise (EMA-smoothed).

    The gradient-noise scale ``B_noise = tr(Sigma)/||mu||^2`` estimates the
    batch size at which data parallelism stops paying (McCandlish et al.
    2018); Sievert (2021) and AdAdaGrad (Lau et al. 2024) adapt the batch on
    exactly this family of variance signals, at sub-epoch granularity —
    hence ``on_tick=True`` by default.  The raw signal is noisy, so an EMA
    with weight ``ema`` on the PREVIOUS smoothed value stabilises it; the
    output lands on the same bucket lattice as every other policy.
    """

    def __init__(self, m0: int, m_max: int, granule: int = 1,
                 bucket_mode: str = "pow2", *, alpha: float = 1.0,
                 ema: float = 0.5, m_min: int | None = None,
                 on_tick: bool = True, on_event: bool = True):
        super().__init__(on_tick=on_tick, on_event=on_event)
        if m0 < 1 or m_max < m0:
            raise ValueError(f"need 1 <= m0 <= m_max, got m0={m0}, m_max={m_max}")
        self.m_max = int(m_max)
        self.granule = int(granule)
        self.bucket_mode = bucket_mode
        self.alpha = float(alpha)
        self.ema = float(ema)
        self.m_min = int(m_min) if m_min is not None else 1
        self.m = bp.bucket(m0, granule, bucket_mode, m_max=m_max)
        self._gns: float | None = None

    def _decide(self, signals: Signals, clock: Clock) -> Decision | None:
        if signals.gns is None:
            return None
        g = float(signals.gns)
        self._gns = g if self._gns is None else self.ema * self._gns + (1 - self.ema) * g
        raw = self.alpha * self._gns
        self.m = bp.bucket(
            int(max(raw, self.m_min)), self.granule, self.bucket_mode,
            m_min=self.m_min, m_max=self.m_max,
        )
        return Decision(batch_size=self.m, raw_batch_size=raw,
                        diversity=signals.diversity, reason="gradnoise")

    @property
    def batch_size(self) -> int:
        return self.m

    def set_batch_size(self, m: int) -> None:
        self.m = int(m)

    @property
    def needs_diversity(self) -> bool:
        # the GNS proxy reads the same DiversityState accumulators
        return True

    @property
    def max_buckets(self) -> int:
        if self.bucket_mode == "none":
            return max(self.m_max // max(self.granule, 1), 1)
        return bp.num_buckets(self.m_max, self.granule)

    def state_dict(self) -> dict:
        return {"m": self.m, "gns": self._gns}

    def load_state_dict(self, state: dict) -> None:
        self.m = int(state["m"])
        g = state.get("gns")
        self._gns = float(g) if g is not None else None
