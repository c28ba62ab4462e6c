"""Policy combinators + the typed learning-rate coupling.

Counterpart of ``repro/adapt/combinators.py``, a copy (pure Python over
``Signals`` and ``Decision``).
Combinators wrap an inner :class:`AdaptationPolicy` and transform its
decisions; they satisfy the same protocol, so they nest freely:

    Hysteresis(Clamped(DiveBatchPolicy(...), m_min=32), band=0.1)

``LrCoupling`` is the typed replacement for the old string-valued
``lr_rule``/``lr_schedule`` pair on ``AdaptiveBatchController``: one record
carrying the batch->lr scaling rule (Goyal et al. linear / sqrt / none) and
the background decay schedule, consumed by ``AdaptationProgram``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.adapt.policy import Decision, PolicyBase
from repro_torch.adapt.signals import Clock, Signals
from repro_torch.core.controller import lr_rescale, step_decay  # canonical defs

__all__ = [
    "LrCoupling",
    "Clamped",
    "BoundedRung",
    "Warmup",
    "Hysteresis",
    "Chain",
    "Switch",
    "lr_rescale",
    "step_decay",
]


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


class _Wrapper(PolicyBase):
    """Delegating base for single-inner combinators."""

    def __init__(self, inner):
        self.inner = inner

    def fires(self, clock: Clock) -> bool:
        return self.inner.fires(clock)

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        return self.inner.observe(signals, clock)

    @property
    def batch_size(self) -> int:
        return self.inner.batch_size

    def set_batch_size(self, m: int) -> None:
        self.inner.set_batch_size(m)

    @property
    def needs_diversity(self) -> bool:
        return self.inner.needs_diversity

    @property
    def max_buckets(self) -> int:
        return self.inner.max_buckets

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])


class Clamped(_Wrapper):
    """Clamp decided batch sizes into ``[m_min, m_max]``.

    With lattice-point bounds (the normal case) the output stays on the
    lattice: clamp only ever substitutes a bound for the decided value.  The
    clamped value is written back into the inner policy so its internal
    state agrees with what actually runs.
    """

    def __init__(self, inner, m_min: int | None = None, m_max: int | None = None):
        super().__init__(inner)
        self.m_min = m_min
        self.m_max = m_max

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        d = self.inner.observe(signals, clock)
        if d is None or d.batch_size is None:
            return d
        m = d.batch_size
        if self.m_min is not None:
            m = max(m, self.m_min)
        if self.m_max is not None:
            m = min(m, self.m_max)
        if m != d.batch_size:
            self.inner.set_batch_size(m)
            d = dataclasses.replace(d, batch_size=m, reason=d.reason + "+clamp")
        return d


class BoundedRung(_Wrapper):
    """Clamp decisions under the gradient-diversity batch bound.

    Yin et al. ("Gradient Diversity: a Key Ingredient for Scalable
    Distributed Learning") prove mini-batch SGD matches serial SGD's
    convergence only while the batch stays below ``n * Delta_S`` — gradient
    diversity IS the theory of how wide a data-parallel rung may grow.
    ``Signals.diversity_bound`` carries the windowed estimate of that cap
    (``samples * Delta_hat``, decoded off the same stacked-scalar read as
    ``gns``); this combinator enforces it on every inner ``Decision``:

      * ``batch_size`` is clamped onto the largest lattice point
        ``granule * 2^k <= margin * bound`` (floored at ``granule`` —
        training must proceed even under a collapsed estimate);
      * an explicit ``rung`` whose dp width exceeds the cap is substituted
        with the widest ladder rung that fits (when ``ladder`` is given).

    A missing / non-finite / non-positive bound passes decisions through
    untouched (e.g. the very first boundary, before any accumulation).
    """

    def __init__(self, inner, *, granule: int = 1, margin: float = 1.0,
                 ladder=None):
        super().__init__(inner)
        if granule < 1:
            raise ValueError(f"granule must be >= 1, got {granule}")
        if margin <= 0:
            raise ValueError(f"margin must be > 0, got {margin}")
        self.granule = int(granule)
        self.margin = float(margin)
        self.ladder = ladder

    def _cap(self, signals: Signals) -> float | None:
        b = signals.diversity_bound
        if b is None or not math.isfinite(b) or b <= 0:
            return None
        return self.margin * b

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        d = self.inner.observe(signals, clock)
        if d is None:
            return d
        cap = self._cap(signals)
        if cap is None:
            return d
        bounded = False
        if d.batch_size is not None and d.batch_size > cap:
            m = self.granule
            while m * 2 <= cap:
                m *= 2
            self.inner.set_batch_size(m)
            d = dataclasses.replace(d, batch_size=m,
                                    reason=d.reason + "+bound")
            bounded = True
        if (d.rung is not None and self.ladder is not None
                and self.ladder.rungs[d.rung].dp > cap):
            best = self.ladder.rungs[0]
            for r in self.ladder.rungs:
                if r.dp <= cap:
                    best = r
            d = dataclasses.replace(
                d, rung=best.index,
                reason=d.reason if bounded else d.reason + "+bound")
        return d


class Warmup(_Wrapper):
    """Suppress adaptation until ``epochs`` epochs / ``steps`` steps have
    passed (the inner policy is not even consulted, so its schedule starts
    fresh at release)."""

    def __init__(self, inner, *, epochs: int = 0, steps: int = 0):
        super().__init__(inner)
        self.epochs = int(epochs)
        self.steps = int(steps)

    def _active(self, clock: Clock) -> bool:
        return clock.epoch >= self.epochs and clock.step >= self.steps

    def fires(self, clock: Clock) -> bool:
        return self._active(clock) and self.inner.fires(clock)

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        if not self._active(clock):
            return None
        return self.inner.observe(signals, clock)


class Hysteresis(_Wrapper):
    """Schmitt trigger on the bucket lattice: a resize is accepted only when
    the RAW target clears the rounding threshold adjacent to the held bucket
    by a relative ``band``; otherwise the held size is kept.

    On the pow2 lattice the round-to-nearest boundary above a held size
    ``A`` sits at ``A*sqrt(2)`` (and below at ``A/sqrt(2)``), so the
    acceptance rule is

        move up   iff  raw > A*sqrt(2)*(1+band)
        move down iff  raw < A/sqrt(2)/(1+band)

    This makes the schedule rung-invariant under dp-reduction-order jitter
    (the ROADMAP's observed schedule fork): two consecutive raw estimates
    whose ratio lies within ``[1/(1+band), 1+band]`` can NEVER produce an
    A -> B -> A flap — after accepting a move on ``r1``, the opposite
    threshold is strictly out of reach of any ``r2`` within the band of
    ``r1`` (strict inequalities; see tests/test_adapt.py property test).
    """

    def __init__(self, inner, band: float = 0.1):
        super().__init__(inner)
        if band < 0:
            raise ValueError(f"band must be >= 0, got {band}")
        self.band = float(band)
        self._held: int | None = None

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        d = self.inner.observe(signals, clock)
        if d is None or d.batch_size is None:
            return d
        if self._held is None or d.batch_size == self._held:
            self._held = d.batch_size
            return d
        held = self._held
        raw = d.raw_batch_size if d.raw_batch_size is not None else float(d.batch_size)
        up = held * math.sqrt(2.0) * (1.0 + self.band)
        down = held / math.sqrt(2.0) / (1.0 + self.band)
        accept = raw > up if d.batch_size > held else raw < down
        if accept:
            self._held = d.batch_size
            return d
        self.inner.set_batch_size(held)
        return dataclasses.replace(d, batch_size=held, reason=d.reason + "+hold")

    @property
    def batch_size(self) -> int:
        return self._held if self._held is not None else self.inner.batch_size

    def set_batch_size(self, m: int) -> None:
        # external write-back (Switch handover, Chain merge) re-anchors the
        # band: holding the old value would desync batch_size from the run
        self.inner.set_batch_size(m)
        self._held = int(m)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "held": self._held}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        h = state.get("held")
        self._held = int(h) if h is not None else None


class Chain(PolicyBase):
    """Observe several policies at one boundary and merge their decisions
    field-wise (FIRST non-None value per field wins — list policies in
    priority order).  The first policy is the primary batch authority:
    ``batch_size`` reads from it, and an accepted merge writes the final
    batch back into every member so their states stay coherent."""

    def __init__(self, *policies):
        if not policies:
            raise ValueError("Chain needs at least one policy")
        self.policies = list(policies)

    def fires(self, clock: Clock) -> bool:
        return any(p.fires(clock) for p in self.policies)

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        decisions = [d for p in self.policies if (d := p.observe(signals, clock))]
        if not decisions:
            return None
        merged: dict = {}
        for d in decisions:
            for f in dataclasses.fields(Decision):
                v = getattr(d, f.name)
                if f.name == "reason":
                    continue
                if merged.get(f.name) is None and v is not None:
                    merged[f.name] = v
        merged["reason"] = "+".join(d.reason for d in decisions if d.reason)
        out = Decision(**merged)
        if out.batch_size is not None:
            for p in self.policies:
                p.set_batch_size(out.batch_size)
        return out

    @property
    def batch_size(self) -> int:
        return self.policies[0].batch_size

    def set_batch_size(self, m: int) -> None:
        for p in self.policies:
            p.set_batch_size(m)

    @property
    def needs_diversity(self) -> bool:
        return any(p.needs_diversity for p in self.policies)

    @property
    def max_buckets(self) -> int:
        return max(getattr(p, "max_buckets", 1) for p in self.policies)

    def state_dict(self) -> dict:
        return {"policies": [p.state_dict() for p in self.policies]}

    def load_state_dict(self, state: dict) -> None:
        for p, s in zip(self.policies, state["policies"]):
            p.load_state_dict(s)


class Switch(PolicyBase):
    """Route each observation to one of several policies.

    ``selector(clock) -> index``.  The convenience constructor
    ``Switch.at_epochs([e1, e2, ...], [p0, p1, p2, ...])`` runs ``p0``
    before epoch ``e1``, ``p1`` before ``e2``, and so on.  The newly-active
    policy inherits the previous one's live batch size, so a handover never
    teleports the schedule.
    """

    def __init__(self, selector: Callable[[Clock], int], policies: Sequence):
        if not policies:
            raise ValueError("Switch needs at least one policy")
        self.selector = selector
        self.policies = list(policies)
        self._active = 0

    @classmethod
    def at_epochs(cls, boundaries: Sequence[int], policies: Sequence) -> "Switch":
        bounds = list(boundaries)
        if len(policies) != len(bounds) + 1:
            raise ValueError(
                f"need len(policies) == len(boundaries)+1, got "
                f"{len(policies)} policies for {len(bounds)} boundaries"
            )

        def selector(clock: Clock) -> int:
            return sum(clock.epoch >= b for b in bounds)

        return cls(selector, policies)

    def _select(self, clock: Clock):
        idx = max(0, min(int(self.selector(clock)), len(self.policies) - 1))
        if idx != self._active:
            self.policies[idx].set_batch_size(self.policies[self._active].batch_size)
            self._active = idx
        return self.policies[idx]

    def fires(self, clock: Clock) -> bool:
        return self._select(clock).fires(clock)

    def observe(self, signals: Signals, clock: Clock) -> Decision | None:
        return self._select(clock).observe(signals, clock)

    @property
    def batch_size(self) -> int:
        return self.policies[self._active].batch_size

    def set_batch_size(self, m: int) -> None:
        self.policies[self._active].set_batch_size(m)

    @property
    def needs_diversity(self) -> bool:
        return any(p.needs_diversity for p in self.policies)

    @property
    def max_buckets(self) -> int:
        return max(getattr(p, "max_buckets", 1) for p in self.policies)

    def state_dict(self) -> dict:
        return {"policies": [p.state_dict() for p in self.policies],
                "active": self._active}

    def load_state_dict(self, state: dict) -> None:
        for p, s in zip(self.policies, state["policies"]):
            p.load_state_dict(s)
        self._active = int(state.get("active", 0))
