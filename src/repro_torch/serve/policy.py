"""Serve-side adaptation policies: ``observe(signals, clock) -> decision``.

The serving mirror of the reference package's ``repro.adapt.policy``.  Training already routes
every batch-size/lr/rung decision through the ``AdaptationPolicy`` protocol;
this module gives the :class:`~repro_torch.serve.engine.ServeEngine` the same
observe→decide boundary for the decisions it used to hard-code — admission
order, slot budget, and shrink patience become policy outputs the same way
the train batch size did (the AdaBatch → Sievert-2019 lineage of
signal-driven schedules, applied to the decode batch).

At every step boundary the engine builds a :class:`ServeSignals` snapshot
(queue depth, live/pending counts, windowed tokens/s, block-pool headroom,
per-request queue age) and calls ``policy.observe(signals, clock)`` with the
same :class:`~repro_torch.adapt.signals.Clock` type the train side uses
(``boundary='tick'``, ``step`` = decode-step count).  A ``None`` return — or
``None`` fields on the :class:`ServeDecision` — leaves the engine's default
behaviour untouched, exactly like a train-side ``Decision``.

Implementations:

  FifoPolicy       the default: admission order IS the queue order and the
                   slot budget stays with the scheduler's own
                   ``target_slots`` rule — golden token-identical to the
                   pre-hook engine on every lane (it returns the identity
                   ordering, so the engine takes the legacy FIFO path).
  PriorityPolicy   per-request priority classes (``Request.priority``,
                   higher first); FIFO-stable within a class.
  FairSharePolicy  per-tenant deficit round-robin (``Request.tenant``):
                   each tenant's next request is scheduled at a virtual
                   time of (requests already admitted for that tenant +
                   its position in the tenant's own FIFO), so one tenant's
                   burst queues behind other tenants' steady arrivals
                   instead of starving them.

Whatever the ordering says, ``Scheduler.admit`` keeps the gated-head
semantics: a pick vetoed by the block-pool reservation gate STOPS the
admission pass, so reservation gating stays starvation-free under any
policy — a large request is never starved by smaller ones slipping past it.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

from repro_torch.adapt.signals import Clock


@dataclasses.dataclass(frozen=True)
class QueuedRequest:
    """One queue entry as a policy sees it.

    age is seconds spent in the queue (scheduler clock — injectable in
    tests); tenant/priority mirror the optional ``Request`` metadata.
    """

    rid: int
    tenant: str | None
    priority: int
    age: float
    prompt_len: int


@dataclasses.dataclass(frozen=True)
class ServeSignals:
    """What a serve policy observes at a step boundary.

    queue_depth      pending (unadmitted) request count.
    live             occupied slots.
    capacity         current slot-table capacity (the pow2 bucket).
    tokens_per_sec   windowed delivery rate (``adapt.signals
                     .ThroughputWindow``); None before the first token.
    free_blocks      unreserved free blocks in the KV pool.
    reserved_blocks  outstanding admission-reservation credits.
    queued           the queue in FIFO order, with per-request age/metadata.
    step             the engine's decode-step count (same value as
                     ``clock.step``).
    """

    queue_depth: int = 0
    live: int = 0
    capacity: int = 0
    tokens_per_sec: float | None = None
    free_blocks: int = 0
    reserved_blocks: int = 0
    queued: tuple[QueuedRequest, ...] = ()
    step: int = 0


@dataclasses.dataclass(frozen=True)
class ServeDecision:
    """One typed serve-policy decision.  ``None`` fields = leave unchanged.

    slot_budget      cap on the slot-table capacity (snapped onto the pow2
                     slot lattice by the engine; clamped so live requests
                     are never evicted and progress never stalls — the
                     effective cap is at least max(live, 1)).  Persists
                     until a later decision changes it.
    order            admission order over the queued rids.  Rids missing
                     from the ordering follow in FIFO order; rids no longer
                     queued are ignored — a policy can rank a subset without
                     being able to drop anyone.
    shrink_patience  boundaries a smaller slot target must persist before
                     the engine shrinks (the reshard-thrash hysteresis).
                     Persists until changed.
    reason           provenance string ("fifo", "priority", "fair", ...).
    """

    slot_budget: int | None = None
    order: tuple[int, ...] | None = None
    shrink_patience: int | None = None
    reason: str = ""


@runtime_checkable
class ServePolicy(Protocol):
    """Structural protocol every serve policy satisfies."""

    def observe(
        self, signals: ServeSignals, clock: Clock
    ) -> ServeDecision | None: ...


class FifoPolicy:
    """Strict first-in-first-out admission — the default, and exactly the
    pre-hook engine's behaviour: the returned ordering is the queue order
    itself, and slot budget / shrink patience stay untouched."""

    def observe(self, signals: ServeSignals, clock: Clock) -> ServeDecision | None:
        if not signals.queued:
            return None
        return ServeDecision(
            order=tuple(q.rid for q in signals.queued), reason="fifo"
        )


class PriorityPolicy:
    """Admit by priority class (``Request.priority``, higher first), FIFO
    within a class (``sorted`` is stable over the FIFO-ordered queue view).
    The gated-head rule still applies to the REORDERED head: a gated
    high-priority request blocks lower classes rather than being starved by
    them."""

    def observe(self, signals: ServeSignals, clock: Clock) -> ServeDecision | None:
        if not signals.queued:
            return None
        order = tuple(
            q.rid
            for q in sorted(signals.queued, key=lambda q: -q.priority)
        )
        return ServeDecision(order=order, reason="priority")


class FairSharePolicy:
    """Per-tenant deficit round-robin over ``Request.tenant``.

    Each tenant owns a virtual-time counter equal to the number of its
    requests already admitted (tracked by watching rids leave the queue
    between observations).  A queued request's virtual finish time is
    ``(admitted[tenant] + its position in the tenant's own FIFO) //
    quantum`` — so tenants alternate admission slots (``quantum`` per turn)
    regardless of how deep any one tenant's backlog runs: a burst from one
    tenant queues behind the others' steady arrivals instead of starving
    them.  FIFO order is preserved within a tenant, and ties between
    tenants break by queue (arrival) order, so equal-share traffic reduces
    to plain FIFO.

    Requests with ``tenant=None`` form their own share class.
    """

    def __init__(self, quantum: int = 1):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = int(quantum)
        self._admitted: dict[str | None, int] = {}
        self._pending: dict[int, str | None] = {}  # rid -> tenant, last seen

    def observe(self, signals: ServeSignals, clock: Clock) -> ServeDecision | None:
        current = {q.rid for q in signals.queued}
        # rids that left the queue were admitted (the scheduler never drops)
        for rid in [r for r in self._pending if r not in current]:
            tenant = self._pending.pop(rid)
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
        if not signals.queued:
            return None
        for q in signals.queued:
            self._pending[q.rid] = q.tenant
        depth: dict[str | None, int] = {}
        ranked = []
        for fifo_idx, q in enumerate(signals.queued):
            k = depth.get(q.tenant, 0)
            depth[q.tenant] = k + 1
            vtime = (self._admitted.get(q.tenant, 0) + k) // self.quantum
            ranked.append((vtime, fifo_idx, q.rid))
        ranked.sort()
        return ServeDecision(
            order=tuple(rid for _, _, rid in ranked), reason="fair"
        )


#: CLI-facing registry (``launch/serve.py --policy``, benches)
POLICIES = ("fifo", "priority", "fair")


def make_serve_policy(name: str) -> ServePolicy:
    """Build a registry policy by name (``fifo`` | ``priority`` | ``fair``)."""
    if name == "fifo":
        return FifoPolicy()
    if name == "priority":
        return PriorityPolicy()
    if name == "fair":
        return FairSharePolicy()
    raise ValueError(f"unknown serve policy {name!r}; known: {POLICIES}")
