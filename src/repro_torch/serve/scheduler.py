"""Continuous-batching scheduler: admission queue + slot table.

The scheduler is a HOST-side, model-free object (the property tests drive it
with synthetic token streams and no tensors at all).  It owns the request
lifecycle; the :class:`~repro_torch.serve.engine.ServeEngine` owns the device
mirror (the batched KV/SSM cache) and drives the scheduler in boundary
phases between decode steps:

  1. retire — retirement happened during the previous step's ``record``
     calls (a slot frees the moment its request hits EOS or its budget);
  2. policy observe — the engine snapshots the queue/slot/pool state into
     ``serve.policy.ServeSignals`` and asks its ``ServePolicy`` for a
     decision: the admission ORDER over the queue, a cap on the slot
     budget, and the shrink patience.  The default ``FifoPolicy`` decides
     exactly what steps 3-4 would do on their own;
  3. ``target_slots()`` -> ``resize(n)``: the slot capacity tracks the
     runnable request count on the pow2 lattice (``core/batch_policy.bucket``
     — the serving analogue of the train-side compile buckets), clamped
     under the policy's slot budget, and a shrink compacts live slots into
     the low indices (``resize`` returns the gather map the engine applies
     to the cache rows);
  4. ``admit(order=...)``: free slots are refilled from the queue in the
     policy's order (FIFO by default) — a mid-batch EOS no longer wastes
     its lane until the whole chunk drains.  A pick vetoed by the caller's
     ``gate`` (the engine's block-pool reservation check) STOPS the pass,
     whatever the ordering, so reservation gating stays starvation-free;
  5. one decode step for the whole slot table; ``record(slot, token)``
     appends each live slot's token and retires the slot the moment its
     request hits EOS or its token budget.

Invariants (property-tested in tests/test_serve_sched.py and
tests/test_serve_policy.py): a slot is never double-assigned, no submitted
request is ever dropped — under ANY admission ordering — every request
retires at exactly its EOS/max-token step, and every capacity the scheduler
asks for lies on the pow2 slot lattice.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable

import numpy as np

from repro_torch.core.batch_policy import bucket

#: ``slot_rids()`` sentinel for a free lane — a value no real request id can
#: take (rids count up from 0), so a free lane can never alias a live
#: request's per-rid sampling-key material in the decode program
FREE_RID = -1


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    # optional policy metadata (serve/policy.py): share class, priority
    # class (higher admits sooner under PriorityPolicy), and an explicit
    # submission timestamp (defaults to the scheduler clock at submit)
    tenant: str | None = None
    priority: int = 0
    submit_time: float | None = None


@dataclasses.dataclass
class Result:
    tokens: np.ndarray
    steps: int


@dataclasses.dataclass(frozen=True)
class Admission:
    """One queue->slot assignment handed back by ``admit()``."""

    slot: int
    rid: int
    request: Request


def slots_for(need: int, granule: int, max_slots: int) -> int:
    """Smallest pow2-lattice slot count covering ``need``, capped at the
    largest lattice point <= ``max_slots`` (requests beyond the cap wait in
    the queue).  Always >= any live count that fit under the cap before."""
    if need <= 0:
        return 0
    cap = bucket(max_slots, granule, "pow2", m_max=max_slots)
    n = min(need, cap)
    s = bucket(n, granule, "pow2", m_max=cap)
    while s < n and s * 2 <= cap:
        s *= 2
    return s


class Scheduler:
    """Admission queue + slot table for continuous-batching decode."""

    def __init__(self, max_slots: int, *, granule: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if granule < 1 or max_slots < granule:
            raise ValueError(
                f"need max_slots >= granule >= 1, got {max_slots}, {granule}"
            )
        self.max_slots = int(max_slots)
        self.granule = int(granule)
        #: injectable wall clock — queue ages are unit-testable without
        #: sleeping (mirrors adapt.signals.ThroughputWindow)
        self.clock = clock
        self._queue: collections.deque[int] = collections.deque()
        self._reqs: dict[int, Request] = {}
        self._budget: dict[int, int] = {}
        self._tokens: dict[int, list[int]] = {}
        self._submit_t: dict[int, float] = {}
        self._slots: list[int | None] = []
        self._done: dict[int, Result] = {}
        self._next_rid = 0
        self.submitted = 0
        self.retired = 0

    # -- lifecycle -----------------------------------------------------------
    def submit(self, request: Request, *, budget: int | None = None) -> int:
        """Queue a request; ``budget`` caps its total emitted tokens (the
        engine passes ``min(max_new_tokens, cache headroom)``)."""
        budget = request.max_new_tokens if budget is None else int(budget)
        if budget < 1:
            raise ValueError(f"token budget must be >= 1, got {budget}")
        rid = self._next_rid
        self._next_rid += 1
        self._reqs[rid] = request
        self._budget[rid] = budget
        self._tokens[rid] = []
        self._submit_t[rid] = (
            self.clock() if request.submit_time is None
            else float(request.submit_time)
        )
        self._queue.append(rid)
        self.submitted += 1
        return rid

    def target_slots(self) -> int:
        """The pow2-lattice capacity for the current runnable load."""
        return slots_for(self.live + self.pending, self.granule, self.max_slots)

    def resize(self, n: int) -> list[int]:
        """Set the capacity to ``n``, compacting live slots into the low
        indices (slot order preserved).  Returns, per NEW slot, the OLD slot
        index whose device row it should take (free slots map to row 0 — the
        engine's cache gather needs a valid index; the row content of a free
        slot is never read)."""
        live = [(i, rid) for i, rid in enumerate(self._slots) if rid is not None]
        if n < len(live):
            raise ValueError(f"cannot shrink to {n} slots with {len(live)} live")
        idx = [i for i, _ in live] + [0] * (n - len(live))
        self._slots = [rid for _, rid in live] + [None] * (n - len(live))
        return idx

    def admit(self, gate=None,
              order: Iterable[int] | None = None) -> list[Admission]:
        """Fill free slots from the queue (one pass; callers loop when an
        admission retires instantly and frees its slot again).

        ``order`` is a policy-supplied admission ordering over the queued
        rids (``None`` = FIFO).  Rids in the ordering that are no longer
        queued are skipped (admitted in an earlier pass this boundary);
        queued rids the ordering omits follow at the end in FIFO order — an
        ordering can promote or rank a subset but can never DROP a request.

        ``gate(rid, request) -> bool`` vetoes admissions the caller cannot
        resource yet (the engine's block-pool reservation check).  A gated
        pick STOPS the pass — admission stays strict in the chosen order,
        so a large request is never starved by smaller ones slipping past
        it, whatever the policy's ordering.
        """
        if order is None:
            picks = list(self._queue)
        else:
            queued = set(self._queue)
            picks, seen = [], set()
            for rid in order:
                if rid in queued and rid not in seen:
                    picks.append(rid)
                    seen.add(rid)
            picks.extend(rid for rid in self._queue if rid not in seen)
        out: list[Admission] = []
        k = 0
        for i, rid in enumerate(self._slots):
            if rid is None and k < len(picks):
                nrid = picks[k]
                if gate is not None and not gate(nrid, self._reqs[nrid]):
                    break
                k += 1
                self._queue.remove(nrid)
                self._slots[i] = nrid
                out.append(Admission(slot=i, rid=nrid, request=self._reqs[nrid]))
        return out

    def record(self, slot: int, token: int) -> bool:
        """Append ``token`` to the request in ``slot``; retire the slot (and
        return True) the moment the request hits EOS or its budget."""
        rid = self._slots[slot]
        if rid is None:
            raise ValueError(f"slot {slot} is free; cannot record a token")
        token = int(token)
        toks = self._tokens[rid]
        toks.append(token)
        req = self._reqs[rid]
        done = (req.eos_id is not None and token == req.eos_id) or (
            len(toks) >= self._budget[rid]
        )
        if done:
            self._done[rid] = Result(
                tokens=np.asarray(toks, np.int32), steps=len(toks)
            )
            self._slots[slot] = None
            self.retired += 1
        return done

    # -- views ---------------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def live(self) -> int:
        return sum(1 for rid in self._slots if rid is not None)

    @property
    def capacity(self) -> int:
        return len(self._slots)

    @property
    def has_work(self) -> bool:
        return self.live > 0 or self.pending > 0

    def live_slots(self) -> list[tuple[int, int]]:
        """[(slot, rid)] for every occupied slot, in slot order."""
        return [(i, rid) for i, rid in enumerate(self._slots) if rid is not None]

    def running_slots(self) -> list[tuple[int, int]]:
        """[(slot, rid)] for slots that are DECODING — occupied and holding at
        least one emitted token.  An occupied slot with no tokens yet is still
        loading (chunked prefill in flight); it keeps its lane but must not
        decode or feed a stale token."""
        return [
            (i, rid)
            for i, rid in enumerate(self._slots)
            if rid is not None and self._tokens[rid]
        ]

    def queued(self) -> list[tuple[int, Request, float]]:
        """``[(rid, request, submit_time)]`` for every queued (unadmitted)
        request, in FIFO order — the policy-facing queue view (ages come
        from ``clock() - submit_time``)."""
        return [(rid, self._reqs[rid], self._submit_t[rid])
                for rid in self._queue]

    def slot_of(self, rid: int) -> int:
        """The slot currently holding ``rid`` (raises if it is not resident)."""
        for i, r in enumerate(self._slots):
            if r == rid:
                return i
        raise KeyError(f"request {rid} holds no slot")

    def next_tokens(self) -> np.ndarray:
        """(capacity,) int32 feed for the next decode step: each running
        slot's last emitted token; 0 for free or still-loading lanes."""
        out = np.zeros(len(self._slots), np.int32)
        for i, rid in enumerate(self._slots):
            if rid is not None and self._tokens[rid]:
                out[i] = self._tokens[rid][-1]
        return out

    def slot_rids(self) -> np.ndarray:
        """(capacity,) int32 request ids per slot — the per-slot
        sampling-key material fed into the decode program.  Free lanes carry
        :data:`FREE_RID` (-1), which no real request id can take: the old 0
        sentinel collided with the FIRST request's rid, feeding a free lane
        the same fold_in key material as request 0."""
        out = np.full(len(self._slots), FREE_RID, np.int32)
        for i, rid in enumerate(self._slots):
            if rid is not None:
                out[i] = rid
        return out

    def result(self, rid: int) -> Result:
        if rid not in self._done:
            raise KeyError(f"request {rid} has not finished")
        return self._done[rid]

    def results(self) -> dict[int, Result]:
        return dict(self._done)
