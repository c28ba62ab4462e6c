"""Paged KV-cache block pool: host-side accounting for the device pool.

The serving cache used to be slot-dense — every slot preallocated ``max_seq``
rows, so memory (not compute) bounded concurrency.  The pool replaces that
with vLLM-style paging: the device holds one flat pool of fixed-size KV
blocks per full-attention pattern position (``models/transformer.init_pages``)
and every request maps its logical token positions onto pool blocks through a
per-request block table.  This module is the HOST side of that scheme — a
model-free object (the property tests drive it with synthetic token streams
and no tensors at all) mirroring the device pool block-for-block:

  * **free list / refcounts** — ``alloc``/``retain``/``release``.  A block is
    live while any request references it; refcounts never go negative
    (``release`` on a free block raises).
  * **reservations** — admission-time credits for a request's worst-case
    remaining footprint (``ceil((padded prompt + decode budget) / block)``).
    ``alloc(reserved=True)`` spends a credit; a request that retires early
    returns its unspent credits.  Reserving at admission (instead of
    allocating) is what decouples memory from ``max_seq``: the pool only ever
    holds blocks for tokens that are actually resident, yet a live request
    can never strand mid-decode on an exhausted pool.
  * **prefix registry** — full prompt blocks register under a chain hash
    (``chain_keys``: key_i = (key_{i-1}, block_i tokens), vLLM-v2 style), so
    a later request whose padded prompt shares a block-aligned prefix adopts
    the blocks instead of re-prefilling (the N-thousand-user
    shared-system-prompt case costs one prefill).  Registered blocks whose
    refcount drops to zero become *cached* — evictable LRU, still matchable —
    rather than free, so sharing survives across requests that never overlap
    in time.
  * **copy-on-write** — a block is ``writable`` only while singly-referenced
    and unregistered; ``cow`` hands the writer a private replacement block
    (the engine copies the device rows).  Engine invariant: prompts pad to a
    block multiple, so decode always writes fresh blocks and CoW never fires
    on the serve path — the machinery guards the invariant rather than
    relying on it.

Block id 0 is the SENTINEL: never allocated, the write target of inactive
decode lanes and the padding entry of every table — garbage may be written
there but is never read (validity masks cover it).
"""

from __future__ import annotations

import collections
from typing import Iterable, Sequence

from repro_torch.obs import trace as trace_lib

Key = tuple


class PoolExhausted(RuntimeError):
    """No free or evictable block is left to satisfy an allocation."""


def chain_keys(tokens: Sequence[int], block_size: int) -> list[Key]:
    """Chain hash keys for a block-multiple token stream: ``key_i`` commits
    to every token in blocks ``0..i``, so a chain match is a prefix match."""
    toks = [int(t) for t in tokens]
    if block_size < 1 or len(toks) % block_size:
        raise ValueError(
            f"need a block-multiple stream, got {len(toks)} tokens at "
            f"block_size {block_size}"
        )
    keys: list[Key] = []
    prev: Key = ()
    for i in range(0, len(toks), block_size):
        prev = (prev, tuple(toks[i:i + block_size]))
        keys.append(prev)
    return keys


class BlockPool:
    """Host accounting for a ``num_blocks``-block device pool (id 0 reserved
    as the sentinel)."""

    #: telemetry sink (the owning ServeEngine rebinds its own tracer here so
    #: alloc/evict instants share the decode timeline); stays tensor-free
    tracer = trace_lib.NULL

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the sentinel), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # allocate ascending: ids num_blocks-1 .. 1, popped from the end
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        self._by_key: dict[Key, int] = {}
        self._key_of: dict[int, Key] = {}
        self._lru: collections.OrderedDict[int, None] = collections.OrderedDict()
        self._reserved = 0
        self.peak_live = 0
        self.cow_copies = 0

    # -- views ---------------------------------------------------------------
    @property
    def live(self) -> int:
        """Blocks referenced by at least one request."""
        return len(self._ref)

    @property
    def cached(self) -> int:
        """Unreferenced but registered blocks (evictable, still matchable)."""
        return len(self._lru)

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def reserved(self) -> int:
        return self._reserved

    def available(self) -> int:
        """Blocks an admission may still claim: free + evictable - promised."""
        return len(self._free) + len(self._lru) - self._reserved

    # -- reservations --------------------------------------------------------
    def can_reserve(self, n: int) -> bool:
        return n <= self.available()

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise PoolExhausted(
                f"cannot reserve {n} blocks with {self.available()} available"
            )
        self._reserved += n

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise ValueError(f"unreserve({n}) exceeds {self._reserved} outstanding")
        self._reserved -= n

    def feasible(self, matched: Sequence[int], total: int) -> bool:
        """Can a request needing ``total`` blocks, ``matched`` of them adopted
        from the prefix registry, be admitted right now?  Matched CACHED
        blocks count as available until adopted, so they drop out of both
        sides of the inequality."""
        cached = sum(1 for b in matched if b in self._lru)
        return total - len(matched) <= self.available() - cached

    def admit_need(self, keys: Sequence[Key], total: int) -> tuple[list[int], bool]:
        """Admission probe: (matched shared blocks, whether the remainder fits)."""
        matched = self.match(keys)
        return matched, self.feasible(matched, total)

    # -- alloc / refcount ----------------------------------------------------
    def alloc(self, *, reserved: bool = False) -> int:
        """Claim a block (refcount 1).  ``reserved=True`` spends a credit
        promised at admission; otherwise the pool must have headroom beyond
        every outstanding reservation."""
        if reserved:
            if self._reserved <= 0:
                raise ValueError("alloc(reserved=True) with no outstanding reservation")
            self._reserved -= 1
        elif self.available() < 1:
            raise PoolExhausted("pool exhausted (all blocks live or promised)")
        if self._free:
            bid = self._free.pop()
        elif self._lru:
            bid, _ = self._lru.popitem(last=False)  # evict least-recently cached
            del self._by_key[self._key_of.pop(bid)]
            if self.tracer.enabled:
                self.tracer.instant("pool_evict", bid=bid, cached=len(self._lru))
        else:
            raise PoolExhausted("pool exhausted (no free or evictable block)")
        self._ref[bid] = 1
        self.peak_live = max(self.peak_live, len(self._ref))
        if self.tracer.enabled:
            self.tracer.instant("pool_alloc", bid=bid, live=len(self._ref))
        return bid

    def retain(self, bid: int) -> None:
        """Add a reference — reviving the block if it was cached."""
        if bid in self._ref:
            self._ref[bid] += 1
        elif bid in self._lru:
            del self._lru[bid]
            self._ref[bid] = 1
            self.peak_live = max(self.peak_live, len(self._ref))
        else:
            raise ValueError(f"retain of unallocated block {bid}")

    def release(self, bid: int) -> None:
        """Drop a reference.  The last release frees the block — or parks it
        in the evictable cache if it is prefix-registered."""
        r = self._ref.get(bid, 0)
        if r <= 0:
            raise ValueError(f"release of block {bid} would drop its refcount below 0")
        if r > 1:
            self._ref[bid] = r - 1
            return
        del self._ref[bid]
        if bid in self._key_of:
            self._lru[bid] = None  # most-recently cached at the end
        else:
            self._free.append(bid)

    # -- prefix registry -----------------------------------------------------
    def register(self, key: Key, bid: int) -> int:
        """Enter a live block into the prefix registry; first writer wins
        (a duplicate registration keeps the existing block and returns it)."""
        if bid not in self._ref:
            raise ValueError(f"register of non-live block {bid}")
        have = self._by_key.get(key)
        if have is not None:
            return have
        if bid in self._key_of:  # re-keying a registered block is a bug
            raise ValueError(f"block {bid} already registered")
        self._by_key[key] = bid
        self._key_of[bid] = key
        return bid

    def match(self, keys: Iterable[Key]) -> list[int]:
        """Longest registered chain prefix (no refcount change)."""
        out: list[int] = []
        for k in keys:
            bid = self._by_key.get(k)
            if bid is None:
                break
            out.append(bid)
        return out

    # -- copy-on-write -------------------------------------------------------
    def writable(self, bid: int) -> bool:
        """True iff writing ``bid`` in place cannot corrupt a sharer or a
        registered prefix."""
        return self._ref.get(bid) == 1 and bid not in self._key_of

    def cow(self, bid: int) -> int:
        """Copy-on-write: allocate a private replacement for shared/registered
        ``bid``, dropping the caller's reference on it.  The caller copies the
        device rows and swaps its table entry."""
        if self.writable(bid):
            raise ValueError(f"block {bid} is exclusively owned; write in place")
        new = self.alloc()
        self.release(bid)
        self.cow_copies += 1
        return new

    # -- invariants ----------------------------------------------------------
    def check(self) -> None:
        """Conservation + disjointness (asserted by the property tests and
        cheap enough for the engine to call at drain)."""
        free, live, cached = set(self._free), set(self._ref), set(self._lru)
        assert len(self._free) == len(free), "duplicate ids on the free list"
        assert not (free & live) and not (free & cached) and not (live & cached), \
            "a block id appears in two states"
        assert 0 not in free | live | cached, "sentinel block 0 escaped"
        assert len(free) + len(live) + len(cached) == self.num_blocks - 1, \
            "block conservation violated"
        assert all(r > 0 for r in self._ref.values()), "non-positive refcount"
        assert self._reserved >= 0, "negative reservation balance"
        assert set(self._key_of) <= live | cached, "registry points at a freed block"
        assert {self._by_key[k] for k in self._by_key} == set(self._key_of)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"BlockPool(blocks={self.num_blocks}, block={self.block_size}, "
                f"live={self.live}, cached={self.cached}, free={self.free}, "
                f"reserved={self._reserved})")
