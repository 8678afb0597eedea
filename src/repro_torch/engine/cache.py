"""LRU plan cache with hit/miss/eviction counters (DESIGN.md 5.2).

Keys are ``(template key, graph fingerprint, bucket, engine override)``
tuples built by the facade; values are :class:`~repro_torch.engine.plan.
CompiledPlan` objects.  The counters are the observable the zero-recompile
acceptance test asserts on: a warm rebind must increment ``hits`` and leave
``misses`` (= plan builds = SOI compilations) unchanged.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, TypeVar

V = TypeVar("V")


@dataclasses.dataclass
class CacheStats:
    """Point-in-time cache counters (the zero-recompile observables)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    capacity: int = 0
    invalidations: int = 0  # entries dropped by invalidate(), not LRU pressure

    @property
    def hit_rate(self) -> float:
        """Hits over total lookups (0.0 before any lookup)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class BoundedDict(OrderedDict):
    """Dict with LRU eviction past ``capacity`` — the adjacency cache.

    Evicting an entry only loses *sharing*: plans already holding the array
    keep it alive through their operands, so eviction is always safe.
    """

    def __init__(self, capacity: int = 16):
        super().__init__()
        self.capacity = capacity

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        while len(self) > self.capacity:
            # not popitem(): its value fetch re-enters our __getitem__ after
            # the link is gone and move_to_end would raise
            del self[next(iter(self))]


class PlanCache:
    """A plain LRU: most-recently-used plans survive, counters are public."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("plan cache capacity must be >= 1")
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._entries: OrderedDict[Hashable, V] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get_or_build(self, key: Hashable, builder: Callable[[], V]) -> V:
        """Return the cached value for ``key``, building (and possibly
        evicting the LRU entry) on miss."""
        if key in self._entries:
            self.hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        value = builder()
        self._entries[key] = value
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return value

    def pop_matching(
        self, match: Callable[[Hashable], bool]
    ) -> list[tuple[Hashable, V]]:
        """Remove and return the entries whose key satisfies ``match``.

        Unlike :meth:`invalidate` this does NOT count toward
        ``invalidations``: it is the *reclassification* path — the engine
        moves superseded-but-resumable plans into its staging area instead
        of dropping them (DESIGN.md Sect. 8.3).
        """
        keys = [k for k in self._entries if match(k)]
        return [(k, self._entries.pop(k)) for k in keys]

    def invalidate(self, stale: Callable[[Hashable], bool]) -> int:
        """Drop exactly the entries whose key satisfies ``stale``.

        This is the precise (non-flush) invalidation path used on graph
        mutation: only plans bound to fingerprints outside the version
        history are removed, everything else keeps its LRU position.
        Returns the number of entries dropped (also accumulated in
        ``invalidations``).
        """
        keys = [k for k in self._entries if stale(k)]
        for k in keys:
            del self._entries[k]
        self.invalidations += len(keys)
        return len(keys)

    def clear(self) -> None:
        """Drop every entry (counters keep accumulating)."""
        self._entries.clear()

    def stats(self) -> CacheStats:
        """A :class:`CacheStats` snapshot of the counters."""
        return CacheStats(
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
            size=len(self._entries),
            capacity=self.capacity,
            invalidations=self.invalidations,
        )
