"""Exact-basket LRU result cache for the serving gateway (DESIGN.md §10).

Keys are ``(packed basket words, top_k, generation)``: the packed uint32
bitset is the canonical basket identity (two id-lists with the same item set
hash identically), ``top_k`` because a smaller k is served as a different
response object, and the rulebook **generation** so a hot-swap can never
serve a stale entry — post-swap lookups use the new generation number and
simply miss; old-generation entries age out of the LRU (or are dropped
eagerly via :meth:`evict_generation`).

Values are ``(items, scores, generation, bucket)`` tuples — the *same*
arrays a dispatch produced, so a hit is bit-identical to the miss that
filled it (bucket included: the hit reports the bucket that computed it).
Thread-safe: ``get``/``put`` run from client threads and the batcher worker
concurrently.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np


def basket_key(packed_row: np.ndarray, top_k: int, generation: int) -> tuple:
    """Cache key for one packed basket row: (words-bytes, top_k, generation)."""
    return (np.ascontiguousarray(packed_row, np.uint32).tobytes(), int(top_k), int(generation))


class BasketCache:
    """Bounded LRU over exact baskets with hit/miss accounting.

    ``capacity <= 0`` disables the cache (every ``get`` misses, ``put`` is a
    no-op) — the gateway wiring stays unconditional."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: tuple, count: bool = True):
        """The cached ``(items, scores, generation, bucket)`` entry or
        ``None``. ``count=False`` probes without touching the hit/miss
        counters — for callers (the gateway) that only want to account
        probes whose request is actually admitted; pair it with
        :meth:`record`."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if count:
                    self.misses += 1
                return None
            self._entries.move_to_end(key)
            if count:
                self.hits += 1
            return entry

    def record(self, hit: bool) -> None:
        """Count a probe outcome separately from :meth:`get`."""
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def put(self, key: tuple, entry: tuple) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def evict_generation(self, generation: int) -> int:
        """Drop every entry answered by ``generation``; returns the count.
        Optional eager cleanup after a hot-swap (stale entries are already
        unreachable — their keys carry the old generation)."""
        with self._lock:
            stale = [k for k, v in self._entries.items() if v[2] == generation]
            for k in stale:
                del self._entries[k]
            return len(stale)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            size = len(self._entries)
        return {
            "size": size,
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }
