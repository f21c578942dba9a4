"""Cross-query device-resident scan-image cache.

Counterpart of cockroach_tpu/exec/scan_cache.py. Reference: the Pebble
block cache (pkg/storage) keeps hot table blocks in memory across
statements; here the analog is the packed and stacked device image of a
table's chunks (ScanOp._pin, ScanOp.stacked_image). The per-operator resident pin
(ScanOp.resident) dies with its flow; this cache keys the image on the
table's content identity, as Catalog.scan_cache_key gives it, so any
ScanOp over the same data borrows the one device copy. The port's ScanOp
learns its device only when it runs, so it appends the device to the
catalog's key when it calls the cache: an image made on one device is
never borrowed on another.

LRU eviction runs under the `storage.hbm_scan_image_cache_bytes` budget
(util/settings.py). A hit or a miss is a stats event and a trace record
(`scan.cache_hit` / `scan.cache_miss`); an insert passes the fault seam
`cache.insert`, and a fault there is a miss: the caller keeps its
private copy, as on budget overflow.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.util import tracing as _tracing
from cockroach_tpu_torch.util.fault import maybe_fail
from cockroach_tpu_torch.util.settings import (
    SCAN_IMAGE_CACHE_BUDGET, Settings,
)


class ScanImageCache:
    """LRU map: cache key tuple -> (value, nbytes). Thread-safe (plan
    builds and prefetch threads may race)."""

    def __init__(self, budget: Optional[int] = None):
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self._budget = budget

    def budget(self) -> int:
        if self._budget is not None:
            return self._budget
        return int(Settings().get(SCAN_IMAGE_CACHE_BUDGET))

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> Optional[Any]:
        with self._mu:
            hit = self._entries.get(key)
            if hit is None:
                stats.add("scan.cache_miss")
                _tracing.record("scan.cache_miss")
                return None
            self._entries.move_to_end(key)
        stats.add("scan.cache_hit", bytes=hit[1])
        _tracing.record("scan.cache_hit", bytes=hit[1])
        return hit[0]

    def contains(self, key: tuple) -> bool:
        """Peek: is this exact key resident? No LRU bump, no hit/miss
        stats."""
        with self._mu:
            return key in self._entries

    def put(self, key: tuple, value: Any, nbytes: int) -> bool:
        """Insert (replacing any stale entry); returns False when the item
        alone exceeds the budget (the caller keeps its private copy). A
        cache insert can never fail a query: any fault here degrades to a
        miss, exactly as on budget overflow."""
        budget = self.budget()
        if nbytes > budget:
            return False
        try:
            maybe_fail("cache.insert")
        except Exception:  # noqa: BLE001 — insert failure == cache miss
            stats.add("scan.cache_insert_fail")
            return False
        evicted = 0
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > budget and self._entries:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted += nb
        if evicted:
            stats.add("scan.cache_evict", bytes=evicted)
        return True

    def invalidate(self, prefix: tuple, keep_tag: Optional[str] = None
                   ) -> int:
        """Drop every entry whose key starts with `prefix` (the storage
        write path passes ("mvcc", engine id, table id)); returns the
        number of entries dropped. `keep_tag` spares keys carrying that
        marker component past the prefix — the device-resident MVCC tier
        (storage/resident.py) tags its pin "resident-pin" so the write
        path's eager invalidation does not evict it: the resident arrays
        absorb writes through their delta fold, and evicting the pin
        would detach the table on every write."""
        n = len(prefix)
        with self._mu:
            dead = [k for k in self._entries
                    if k[:n] == prefix
                    and (keep_tag is None or keep_tag not in k[n:])]
            for k in dead:
                _, nb = self._entries.pop(k)
                self._bytes -= nb
        if dead:
            stats.add("scan.cache_invalidate", events=len(dead))
        return len(dead)

    def snapshot(self) -> List[Tuple[tuple, Any, int]]:
        """Every entry as (key, value, nbytes), least recently used first:
        what `restore` puts back after a `clear`."""
        with self._mu:
            return [(k, v, nb) for k, (v, nb) in self._entries.items()]

    def restore(self, entries: List[Tuple[tuple, Any, int]]) -> None:
        """Put back the entries of a `snapshot`, in its order, under the
        budget (`put`'s rules)."""
        for key, value, nbytes in entries:
            self.put(key, value, nbytes)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bytes = 0


_cache: Optional[ScanImageCache] = None


def scan_image_cache() -> ScanImageCache:
    """The process-wide cache (budgeted by a setting, like the
    reference's single shared block cache per store)."""
    global _cache
    if _cache is None:
        _cache = ScanImageCache()
    return _cache
