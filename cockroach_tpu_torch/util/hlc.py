"""Hybrid logical clocks.

A copy of cockroach_tpu/util/hlc.py (stdlib only).

Reference: pkg/util/hlc/hlc.go:38 (`hlc.Clock`) — a wall-clock/logical-tick
pair giving strictly monotonic, causality-capturing timestamps that order MVCC
versions. MVCC keys sort by (key asc, timestamp desc); Timestamp.pack() packs
(wall, logical) into one int sortable in that order.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import ClassVar


@dataclass(frozen=True, order=True)
class Timestamp:
    """An HLC timestamp: (wall nanos, logical tick).

    Total order is lexicographic (wall, logical), matching reference
    pkg/util/hlc/timestamp.go. The zero Timestamp is "no timestamp".
    """

    wall: int = 0
    logical: int = 0

    def is_empty(self) -> bool:
        return self.wall == 0 and self.logical == 0

    def next(self) -> "Timestamp":
        return Timestamp(self.wall, self.logical + 1)

    def prev(self) -> "Timestamp":
        if self.logical > 0:
            return Timestamp(self.wall, self.logical - 1)
        return Timestamp(self.wall - 1, 1 << 31)

    def pack(self) -> int:
        """Pack into a single sortable int (wall in high bits).

        Host-side only: the result is an arbitrary-precision Python int
        (wall is ~2^60 ns, so the packed value exceeds int64). The C++
        storage engine encodes (wall, logical) as a 12-byte big-endian
        suffix instead (see storage/); device columns never hold packed
        timestamps.
        """
        return (self.wall << 32) | (self.logical & 0xFFFFFFFF)

    @staticmethod
    def unpack(v: int) -> "Timestamp":
        return Timestamp(v >> 32, v & 0xFFFFFFFF)

    def __repr__(self) -> str:
        return f"{self.wall}.{self.logical:09d}"

    # Class-level sentinels (ClassVar so the dataclass machinery ignores
    # them — they must not become constructor fields).
    MAX: ClassVar["Timestamp"]
    MIN: ClassVar["Timestamp"]


# MAX bounds every achievable timestamp: 2^62 ns ~ year 2116.
Timestamp.MAX = Timestamp(1 << 62, 0)
Timestamp.MIN = Timestamp(0, 1)


class HLC:
    """A hybrid logical clock (reference hlc.Clock).

    now() returns timestamps that are strictly monotonic within this clock
    and >= physical time. update(ts) forwards the clock past a remote
    timestamp (the causality mechanism for message receipt).
    """

    def __init__(self, wall_fn=None):
        self._wall_fn = wall_fn or (lambda: time.time_ns())
        self._mu = threading.Lock()
        self._last = Timestamp()

    def now(self) -> Timestamp:
        with self._mu:
            phys = self._wall_fn()
            if phys > self._last.wall:
                self._last = Timestamp(phys, 0)
            else:
                self._last = Timestamp(self._last.wall, self._last.logical + 1)
            return self._last

    def update(self, remote: Timestamp) -> None:
        """Forward the clock to be >= remote (causal receive)."""
        with self._mu:
            if remote > self._last:
                self._last = remote

    def now_wall(self) -> int:
        return self._wall_fn()


class ManualClock:
    """Deterministic wall source for tests (reference hlc.NewManualClock)."""

    def __init__(self, start: int = 1):
        self._now = start

    def __call__(self) -> int:
        return self._now

    def advance(self, d: int) -> None:
        self._now += d
