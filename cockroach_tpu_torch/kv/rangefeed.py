"""Rangefeeds: the per-feed event buffer with its (key, ts) dedup, the
in-process event bus, and the changefeed counters.

A copy of cockroach_tpu/kv/rangefeed.py (stdlib only) for `_metrics`,
`RangefeedEvent`, `Feed` and `RangefeedBus`. The SQL changefeed
(sql/changefeed.py) uses `Feed` as its dedup buffer: delivery upstream is
at-least-once, and the (key, ts) set makes it exactly-once downstream,
pruned at every frontier advance so it stays bounded by the unresolved
window.

Not ported yet: the cluster CDC class `Changefeed` (JAX :133), which
registers one feed per range on its leaseholder and re-registers after a
failover. It needs `cluster.ranges` and the leaseholders of
kv/kvserver.py, ROADMAP.md queue 1, item 8e.

Reference: kvserver/rangefeed (per-range event streams, resolved
timestamps from closed timestamps).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.metric import default_registry


class _Metrics:
    """Process-wide rangefeed/changefeed counters (shared with the SQL
    changefeed pipeline in sql/changefeed.py)."""

    def __init__(self):
        reg = default_registry()
        self.emitted = reg.counter(
            "changefeed_emitted_rows",
            "row envelopes pushed into changefeed sinks")
        self.dup_suppressed = reg.counter(
            "changefeed_duplicates_suppressed",
            "at-least-once replays dropped by (key, ts) dedup")
        self.resolved = reg.counter(
            "changefeed_resolved_emitted",
            "resolved-timestamp messages emitted")
        self.frontier_lag_ns = reg.gauge(
            "changefeed_frontier_lag_ns",
            "clock wall minus checkpointed frontier wall, last poll")


_metrics = _Metrics()


@dataclass(frozen=True)
class RangefeedEvent:
    key: bytes
    value: Optional[bytes]  # None = deletion
    ts: Timestamp


class Feed:
    def __init__(self, feed_id: int, span: Tuple[bytes, bytes],
                 node_id: int):
        self.id = feed_id
        self.span = span
        self.node_id = node_id  # events accepted from this node only
        self.events: List[RangefeedEvent] = []
        self.resolved = Timestamp(0, 0)
        self._seen: set = set()

    def offer(self, ev: RangefeedEvent):
        k = (ev.key, ev.ts.wall, ev.ts.logical)
        if k in self._seen:
            _metrics.dup_suppressed.inc()
            return
        self._seen.add(k)
        self.events.append(ev)

    def seen_size(self) -> int:
        return len(self._seen)

    def drain(self) -> List[RangefeedEvent]:
        out, self.events = self.events, []
        return out

    def prune_seen(self, upto: Timestamp):
        """Dedup entries at ts <= the resolved frontier can never be
        replayed (catch-up only replays versions > resolved): drop them
        so the set stays bounded by the unresolved window."""
        self._seen = {k for k in self._seen
                      if Timestamp(k[1], k[2]) > upto}


class RangefeedBus:
    """Event fan-out (the MuxRangeFeed stand-in: in-process, the same
    per-range event and resolved-ts stream shape)."""

    def __init__(self):
        self.feeds: Dict[int, Feed] = {}
        self._next = 0

    def register(self, span: Tuple[bytes, bytes], node_id: int) -> Feed:
        self._next += 1
        f = Feed(self._next, span, node_id)
        self.feeds[self._next] = f
        return f

    def close(self, feed_id: int):
        self.feeds.pop(feed_id, None)

    def publish(self, node_id: int, key: bytes, value: Optional[bytes],
                ts: Timestamp):
        for f in self.feeds.values():
            if f.node_id == node_id and f.span[0] <= key < f.span[1]:
                f.offer(RangefeedEvent(key, value, ts))

    def publish_resolved(self, node_id: int, span: Tuple[bytes, bytes],
                         ts: Timestamp):
        for f in self.feeds.values():
            if f.node_id != node_id:
                continue
            # overlapping span -> the feed's resolved frontier advances
            if span[0] < f.span[1] and f.span[0] < span[1]:
                if ts > f.resolved:
                    f.resolved = ts
                    # without this prune _seen grows with every write
                    # for the feed's lifetime
                    f.prune_seen(ts)
