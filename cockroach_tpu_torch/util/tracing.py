"""Tracing: hierarchical spans with structured payloads + propagation.

Reference: pkg/util/tracing (tracer.go:300 Span, crdbspan.go) — always-on
lightweight spans, context propagation through every layer and across RPC
via interceptors (SetupFlowRequest.TraceInfo), recordings rendered by
EXPLAIN ANALYZE / inflight-trace registry.

This implementation keeps the same surface at the scale this runtime
needs: a thread-local span stack (context propagation within a flow),
`carrier()`/`from_carrier()` for crossing process/RPC boundaries (the
TraceInfo analog), structured events, and a tree rendering. The flow
runtime opens a root span per query when tracing is on (`query_span`);
interior stages attach children via `child_span`/`record`, both of which
are no-ops when no root is active — the cost posture matches
exec/stats.py's disabled path.

Counterpart of cockroach_tpu/util/tracing.py, a copy (stdlib only), with
its `sql.trace.enabled` setting (on by default, as there). A span's
duration is HOST wall time: the flow enqueues its kernels
asynchronously, so a span around a kernel launch measures the launch,
and only a span that waits on the device (the fused readback's one
sync) includes device time. Device time per kernel comes from a
torch.profiler trace (chip_smoke.py). No span reads a device value: a
tag or an event that needed one would add a synchronizing call to every
warm run. Spans opened inside a CUDA graph capture (exec/fused.py
`_trace`) run once, at the capture, and never on a replay. The status
plane's cluster-wide trace fan-in waits for ROADMAP.md queue 1, item 8e;
`crdb_internal.node_inflight_traces` reads this process's tracer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from cockroach_tpu_torch.util.settings import Settings

TRACE_ENABLED = Settings.register(
    "sql.trace.enabled",
    True,
    "open a root span per query (EXPLAIN ANALYZE always traces)",
)

# Bound per-span recording memory (the reference's maxRecordedBytes
# posture): past the cap events are counted, not stored, and the
# rendering carries a truncation marker.
MAX_EVENTS_PER_SPAN = 128

_dropped_counter = None


def _dropped_metric():
    global _dropped_counter
    if _dropped_counter is None:
        from cockroach_tpu_torch.util.metric import default_registry

        _dropped_counter = default_registry().counter(
            "trace_dropped_events_total",
            "span events discarded past the per-span recording cap")
    return _dropped_counter


def enabled() -> bool:
    return bool(Settings().get(TRACE_ENABLED))


@dataclass
class Span:
    name: str
    trace_id: int
    span_id: int
    parent_id: Optional[int] = None
    start: float = field(default_factory=time.perf_counter)
    end: Optional[float] = None
    tags: Dict[str, object] = field(default_factory=dict)
    events: List = field(default_factory=list)  # (dt, message, tags)
    children: List["Span"] = field(default_factory=list)
    dropped: int = 0  # events discarded past MAX_EVENTS_PER_SPAN

    @property
    def duration(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def record(self, message: str, **tags):
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self.dropped += 1
            _dropped_metric().inc()
            return
        self.events.append((time.perf_counter() - self.start, message,
                            tags))

    def set_tag(self, key: str, value):
        self.tags[key] = value

    def finish(self):
        if self.end is None:
            self.end = time.perf_counter()

    # -- rendering --------------------------------------------------------

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        tag_s = (" " + " ".join(f"{k}={v}" for k, v in self.tags.items())
                 if self.tags else "")
        lines = [f"{pad}{self.name}: {self.duration * 1e3:.2f}ms{tag_s}"]
        for dt, msg, tags in self.events:
            t = (" " + " ".join(f"{k}={v}" for k, v in tags.items())
                 if tags else "")
            lines.append(f"{pad}  @{dt * 1e3:.2f}ms {msg}{t}")
        if self.dropped:
            lines.append(f"{pad}  (+{self.dropped} events dropped)")
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": round(self.duration * 1e3, 3),
            "finished": self.end is not None,
        }
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.events:
            d["events"] = [
                {"at_ms": round(dt * 1e3, 3), "msg": msg,
                 **({"tags": tags} if tags else {})}
                for dt, msg, tags in list(self.events)
            ]
        if self.dropped:
            d["dropped_events"] = self.dropped
        if self.children:
            d["children"] = [c.as_dict() for c in list(self.children)]
        return d

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in list(self.children):
            yield from c.walk()


class Tracer:
    """Span factory + thread-local active-span propagation."""

    def __init__(self):
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._next_id = 1
        self.inflight: Dict[int, Span] = {}  # inflight-trace registry

    def _ids(self):
        with self._lock:
            i = self._next_id
            self._next_id += 1
            return i

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def root(self) -> Optional[Span]:
        st = self._stack()
        return st[0] if st else None

    @contextmanager
    def span(self, name: str, **tags):
        parent = self.current()
        sid = self._ids()
        s = Span(name, trace_id=(parent.trace_id if parent else sid),
                 span_id=sid,
                 parent_id=parent.span_id if parent else None)
        s.tags.update(tags)
        if parent is not None:
            parent.children.append(s)
        self.inflight[sid] = s
        self._stack().append(s)
        try:
            yield s
        finally:
            self._stack().pop()
            s.finish()
            self.inflight.pop(sid, None)

    # -- cross-boundary propagation (TraceInfo analog) --------------------

    def carrier(self) -> Optional[Dict[str, int]]:
        cur = self.current()
        if cur is None:
            return None
        return {"trace_id": cur.trace_id, "span_id": cur.span_id}

    @contextmanager
    def from_carrier(self, carrier: Optional[Dict[str, int]], name: str,
                     **tags):
        """Open a span that continues a remote trace (the receiving side
        of SetupFlowRequest.TraceInfo). When the parent span is inflight
        in this process (worker-thread hop rather than a true RPC), the
        child is grafted onto the live tree so one recording covers both
        sides; otherwise ids alone link the recordings."""
        sid = self._ids()
        s = Span(name,
                 trace_id=(carrier or {}).get("trace_id", sid),
                 span_id=sid,
                 parent_id=(carrier or {}).get("span_id"))
        s.tags.update(tags)
        parent = (self.inflight.get(s.parent_id)
                  if s.parent_id is not None else None)
        if parent is not None and parent.trace_id == s.trace_id:
            parent.children.append(s)
        self.inflight[sid] = s
        self._stack().append(s)
        try:
            yield s
        finally:
            self._stack().pop()
            s.finish()
            self.inflight.pop(sid, None)

    def start_remote(self, carrier: Optional[Dict[str, int]], name: str,
                     **tags) -> Optional[Span]:
        """Non-context form of from_carrier for STREAMING code (chunk
        generators) that cannot scope a with-block around a remote hop:
        creates the child span, grafts it onto the live parent when the
        parent is inflight in-process, registers it inflight, and does
        NOT touch the thread-local stack — interleaved generators (a
        join consuming two chunk streams) therefore cannot corrupt span
        nesting. The caller must pair it with finish_remote(). Returns
        None (a no-op handle) when there is no carrier to continue."""
        if carrier is None:
            return None
        sid = self._ids()
        s = Span(name, trace_id=carrier.get("trace_id", sid),
                 span_id=sid, parent_id=carrier.get("span_id"))
        s.tags.update(tags)
        parent = (self.inflight.get(s.parent_id)
                  if s.parent_id is not None else None)
        if parent is not None and parent.trace_id == s.trace_id:
            parent.children.append(s)
        self.inflight[sid] = s
        return s

    def finish_remote(self, s: Optional[Span]) -> None:
        if s is None:
            return
        s.finish()
        self.inflight.pop(s.span_id, None)

    def inflight_summaries(self) -> List[Dict[str, object]]:
        """Shallow /_status/traces payload: one row per live span.
        `node_id` is the span's node tag (remote KV hops are stamped
        with the serving node) or None for untagged local spans."""
        rows = []
        for s in list(self.inflight.values()):
            tags = dict(s.tags)
            nid = tags.get("node_id")
            rows.append({
                "name": s.name,
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "node_id": int(nid) if nid is not None else None,
                "elapsed_ms": round(s.duration * 1e3, 3),
                "tags": {k: str(v) for k, v in tags.items()},
                "events": len(s.events) + s.dropped,
            })
        rows.sort(key=lambda r: (r["trace_id"], r["span_id"]))
        return rows


_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer


def record(message: str, **tags) -> None:
    """Attach an event to the active span, if any (zero-cost when not
    tracing)."""
    cur = _tracer.current()
    if cur is not None:
        cur.record(message, **tags)


def tag_root(**tags) -> None:
    """Tag this thread's root span (e.g. the tier a query finished on)."""
    root = _tracer.root()
    if root is not None:
        root.tags.update(tags)


@contextmanager
def query_span(name: str, **tags):
    """Root span for a query, gated on `sql.trace.enabled`. Yields None
    (and costs one settings lookup) when tracing is off."""
    if not enabled():
        yield None
        return
    with _tracer.span(name, **tags) as s:
        yield s


@contextmanager
def child_span(name: str, **tags):
    """Child span attached to the active span; a no-op yielding None when
    nothing is tracing (the interior-stage analog of stats.timed)."""
    if _tracer.current() is None:
        yield None
        return
    with _tracer.span(name, **tags) as s:
        yield s


def summarize(span: Optional[Span]) -> Optional[Dict[str, object]]:
    """Compact per-query trace digest for BENCH JSON / EXPLAIN ANALYZE:
    stage durations, retry count, tier reached, event volume."""
    if span is None:
        return None
    stages: Dict[str, float] = {}
    retries = 0
    degradations = 0
    restarts = 0
    events = 0
    dropped = 0
    tier = span.tags.get("tier")
    for s in span.walk():
        if s is not span:
            stages[s.name] = stages.get(s.name, 0.0) + s.duration * 1e3
        if s.name.startswith("flow."):
            # the LAST flow.<tier> span entered is the rung the query
            # finished on (degraded rungs appear earlier in the walk)
            tier = s.name[len("flow."):]
        events += len(s.events)
        dropped += s.dropped
        for _, msg, _tags in list(s.events):
            if msg == "retry":
                retries += 1
            elif msg.startswith("degrade"):
                degradations += 1
            elif msg.startswith("flow.restart"):
                restarts += 1
    return {
        "duration_ms": round(span.duration * 1e3, 3),
        "stages": {k: round(v, 3) for k, v in sorted(stages.items())},
        "retries": retries,
        "degradations": degradations,
        "restarts": restarts,
        "tier": tier,
        "events": events,
        "dropped_events": dropped,
    }
