"""SQL changefeeds: exactly-once CDC off the durable MVCC engine.

A copy of cockroach_tpu/sql/changefeed.py (host only: numpy and the
stdlib). `CREATE CHANGEFEED FOR TABLE t` runs as a server/jobs.py job
whose checkpointed FRONTIER is the resume point after a crash; KV
versions are decoded through the table row codec into typed row
envelopes, and envelopes flow into pluggable sinks.

The change source replays durable MVCC history: each poll takes an HLC
horizon, fsyncs the WAL, and exports every version in (frontier,
horizon] from the engine (`export_span`, the same on both engine
backends). Upstream delivery is at-least-once (a crash between a
segment write and its checkpoint re-emits the window); the (key, ts)
dedup buffer (kv/rangefeed.py `Feed`, pruned at every frontier advance)
and the file sink's resume-time orphan-segment cleanup make delivery
exactly-once at the acked (checkpointed) horizon.

Sinks:
- `MemorySink`: an in-process list, for tests and the matview pipeline.
- `FileSink`: one ndjson segment per frontier advance, written tmp +
  fsync + rename with the crash point "changefeed.segment" between the
  fsync and the rename; segment names carry the (lo, hi] frontier
  window, so the acked stream is the chain of contiguous segments and a
  resuming job deletes any orphan past its checkpoint.

Departure from the JAX module: a poll takes its version and horizon
inside the store's write window (storage/mvcc.py `write_window`), so a
poll that runs while a transaction applies its versions waits for it;
the JAX source can close its window over versions a concurrent commit
has not written yet and never emit them.

`stream_rows` backs `EXPERIMENTAL CHANGEFEED FOR t` (the session's
"stream" result kind, a generator of envelope lines); sql/pgwire.py
renders it as one flushed DataRow per envelope.

Reference: ccl/changefeedccl (changeAggregator/changeFrontier, JSON
encoders, sinks, resolved-ts checkpoints into the job record).
"""

from __future__ import annotations

import json
import os
import threading
import time
from decimal import Decimal
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.coldata.batch import Kind
from cockroach_tpu_torch.kv.rangefeed import (Feed, RangefeedEvent,
                                              _metrics)
from cockroach_tpu_torch.storage.mvcc import (decode_key, decode_row,
                                              encode_key)
from cockroach_tpu_torch.util.fault import crash_point, maybe_fail
from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.retry import with_retry

CHANGEFEED_JOB = "changefeed"


# ------------------------------------------------------------ row codec

def _type_of(tname: str):
    from cockroach_tpu_torch.sql.session import _type_of as f

    return f(tname)


def decode_typed_row(desc, fields: List[int]) -> Dict[str, object]:
    """Stored row codec fields -> typed column dict (the envelope's
    `after` payload): dict codes back to strings, scaled decimals to
    decimal strings, epoch days to ISO dates, vector slots to float
    lists. The pk column is not in the value tuple (it rides the key)."""
    out: Dict[str, object] = {}
    for i, (cname, tname) in enumerate(desc.value_columns()):
        if not desc.visible(cname):
            continue
        ty = _type_of(tname)
        raw = desc.field_value(fields, i)
        if raw is None:
            out[cname] = None
            continue
        if ty.kind is Kind.VECTOR:
            off = desc.slot_offset(i)
            slots = np.asarray(fields[off:off + ty.dim], dtype=np.int64)
            out[cname] = [float(x) for x in
                          slots.astype(np.uint32).view(np.float32)]
        elif ty.kind is Kind.STRING:
            d = desc.dicts.get(cname, [])
            out[cname] = d[raw] if 0 <= raw < len(d) else raw
        elif ty.kind is Kind.DECIMAL:
            out[cname] = str(Decimal(raw).scaleb(-ty.scale))
        elif ty.kind is Kind.DATE:
            import datetime

            out[cname] = (datetime.date(1970, 1, 1)
                          + datetime.timedelta(days=raw)).isoformat()
        else:
            out[cname] = int(raw)
    return out


def encode_envelope(desc, pk: int, ts: Timestamp,
                    value: Optional[bytes]) -> str:
    """One KV version -> the typed JSON row envelope."""
    env: Dict[str, object] = {
        "table": desc.name,
        "key": int(pk),
        "ts": [ts.wall, ts.logical],
    }
    if not value:  # b"" / None: MVCC tombstone
        env["op"] = "delete"
        env["after"] = None
    else:
        env["op"] = "upsert"
        env["after"] = decode_typed_row(desc, decode_row(value))
    return json.dumps(env, sort_keys=True)


# ----------------------------------------------------------- delta source

def table_span(table_id: int) -> Tuple[bytes, bytes]:
    return encode_key(table_id, 0), encode_key(table_id + 1, 0)


class EngineDeltaSource:
    """Replays durable MVCC history for one table. `poll` returns every
    version in (frontier, horizon] ordered by (ts, key) plus the new
    horizon; an unchanged table version skips the export walk entirely,
    so idle polls cost O(1)."""

    def __init__(self, store, table_id: int):
        self.store = store
        self.table_id = int(table_id)
        self.span = table_span(self.table_id)
        self._last_version: Optional[int] = None

    def poll(self, frontier: Timestamp
             ) -> Tuple[List[Tuple[bytes, Timestamp, bytes]], Timestamp]:
        # version FIRST, before the horizon (and before sync(), which
        # releases the GIL): a write committing anywhere after this
        # read leaves the cached version stale, so the next cycle
        # re-exports its window instead of fast-path skipping an event
        # the frontier already covered. The (key, ts) dedup Feed makes
        # that at-least-once replay exactly-once downstream.
        # horizon AFTER the version, both inside the store's write
        # window: any later write gets a larger HLC ts, and no write at
        # ts <= horizon is still applying its versions, so nothing at
        # ts <= horizon can appear after the export below
        with self.store.write_window():
            ver = self.store.table_version(self.table_id)
            horizon = self.store.clock.now()
        self.store.sync()  # emit only what survives kill -9
        if ver == self._last_version:
            return [], horizon
        self._last_version = ver
        out = []
        for key, ts, val in self.store.engine.export_span(*self.span):
            if frontier < ts <= horizon:
                out.append((key, ts, val))
        out.sort(key=lambda e: (e[1].wall, e[1].logical, e[0]))
        return out, horizon

    def endpoints(self, frontier: Timestamp, horizon: Timestamp
                  ) -> List[Tuple[int, Optional[List[int]],
                                  Optional[List[int]]]]:
        """Net per-key delta for view maintenance: for every key with a
        version in (frontier, horizon], the visible row AT frontier (the
        state a view currently reflects) and AT horizon. Intermediate
        versions cancel out of any fold, so only the endpoints matter."""
        eng = self.store.engine
        changed = []
        seen = set()
        for key, ts, _val in eng.export_span(*self.span):
            if frontier < ts <= horizon and key not in seen:
                seen.add(key)
                changed.append(key)
        out = []
        for key in changed:
            _t, pk = decode_key(key)
            old = eng.get(key, frontier) if not frontier.is_empty() \
                else None
            new = eng.get(key, horizon)
            old_f = decode_row(old[0]) if old is not None and old[0] \
                else None
            new_f = decode_row(new[0]) if new is not None and new[0] \
                else None
            out.append((pk, old_f, new_f))
        return out


# ----------------------------------------------------------------- sinks

class MemorySink:
    """In-process sink; `events()`/`resolved()` parse the stream back."""

    def __init__(self):
        self.lines: List[str] = []

    def emit(self, line: str) -> None:
        self.lines.append(line)

    def flush_segment(self, lo: Timestamp, hi: Timestamp) -> None:
        pass  # nothing durable to cut

    def events(self) -> List[dict]:
        return [json.loads(ln) for ln in self.lines
                if "resolved" not in json.loads(ln)]

    def resolved(self) -> List[List[int]]:
        return [json.loads(ln)["resolved"] for ln in self.lines
                if "resolved" in json.loads(ln)]


# process-wide memory sinks addressable from job payloads (same-process
# jobs only; crash tests use the file sink)
_MEMORY_SINKS: Dict[str, MemorySink] = {}
_MEMORY_MU = threading.Lock()


def memory_sink(token: str) -> MemorySink:
    with _MEMORY_MU:
        s = _MEMORY_SINKS.get(token)
        if s is None:
            s = _MEMORY_SINKS[token] = MemorySink()
        return s


def _seg_name(lo: Timestamp, hi: Timestamp) -> str:
    return (f"seg-{lo.wall:020d}-{lo.logical:010d}"
            f"-{hi.wall:020d}-{hi.logical:010d}.ndjson")


def _seg_bounds(name: str) -> Tuple[Timestamp, Timestamp]:
    parts = name[len("seg-"):-len(".ndjson")].split("-")
    return (Timestamp(int(parts[0]), int(parts[1])),
            Timestamp(int(parts[2]), int(parts[3])))


class FileSink:
    """Durable segment-per-frontier-advance sink. Each `flush_segment`
    writes the buffered envelopes for the (lo, hi] window as one ndjson
    file via tmp + fsync + rename (atomic on POSIX; the engine's durable
    discipline, crash point "changefeed.segment" between fsync and
    rename). A crash leaves at most a .tmp (ignored) or a fully-renamed
    segment not yet covered by a job checkpoint — `open` at resume
    deletes those orphans, so the directory always holds exactly the
    acked chain plus the in-flight window."""

    def __init__(self, path: str, resume_frontier: Timestamp = Timestamp()):
        self.path = path
        os.makedirs(path, exist_ok=True)
        for name in list(os.listdir(path)):
            if name.endswith(".tmp"):
                os.unlink(os.path.join(path, name))
                continue
            if not name.startswith("seg-"):
                continue
            lo, _hi = _seg_bounds(name)
            if lo >= resume_frontier:  # written but never acked
                os.unlink(os.path.join(path, name))
        self._buf: List[str] = []

    def emit(self, line: str) -> None:
        self._buf.append(line)

    def flush_segment(self, lo: Timestamp, hi: Timestamp) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        final = os.path.join(self.path, _seg_name(lo, hi))
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(buf) + "\n")
            f.flush()
            os.fsync(f.fileno())
        crash_point("changefeed.segment")
        os.replace(tmp, final)
        dfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    @staticmethod
    def read_lines(path: str) -> List[str]:
        """The acked stream: walk the contiguous segment chain in
        frontier order; overlapping leftovers (none after a clean
        resume) are skipped rather than double-counted."""
        segs = sorted(
            (_seg_bounds(n) + (n,) for n in os.listdir(path)
             if n.startswith("seg-") and n.endswith(".ndjson")),
            key=lambda s: (s[0].wall, s[0].logical,
                           -s[1].wall, -s[1].logical))
        out: List[str] = []
        cur = Timestamp()
        for lo, hi, name in segs:
            if lo < cur:
                continue  # overlapped by an already-taken segment
            with open(os.path.join(path, name)) as f:
                out.extend(ln for ln in f.read().splitlines() if ln)
            cur = hi
        return out

    @staticmethod
    def read_events(path: str) -> List[dict]:
        return [json.loads(ln) for ln in FileSink.read_lines(path)
                if "resolved" not in json.loads(ln)]


def open_sink(spec: Optional[dict],
              resume_frontier: Timestamp) -> object:
    spec = spec or {"kind": "memory", "token": "default"}
    kind = spec.get("kind", "memory")
    if kind == "file":
        return FileSink(spec["path"], resume_frontier)
    if kind == "memory":
        return memory_sink(spec.get("token", "default"))
    raise ValueError(f"unknown changefeed sink {kind!r}")


# ---------------------------------------------------------------- stream

class ChangefeedStream:
    """One table's changefeed: delta source -> dedup Feed -> envelope
    encoder -> sink, frontier checkpointed into the job record. The
    dedup buffer IS the kv/rangefeed Feed seed (at-least-once upstream,
    exactly-once after dedup), pruned at every frontier advance."""

    def __init__(self, store, desc, sink, options: Optional[dict] = None,
                 registry=None, job_id: Optional[int] = None,
                 epoch: int = 0, frontier: Timestamp = Timestamp(),
                 emitted: int = 0):
        self.store = store
        self.desc = desc
        self.sink = sink
        self.options = dict(options or {})
        self.registry = registry
        self.job_id = job_id
        self.epoch = epoch
        self.frontier = frontier
        self.emitted = emitted
        self.source = EngineDeltaSource(store, desc.table_id)
        self.feed = Feed(0, self.source.span, node_id=0)
        self.feed.resolved = frontier

    def attach(self, bus, node_id: int) -> None:
        """Optional cluster transport: register the dedup feed on a
        RangefeedBus (leaseholder failover re-registration stays the kv
        layer's job; the dedup buffer carries across)."""
        live = bus.register(self.source.span, node_id)
        live._seen = self.feed._seen
        live.resolved = self.feed.resolved
        self.feed = live

    def _emit(self, line: str) -> None:
        def once():
            maybe_fail("changefeed.emit")
            self.sink.emit(line)

        with_retry(once, name="changefeed.emit")

    def poll(self) -> int:
        """One cycle: replay (frontier, horizon], dedup, emit, advance +
        persist the frontier. Returns envelopes emitted."""
        events, horizon = self.source.poll(self.frontier)
        for key, ts, val in events:
            self.feed.offer(RangefeedEvent(key, val or None, ts))
        n = 0
        for ev in self.feed.drain():
            _t, pk = decode_key(ev.key)
            self._emit(encode_envelope(self.desc, pk, ev.ts, ev.value))
            _metrics.emitted.inc()
            n += 1
        self.emitted += n
        if horizon > self.frontier:
            lo, self.frontier = self.frontier, horizon
            if self.options.get("resolved"):
                self._emit(json.dumps(
                    {"resolved": [horizon.wall, horizon.logical]}))
                _metrics.resolved.inc()
            self.sink.flush_segment(lo, horizon)
            # dedup memory is bounded by the
            # unresolved window — prune at EVERY frontier advance
            self.feed.prune_seen(horizon)
            self.feed.resolved = horizon
            lag = max(0, self.store.clock.now().wall - horizon.wall)
            _metrics.frontier_lag_ns.set(float(lag))
            if self.registry is not None and self.job_id is not None:
                self.registry.checkpoint(self.job_id, self.epoch, {
                    "frontier": [horizon.wall, horizon.logical],
                    "emitted": self.emitted,
                    "seen": self.feed.seen_size(),
                })
        return n


# ------------------------------------------------------------------ jobs

def make_resumer(catalog) -> Callable:
    """The "changefeed" job resumer: rebuild the stream from the
    checkpointed frontier and poll until the payload's stop condition
    (target frontier / max_polls) or until cancel fences the lease
    (checkpoint raises StaleLease, which adopt_and_run treats as lease
    loss, not failure). Continuous feeds (no stop condition) loop until
    cancelled — run those under a daemon thread."""

    def resume(reg, rec):
        payload = rec.payload
        desc = catalog.desc(payload["table"])
        prog = rec.progress or {}
        frontier = Timestamp(*prog.get("frontier", [0, 0]))
        sink = open_sink(payload.get("sink"), frontier)
        stream = ChangefeedStream(
            catalog.store, desc, sink,
            options=payload.get("options", {}),
            registry=reg, job_id=rec.id, epoch=rec.lease_epoch,
            frontier=frontier, emitted=int(prog.get("emitted", 0)))
        target = payload.get("target")
        target_ts = Timestamp(*target) if target else None
        max_polls = payload.get("max_polls")
        # continuous feeds (no stop condition) must not busy-spin on
        # idle polls: default them to a small sleep; finite feeds keep
        # 0 so they drain at full speed
        continuous = (target_ts is None and max_polls is None
                      and not payload.get("once"))
        interval = float(payload.get("poll_interval_ms",
                                     5.0 if continuous else 0.0)) / 1e3
        polls = 0
        while True:
            stream.poll()
            polls += 1
            if target_ts is not None and stream.frontier >= target_ts:
                return
            if max_polls is not None and polls >= int(max_polls):
                return
            if target_ts is None and max_polls is None \
                    and payload.get("once"):
                return
            if interval:
                time.sleep(interval)

    return resume


def register(registry, catalog) -> None:
    registry.register_resumer(CHANGEFEED_JOB, make_resumer(catalog))


def stream_rows(catalog, desc, options: dict):
    """Generator backing EXPERIMENTAL CHANGEFEED: poll the
    stream and yield envelope lines over the open portal until `limit`
    envelopes (default: one caught-up poll) have been pushed."""
    sink = MemorySink()
    stream = ChangefeedStream(catalog.store, desc, sink,
                              options=options)
    limit = options.get("limit")
    polls = int(options.get("max_polls", 1))
    done = 0
    for _ in range(max(1, polls)):
        stream.poll()
        for line in sink.lines[done:]:
            done += 1
            yield line
            if limit is not None and done >= int(limit):
                return
