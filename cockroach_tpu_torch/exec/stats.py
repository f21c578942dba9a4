"""Per-stage execution statistics — the ComponentStats analog.

Counterpart of cockroach_tpu/exec/stats.py. Reference: every vectorized
operator is wrapped by a vectorizedStatsCollector
(pkg/sql/colflow/stats.go:239) emitting ComponentStats protos that render
in EXPLAIN ANALYZE.

The flow enqueues device work asynchronously, so a stage's seconds are
the HOST time of the stage (packing, enqueueing kernels), not its device
time; a stage that reads a device value back includes the wait. For
device attribution trace a run with torch.profiler (chip_smoke.py
--profile). The stages the port records:

  scan.pack       host packing of a chunk into the pinned wire buffer
                  (on the prefetch thread, reported into the consumer's
                  per-query collection)
  scan.transfer   enqueueing its host-to-device copy
  scan.stack      stacking a resident scan's chunks into one image
  scan.cache_*    the scan-image cache: hit, miss, evict, invalidate,
                  insert_fail (a fault at the `cache.insert` seam)
  agg.fold_stacked   a GROUP BY over a scan's resident image (an event)
  join.build_stacked a join build made from a resident image (an event)
  agg.fold        a GROUP BY's per-batch partial and fold
  join.build      a join's build side: compaction, repack, prepare
  shrink          a ShrinkOp's concatenation and compaction
  flow.restart    one event per FlowRestart rerun of the flow
  fused.prime     stacking the scans' images for a fused run
  prime.skipped   a fused run whose every image was resident (an event)
  fused.exec      an eager run of the fused program
  fused.capture   the capture of its CUDA graph (after an eager warm-up)
  fused.replay    one replay of the graph
  fused.readback  the copy of the packed result to the host
  fused.first_execution
                  a runner's first run (sql_first_execution_seconds)
  fused.fallback_unsupported / fused.fallback_result
                  a fused run handed to the streaming operators
  resilience.degrade.<tier> / .skip.<tier> / .forced.<tier> /
  resilience.retry.<name>
                  the degradation ladder's steps (exec/operators.py
                  run_flow) and in-place retries (util/retry.py)
  route.gpu / route.cpu
                  a collect on the caller's device / placed on the host
                  (exec/operators.py flow_backend)
  host.rowmap     the row engine's per-batch evaluation (exec/rowexec.py;
                  rows: the rows it evaluated)
  sql.prepared_hit
                  a Session execute served from its prepared cache
  sqlstats.fingerprints_evicted
                  fingerprints the sqlstats LRU cap evicted (rows: how
                  many)

Zero overhead when disabled (module flag checked per call site).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ComponentStats:
    """One stage's counters (component_stats.proto:64 analog)."""

    name: str
    events: int = 0
    seconds: float = 0.0
    rows: int = 0
    bytes: int = 0

    def line(self) -> str:
        parts = [f"{self.name:<28} {self.seconds * 1000:9.1f} ms"
                 f" {self.events:6d} ev"]
        if self.rows:
            parts.append(f"{self.rows:12d} rows")
        if self.bytes:
            parts.append(f"{self.bytes / 1e6:9.1f} MB")
        return "  ".join(parts)


class StatsCollection:
    """Thread-safe per-flow stats registry (prefetch threads report in)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.stages: Dict[str, ComponentStats] = {}

    def stage(self, name: str) -> ComponentStats:
        with self._mu:
            s = self.stages.get(name)
            if s is None:
                s = self.stages[name] = ComponentStats(name)
            return s

    def add(self, name: str, seconds: float = 0.0, rows: int = 0,
            bytes: int = 0, events: int = 1) -> None:
        s = self.stage(name)
        with self._mu:
            s.events += events
            s.seconds += seconds
            s.rows += rows
            s.bytes += bytes

    def report(self) -> str:
        with self._mu:
            stages = sorted(self.stages.values(),
                            key=lambda s: -s.seconds)
        return "\n".join(s.line() for s in stages)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """JSON-ready stage table (bench.py embeds this in BENCH_*.json so
        host-side stage trajectories are trackable across PRs, not just in
        the human-readable stderr tail)."""
        with self._mu:
            return {
                s.name: {"seconds": round(s.seconds, 4),
                         "events": s.events, "rows": s.rows,
                         "bytes": s.bytes}
                for s in sorted(self.stages.values(),
                                key=lambda s: -s.seconds)
            }


# module-level switch: None = disabled (the common, zero-overhead case)
_active: Optional[StatsCollection] = None

# per-query overlay: a thread-local collection installed by the session
# for the duration of one statement (query_stats below). The module-level
# _active stays the EXPLAIN ANALYZE / bench switch — visible to prefetch
# threads — while the overlay gives every statement its own attribution
# without turning the global on. A scan's prefetch thread installs its
# consumer's overlay (query_stats(col)), so pack and transfer time
# attribute to the statement that pulled them.
_tls = threading.local()


def enable() -> StatsCollection:
    """Start collecting into a fresh collection (EXPLAIN ANALYZE mode)."""
    global _active
    _active = StatsCollection()
    return _active


def disable() -> None:
    global _active
    _active = None


def active() -> Optional[StatsCollection]:
    return _active


@contextmanager
def query_stats(col: Optional[StatsCollection] = None):
    """Install a per-query StatsCollection on this thread for the
    statement's duration (a fresh one, or `col`: a producer thread
    reporting into its consumer's statement); yields the collection
    (read it AFTER the body for the statement's operator breakdown).
    Nests, restoring the outer overlay."""
    col = StatsCollection() if col is None else col
    prev = getattr(_tls, "col", None)
    _tls.col = col
    try:
        yield col
    finally:
        _tls.col = prev


def query_active() -> Optional[StatsCollection]:
    return getattr(_tls, "col", None)


def add(name: str, **kw) -> None:
    a = _active
    if a is not None:
        a.add(name, **kw)
    q = getattr(_tls, "col", None)
    if q is not None and q is not a:
        q.add(name, **kw)


@contextmanager
def timed(name: str, rows: int = 0, bytes: int = 0):
    a = _active
    q = getattr(_tls, "col", None)
    if a is None and q is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if a is not None:
            a.add(name, seconds=dt, rows=rows, bytes=bytes)
        if q is not None and q is not a:
            q.add(name, seconds=dt, rows=rows, bytes=bytes)


# ------------------------------------------------- per-operator breakdown

# stage prefixes that represent query execution work (device dispatch,
# readback, host fold) — the device-ms column of EXPLAIN ANALYZE's
# operator table and the device_seconds rolled into sqlstats. Compile
# and background stages are excluded: they are amortized, not per-query
# execution cost.
_EXEC_PREFIXES = ("scan", "agg", "join", "sort", "fused", "serving",
                  "dist", "vector", "spill", "sql")
_NON_EXEC_STAGES = ("compile", "vault", "image_build", "prime",
                    "prewarm")


def _is_exec_stage(name: str) -> bool:
    head = name.split(".", 1)[0]
    if head not in _EXEC_PREFIXES:
        return False
    return not any(t in name for t in _NON_EXEC_STAGES)


def operator_breakdown(col: Optional[StatsCollection]) -> list:
    """Group a collection's stages by operator family (the prefix before
    the first '.') -> [{operator, device_ms, rows, bytes, events}],
    sorted by device_ms desc. Only execution stages count toward
    device_ms; compile/prewarm stages are listed under their family's
    other_ms so the rendering stays honest about total time."""
    if col is None:
        return []
    with col._mu:
        stages = list(col.stages.values())
    groups: Dict[str, Dict[str, float]] = {}
    for s in stages:
        fam = s.name.split(".", 1)[0]
        g = groups.setdefault(fam, {"operator": fam, "device_ms": 0.0,
                                    "other_ms": 0.0, "rows": 0,
                                    "bytes": 0, "events": 0})
        if _is_exec_stage(s.name):
            g["device_ms"] += s.seconds * 1e3
        else:
            g["other_ms"] += s.seconds * 1e3
        g["rows"] += s.rows
        g["bytes"] += s.bytes
        g["events"] += s.events
    out = sorted(groups.values(),
                 key=lambda g: (-g["device_ms"], -g["other_ms"]))
    for g in out:
        g["device_ms"] = round(g["device_ms"], 3)
        g["other_ms"] = round(g["other_ms"], 3)
    return out


def operator_device(col: Optional[StatsCollection]) -> Dict[str, float]:
    """Per-operator-family execution seconds (the measured-cost signal
    sqlstats accumulates per fingerprint and EXPLAIN's tier table shows:
    sql/plan_compile.py compile_plan)."""
    if col is None:
        return {}
    out: Dict[str, float] = {}
    with col._mu:
        for s in col.stages.values():
            if not _is_exec_stage(s.name):
                continue
            fam = s.name.split(".", 1)[0]
            out[fam] = out.get(fam, 0.0) + s.seconds
    return out


def device_seconds(col: Optional[StatsCollection]) -> float:
    """Total execution-stage seconds in a collection (the sqlstats
    device-time roll-up)."""
    if col is None:
        return 0.0
    with col._mu:
        return sum(s.seconds for s in col.stages.values()
                   if _is_exec_stage(s.name))


def bytes_scanned(col: Optional[StatsCollection]) -> int:
    """Total bytes moved by scan stages (the sqlstats cost substrate)."""
    if col is None:
        return 0
    with col._mu:
        return sum(s.bytes for s in col.stages.values()
                   if s.name.startswith("scan."))


def degradations_seen(col: Optional[StatsCollection]) -> bool:
    """Did the resilience ladder degrade during this collection's scope?
    (insight signal)"""
    if col is None:
        return False
    with col._mu:
        return any(s.name.startswith("resilience.degrade")
                   for s in col.stages.values())
