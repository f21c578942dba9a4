"""crdb_internal virtual tables: live registries queryable through SQL.

Reference: pkg/sql/crdb_internal.go — the `crdb_internal` schema's
tables are not stored; each materializes on read from an in-memory
registry (sessions, queries, jobs, statement stats, ...) and then
composes with the whole relational surface. Same contract here: a
`VirtualCatalog` wraps any Catalog and intercepts names under
`crdb_internal.`, materializing provider rows into ordinary coldata
chunks, so WHERE / ORDER BY / LIMIT / aggregates run through the
existing plan path unchanged.

Provider contract (ARCHITECTURE.md "Introspection and insights"):
a provider is a zero-arg (or catalog-arg) callable returning
List[dict] rows matching the table's column spec. Rows snapshot ONCE
per VirtualCatalog instance — the wrapper is created per statement, so
bind-time schema (string dictionaries included) and run-time chunks
describe the same instant. `scan_cache_key` returns None for every
virtual table: results must never enter the scan-image cache or the
prepared-plan cache (both keyed on data identity, which a live registry
does not have).

The status HTTP endpoints and SHOW QUERIES/SESSIONS/JOBS are thin views
over the same `provider_rows()` entry point.

Counterpart of cockroach_tpu/sql/vtable.py: `TABLES` (the same tables
and columns), `provider_rows`, `VirtualCatalog` and `wants_virtual`.
Departures, each waiting for its ROADMAP.md queue 1 item:
  - every provider reads this process's registries: the status plane's
    cluster fan-in (server/nodestatus.py) waits for 8e, so
    `node_inflight_traces` reads the local tracer and `node_id` is the
    query registry's;
  - `ranges` returns no rows, as the JAX provider does with no cluster
    (the kv cluster is not ported);
  - `serving_batches` raises a BindError naming 8d (the serving queue);
  - `jobs` lists the catalog's jobs registry, then one row for each
    materialized view (kind "matview:<name>", its folds and re-scans).
A virtual table's `scan_cache_key` is None, so its scan is never
resident, never cached and never prepared: on CUDA the fused program
over it runs eagerly, with no graph capture (exec/fused.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.coldata.batch import (
    FLOAT, Field, INT, Kind, STRING, Schema,
)
from cockroach_tpu_torch.sql.bind import BindError
from cockroach_tpu_torch.sql.plan import Catalog

PREFIX = "crdb_internal."


def local_node_id() -> int:
    """This process's node id: the default query registry's (the status
    plane that may override it is item 8e)."""
    from cockroach_tpu_torch.server.registry import default_query_registry

    return default_query_registry().node_id


# ------------------------------------------------------------- providers

def _rows_node_metrics(base=None) -> List[dict]:
    from cockroach_tpu_torch.util.metric import default_registry

    nid = local_node_id()
    rows = []
    for name, m in default_registry().metrics():
        snap = getattr(m, "snapshot", None)
        if snap is not None:  # histogram: count as the scalar value
            s = snap()
            value, kind = float(s["count"]), "histogram"
        else:
            value = float(m.value())
            kind = type(m).__name__.lower().replace("function", "")
        rows.append({"name": name, "kind": kind, "value": value,
                     "help": getattr(m, "help", ""), "node_id": nid})
    return rows


def _rows_cluster_queries(base=None) -> List[dict]:
    from cockroach_tpu_torch.server.registry import default_query_registry

    rows = default_query_registry().queries()
    for r in rows:  # the qid's node prefix is authoritative
        r["node_id"] = r["query_id"] >> 32
    return rows


def _rows_cluster_sessions(base=None) -> List[dict]:
    from cockroach_tpu_torch.server.registry import default_query_registry

    reg = default_query_registry()
    rows = reg.sessions()
    for r in rows:
        r["node_id"] = reg.node_id
    return rows


def _rows_statement_statistics(base=None) -> List[dict]:
    from cockroach_tpu_torch.sql.sqlstats import default_sqlstats

    rows = []
    for r in default_sqlstats().top(n=1000):
        r = dict(r)
        r.pop("sessions", None)  # set-valued; not a column
        # `count` is a SQL keyword; expose it under a selectable name
        r["exec_count"] = r.pop("count", 0)
        rows.append(r)
    return rows


def _rows_jobs(base=None) -> List[dict]:
    reg = getattr(base, "_jobs_registry", None) if base is not None \
        else None
    mgr = getattr(base, "_matview_mgr", None) if base is not None \
        else None
    rows: List[dict] = []
    now_wall = None
    if reg is not None:
        now_wall = reg.store.clock.now().wall
        for j in reg.list_jobs():
            prog = getattr(j, "progress", None)
            prog = prog if isinstance(prog, dict) else {}
            frontier = prog.get("frontier")
            rows.append({
                "job_id": int(j.id),
                "node_id": int(j.id) >> 32,
                "kind": j.kind,
                "state": j.state,
                "progress": (float(prog["done"]) / float(prog["total"])
                             if prog.get("total") else
                             float(prog.get("fraction", 0.0) or 0.0)),
                "error": str(getattr(j, "error", "") or ""),
                # changefeed lag in wall units, same convention as the
                # changefeed_frontier_lag_ns gauge — in-band, per job
                "frontier_lag": (float(max(0, now_wall - frontier[0]))
                                 if frontier else None),
                "folds": None,
                "rescans": None,
            })
    if mgr is not None:
        # matviews are standing jobs over the changefeed source; their
        # fold/re-scan counters surface as job rows so lag and refresh
        # behavior are queryable in-band, not just process gauges
        if now_wall is None:
            store = getattr(base, "store", None)
            now_wall = (store.clock.now().wall
                        if store is not None else 0)
        for name, rep in sorted(mgr.report().items()):
            frontier = rep.get("frontier") or [0, 0]
            rows.append({
                "job_id": 0,
                "node_id": local_node_id(),
                "kind": "matview:" + name,
                "state": "running",
                "progress": 0.0,
                "error": "",
                "frontier_lag": float(max(0, now_wall - frontier[0])),
                "folds": int(rep.get("folds", 0)),
                "rescans": int(rep.get("rescans", 0)),
            })
    return rows


def _rows_serving_batches(base=None) -> List[dict]:
    raise BindError("crdb_internal.serving_batches is not ported yet "
                    "(ROADMAP.md queue 1, item 8d: the serving queue)")


def _rows_inflight_traces(base=None) -> List[dict]:
    from cockroach_tpu_torch.util.tracing import tracer

    src = tracer().inflight_summaries()
    local = local_node_id()
    rows = []
    for r in src:
        rows.append({
            "name": r["name"],
            "trace_id": int(r["trace_id"]),
            "span_id": int(r["span_id"]),
            "parent_id": (None if r["parent_id"] is None
                          else int(r["parent_id"])),
            "node_id": int(r["node_id"]) if r.get("node_id") is not None
            else local,
            "elapsed_ms": float(r["elapsed_ms"]),
            "events": int(r["events"]),
        })
    return rows


def _rows_execution_insights(base=None) -> List[dict]:
    from cockroach_tpu_torch.sql.insights import default_insights

    rows = []
    for r in default_insights().insights():
        r = dict(r)
        r["node_id"] = int(r.get("query_id", 0)) >> 32
        rows.append(r)
    return rows


def _rows_ranges(base=None) -> List[dict]:
    """Per-replica load rows of a cluster-backed catalog: the JAX
    provider's answer without a cluster, which the port does not have,
    is no rows."""
    cluster = getattr(base, "cluster", None) if base is not None \
        else None
    if cluster is None or not hasattr(cluster, "hot_ranges"):
        return []
    return cluster.hot_ranges()


# table name -> (column spec, provider). Column spec: (name, type,
# nullable). INT carries ids/counts/unix-seconds (float32 would mangle
# epoch timestamps); FLOAT carries latencies/ratios.
TABLES: Dict[str, Tuple[List[Tuple[str, object, bool]], object]] = {
    "node_metrics": (
        [("name", STRING, False), ("kind", STRING, False),
         ("value", FLOAT, False), ("help", STRING, False),
         ("node_id", INT, False)],
        _rows_node_metrics),
    "cluster_queries": (
        [("query_id", INT, False), ("node_id", INT, False),
         ("session_id", INT, False),
         ("phase", STRING, False), ("start_unix", INT, False),
         ("elapsed_s", FLOAT, False), ("fingerprint", STRING, False),
         ("sql", STRING, False)],
        _rows_cluster_queries),
    "cluster_sessions": (
        [("session_id", INT, False), ("node_id", INT, False),
         ("start_unix", INT, False),
         ("statements", INT, False), ("active_queries", INT, False)],
        _rows_cluster_sessions),
    "statement_statistics": (
        [("fingerprint", STRING, False), ("exec_count", INT, False),
         ("total_seconds", FLOAT, False), ("mean_seconds", FLOAT, False),
         ("max_seconds", FLOAT, False), ("rows_returned", INT, False),
         ("errors", INT, False), ("device_seconds", FLOAT, False),
         ("bytes_scanned", INT, False)],
        _rows_statement_statistics),
    "jobs": (
        [("job_id", INT, False), ("node_id", INT, False),
         ("kind", STRING, False),
         ("state", STRING, False), ("progress", FLOAT, False),
         ("error", STRING, False),
         ("frontier_lag", FLOAT, True), ("folds", INT, True),
         ("rescans", INT, True)],
        _rows_jobs),
    "serving_batches": (
        [("batch_class", STRING, False),
         ("batched_dispatch_total", INT, False),
         ("coalesced_statements", INT, False),
         ("fallbacks", INT, False), ("occupancy", FLOAT, False),
         ("coalesce_window_ms", FLOAT, False),
         ("ewma_interarrival_ms", FLOAT, False)],
        _rows_serving_batches),
    "node_inflight_traces": (
        [("name", STRING, False), ("trace_id", INT, False),
         ("span_id", INT, False), ("parent_id", INT, True),
         ("node_id", INT, False),
         ("elapsed_ms", FLOAT, False), ("events", INT, False)],
        _rows_inflight_traces),
    "cluster_execution_insights": (
        [("fingerprint", STRING, False), ("kinds", STRING, False),
         ("elapsed_s", FLOAT, False), ("baseline_mean_s", FLOAT, False),
         ("session_id", INT, False), ("query_id", INT, False),
         ("node_id", INT, False),
         ("at_unix", INT, False), ("detail", STRING, False)],
        _rows_execution_insights),
    "ranges": (
        [("range_id", INT, False), ("node_id", INT, False),
         ("leaseholder", INT, False), ("start_key", STRING, False),
         ("end_key", STRING, False), ("qps", FLOAT, False),
         ("wps", FLOAT, False), ("queries", INT, False),
         ("keys_read", INT, False), ("bytes_read", INT, False),
         ("keys_written", INT, False), ("bytes_written", INT, False),
         ("follower_reads", INT, False), ("raft_appends", INT, False),
         ("snapshots", INT, False), ("term_churn", INT, False)],
        _rows_ranges),
}


def provider_rows(table: str, catalog=None) -> List[dict]:
    """Raw provider rows for a virtual table (`table` with or without
    the crdb_internal. prefix) — the entry point SHOW statements and the
    status HTTP endpoints share with the SQL path."""
    name = table[len(PREFIX):] if table.startswith(PREFIX) else table
    spec = TABLES.get(name)
    if spec is None:
        raise KeyError(f"unknown virtual table crdb_internal.{name}")
    return spec[1](catalog)


def _normalize(value, ty):
    if value is None:
        return None
    if ty is STRING:
        return str(value)
    if ty.kind is Kind.INT:
        return int(value)
    return float(value)


def _materialize(name: str, rows: List[dict]) -> Tuple[
        Schema, Dict[str, np.ndarray]]:
    """Provider rows -> (Schema with dictionaries, numpy column dict
    including __valid lanes for nullable fields)."""
    colspec, _ = TABLES[name]
    fields: List[Field] = []
    dicts: Dict[str, np.ndarray] = {}
    data: Dict[str, np.ndarray] = {}
    for col, ty, nullable in colspec:
        key = col
        vals = [_normalize(r.get(col), ty) for r in rows]
        valid = np.asarray([v is not None for v in vals], dtype=np.uint8)
        if ty is STRING:
            ref = f"crdb_internal.{name}.{col}"
            uniq = sorted({v for v in vals if v is not None})
            code = {s: i for i, s in enumerate(uniq)}
            dicts[ref] = np.asarray(uniq, dtype=object)
            data[key] = np.asarray(
                [code.get(v, 0) for v in vals], dtype=np.int32)
            fields.append(Field(col, ty, dict_ref=ref,
                                nullable=nullable))
        else:
            fill = 0
            arr = np.asarray([fill if v is None else v for v in vals],
                             dtype=(np.int64 if ty.kind is Kind.INT
                                    else np.float32))
            data[key] = arr
            fields.append(Field(col, ty, nullable=nullable))
        if nullable:
            data[key + "__valid"] = valid
    return Schema(fields, dicts), data


class VirtualCatalog(Catalog):
    """Wrap a base Catalog; names under `crdb_internal.` resolve to
    virtual tables, everything else delegates. Create one per statement:
    each instance snapshots a table's rows at most once, so the schema
    the binder saw and the chunks the scan reads agree."""

    def __init__(self, base: Catalog):
        self._base = base
        self._snap: Dict[str, Tuple[Schema, Dict[str, np.ndarray],
                                    int]] = {}

    def __getattr__(self, item):
        # non-protocol surface (store, desc, serving_image_key,
        # _jobs_registry, shared_prepared, ...) passes through so the
        # wrapper is transparent to every layer that duck-types the
        # session catalog
        return getattr(self._base, item)

    def _vt(self, name: str):
        snap = self._snap.get(name)
        if snap is None:
            short = name[len(PREFIX):]
            if short not in TABLES:
                raise KeyError(f"unknown virtual table {name}")
            rows = provider_rows(short, self._base)
            schema, data = _materialize(short, rows)
            snap = self._snap[name] = (schema, data, len(rows))
        return snap

    # --------------------------------------------------- Catalog protocol

    def table_schema(self, name: str) -> Schema:
        if name.startswith(PREFIX):
            return self._vt(name)[0]
        return self._base.table_schema(name)

    def table_chunks(self, name: str, capacity: int, columns=None):
        if not name.startswith(PREFIX):
            return self._base.table_chunks(name, capacity, columns)
        schema, data, n = self._vt(name)
        cols = list(columns) if columns else schema.names()
        keys = []
        for c in cols:
            keys.append(c)
            if schema.field(c).nullable:
                keys.append(c + "__valid")

        def gen():
            if n == 0:
                return
            yield {k: data[k] for k in keys}

        return gen

    def table_rows(self, name: str) -> int:
        if name.startswith(PREFIX):
            return self._vt(name)[2]
        return self._base.table_rows(name)

    def table_pk(self, name: str):
        if name.startswith(PREFIX):
            return None
        return self._base.table_pk(name)

    def table_indexes(self, name: str):
        if name.startswith(PREFIX):
            return {}
        return self._base.table_indexes(name)

    def table_stats(self, name: str):
        if name.startswith(PREFIX):
            return None
        return self._base.table_stats(name)

    def index_chunks(self, name: str, column: str, lo: int, hi: int,
                     capacity: int, columns=None):
        return self._base.index_chunks(name, column, lo, hi, capacity,
                                       columns)

    def scan_cache_key(self, name: str, columns, capacity: int
                       ) -> Optional[tuple]:
        if name.startswith(PREFIX):
            return None  # live rows: never cacheable, never prepared
        return self._base.scan_cache_key(name, columns, capacity)

    def scan_source(self, name: str, columns=None):
        if name.startswith(PREFIX):
            return None
        return self._base.scan_source(name, columns)


def wants_virtual(sql: str) -> bool:
    """Cheap per-statement probe (substring, no parse) for whether the
    statement can touch the virtual schema at any nesting depth."""
    return PREFIX in sql
