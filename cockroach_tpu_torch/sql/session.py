"""Session: statement dispatch and session variables over a read-only
catalog.

Counterpart of cockroach_tpu/sql/session.py's `Session`, `SQLError` and
`map_execution_error`, for a read-only `Catalog` (the TPC-H catalog):
SELECT and EXPLAIN [ANALYZE] run through sql/explain.py
`execute_with_plan`; SET and SHOW read and write the session variables;
every DDL/DML statement raises the JAX package's read-only message. Each
statement records into sqlstats (sql/sqlstats.py), and an engine error
is mapped to its SQLSTATE.

A session's scans are resident (sql/plan_compile.py compile_plan): a
table's image, once made, stays in the scan-image cache, as the JAX
package's storage-backed session keeps its tables' device images. A
SELECT's built operator tree is kept in a prepared cache keyed on the
exact text and validated on every hit against each scanned table's
`scan_cache_key`; a hit counts `sql.prepared_hit` and collects the kept
tree, which on CUDA is one replay of its CUDA graph. The JAX session
keeps prepared entries only over its storage-backed catalog; the TPC-H
catalog's key is a pure function of the generator's scale factor and
seed, so the port keeps them over it too.

Not ported yet: the storage-backed `SessionCatalog`, transactions,
DDL/DML, materialized views, changefeeds, the serving queue (ROADMAP.md
queue 1, items 6 and 8), and the query registry, admission, cancellation
and insights seams around `execute` (item 8), with their session
variables (`admission_slots`, `admission_priority`,
`statement_timeout`).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.sql.bind import BindError
from cockroach_tpu_torch.sql.plan import Catalog
from cockroach_tpu_torch.util.settings import Settings


class SQLError(Exception):
    """An execution error carrying a PostgreSQL SQLSTATE code, so a
    client can branch on the class (40001 -> client retry loop, 53xxx ->
    resource alarm) instead of string-matching Python tracebacks."""

    def __init__(self, pgcode: str, msg: str):
        super().__init__(msg)
        self.pgcode = pgcode


def map_execution_error(e: BaseException) -> Optional[SQLError]:
    """Translate engine-internal failures to SQL errors: memory-budget
    trips become 53200 out_of_memory; an exhausted restart budget
    becomes 40001 serialization_failure (the statement is safe for the
    client to retry). Anything else keeps its Python identity (BindError
    et al. are already user-facing). The port's retry loop re-raises its
    last error where the JAX package's raises RetriesExhausted, and the
    cancellation seam (57014) waits for util/cancel.py."""
    from cockroach_tpu_torch.exec.operators import FlowRestart
    from cockroach_tpu_torch.util.mon import BudgetExceededError

    if isinstance(e, BudgetExceededError):
        return SQLError("53200", f"out of memory: {e}")
    if isinstance(e, FlowRestart):
        return SQLError(
            "40001",
            f"restart statement: flow restart budget exhausted ({e})")
    return None


class _Prepared:
    """A cached SELECT: the built operator tree, its output schema, the
    per-table scan-cache keys the plan was built against (the validity
    check) and the capacity those keys were computed at."""

    __slots__ = ("op", "schema", "vkeys", "capacity")

    def __init__(self, op, schema, vkeys: Dict[str, tuple],
                 capacity: int):
        self.op = op
        self.schema = schema
        self.vkeys = vkeys
        self.capacity = capacity


# DDL/DML: statements a read-only catalog cannot run
_WRITES = (P.CreateTable, P.DropTable, P.CreateIndex, P.AlterTable,
           P.AnalyzeStmt, P.Insert, P.Update, P.Delete,
           P.CreateChangefeed, P.StreamChangefeed, P.CreateMatView,
           P.DropMatView, P.RefreshMatView, P.JobControl)


class Session:
    """One SQL session: statement dispatch + session vars. Statements run
    on `device` (CUDA unless the caller passes one)."""

    # session var -> cluster-setting key (None = session-local only).
    # `pallas` names the hand-kernel switch, the port's sql.gpu.kernels;
    # `vectorize` is auto|gpu|cpu: cpu places flows on the host; gpu is
    # an alias of auto, which runs them on the session's device (the port
    # has no CPU placement for auto to choose; sql/cost.py).
    _VARS = {
        "exact_arithmetic": "sql.tpu.exact_arithmetic",
        "pallas": "sql.gpu.kernels",
        "workmem": "sql.distsql.temp_storage.workmem",
        "vectorize": None,
    }
    _VECTORIZE = ("auto", "gpu", "cpu")

    PREPARED_CACHE_ENTRIES = 32

    def __init__(self, catalog: Catalog, capacity: int = 1 << 14,
                 device=None):
        self.catalog = catalog
        self.capacity = capacity
        self.device = device
        self.vars: Dict[str, object] = {"vectorize": "auto"}
        # prepared-statement cache: EXACT SQL text -> _Prepared. Keyed on
        # the text, NOT sqlstats.fingerprint — the fingerprint strips
        # literals, and two statements differing only in literals need
        # different plans.
        self._prepared: "OrderedDict[str, _Prepared]" = OrderedDict()
        self._prepared_mu = threading.Lock()

    # ---------------------------------------------------------- execute --

    def execute(self, sql: str) -> Tuple[str, object, object]:
        """-> (kind, payload, schema) like explain.execute_with_plan, plus
        kind 'ok' (SET; payload = tag string). Every statement records
        into sqlstats under a per-query stats overlay, which attributes
        its execution seconds to its fingerprint."""
        from cockroach_tpu_torch.exec import stats as _stats
        from cockroach_tpu_torch.sql.sqlstats import default_sqlstats

        t0 = time.perf_counter()
        with _stats.query_stats() as qcol:
            try:
                kind, payload, schema = self._execute(sql)
            except Exception as e:
                default_sqlstats().record(
                    sql, time.perf_counter() - t0, error=True,
                    device_s=_stats.device_seconds(qcol),
                    bytes_scanned=_stats.bytes_scanned(qcol))
                mapped = map_execution_error(e)
                if mapped is not None:
                    raise mapped from e
                raise
            rows = 0
            if kind == "rows" and payload:
                first = next(iter(payload.values()), None)
                rows = len(first) if first is not None else 0
            default_sqlstats().record(
                sql, time.perf_counter() - t0, rows=rows,
                device_s=_stats.device_seconds(qcol),
                bytes_scanned=_stats.bytes_scanned(qcol),
                op_device=_stats.operator_device(qcol))
        return kind, payload, schema

    # ------------------------------------------------ prepared statements

    def _prepared_lookup(self, sql: str) -> Optional[_Prepared]:
        """The prepared entry for this exact SQL text, IF every scanned
        table's current scan-cache key still equals the one the plan was
        built against."""
        with self._prepared_mu:
            prep = self._prepared.get(sql)
        if prep is None:
            return None
        for tname, vkey in prep.vkeys.items():
            try:
                cur = self.catalog.scan_cache_key(tname, None,
                                                  prep.capacity)
            except Exception:  # noqa: BLE001 — e.g. table dropped
                cur = None
            if cur != vkey:
                with self._prepared_mu:
                    self._prepared.pop(sql, None)
                return None
        with self._prepared_mu:
            if sql in self._prepared:
                self._prepared.move_to_end(sql)
        return prep

    def _prepared_store(self, sql: str, sunk) -> None:
        """Cache the built operator tree when it is safely re-runnable:
        every scan carries a cache key, and every scanned table vouches
        for its content with a scan-cache key."""
        from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators
        from cockroach_tpu_torch.sql.plan import Scan as _Scan, _walk_plan

        op = sunk.get("op") if isinstance(sunk, dict) else None
        if op is None:
            return
        for s in walk_operators(op):
            if isinstance(s, ScanOp) and s.cache_key is None:
                return
        vkeys: Dict[str, tuple] = {}
        for t in {n.table for n in _walk_plan(sunk["plan"])
                  if isinstance(n, _Scan)}:
            try:
                k = self.catalog.scan_cache_key(t, None, self.capacity)
            except Exception:  # noqa: BLE001
                return
            if k is None:
                return
            vkeys[t] = k
        with self._prepared_mu:
            self._prepared[sql] = _Prepared(op, op.schema, vkeys,
                                            self.capacity)
            self._prepared.move_to_end(sql)
            while len(self._prepared) > self.PREPARED_CACHE_ENTRIES:
                self._prepared.popitem(last=False)

    def _execute(self, sql: str) -> Tuple[str, object, object]:
        # warm-path short-circuit BEFORE the parse: a prepared hit needs
        # no ast at all (only SELECTs are ever stored, and the entry was
        # validated against the tables' cache keys)
        prep = self._prepared_lookup(sql)
        if prep is not None:
            from cockroach_tpu_torch.exec import collect, stats

            stats.add("sql.prepared_hit")
            return "rows", collect(prep.op, device=self.device,
                                   backend=self.vars["vectorize"]
                                   ), prep.schema
        ast = P.parse(sql)
        if isinstance(ast, P.SetVar):
            # settings can change plans wholesale: drop every prepared
            # entry
            with self._prepared_mu:
                self._prepared.clear()
        if isinstance(ast, (P.SelectStmt, P.ExplainStmt)):
            from cockroach_tpu_torch.sql.explain import execute_with_plan

            setting = self.vars["vectorize"]
            if isinstance(ast, P.SelectStmt):
                sink: List[object] = []
                out = execute_with_plan(sql, self.catalog, self.capacity,
                                        ast=ast, op_sink=sink,
                                        device=self.device,
                                        setting=setting, resident=True)
                if sink:
                    self._prepared_store(sql, sink[0])
                return out
            return execute_with_plan(sql, self.catalog, self.capacity,
                                     ast=ast, device=self.device,
                                     setting=setting, resident=True)
        if isinstance(ast, P.SetVar):
            return self._set_var(ast)
        if isinstance(ast, P.ShowVar):
            name = ast.name
            if name not in self._VARS:
                raise BindError(f"unknown session variable {name!r}")
            return "rows", {name: np.asarray([str(self._get_var(name))],
                                             dtype=object)}, None
        if isinstance(ast, _WRITES):
            raise BindError("this catalog is read-only (DDL/DML need a "
                            "storage-backed session)")
        raise BindError(f"unsupported statement {type(ast).__name__}")

    # ------------------------------------------------------------- vars --

    def _get_var(self, name: str):
        key = self._VARS[name]
        if key is None:
            return self.vars.get(name)
        return Settings().get(key)

    def _set_var(self, ast: P.SetVar):
        if ast.name not in self._VARS:
            raise BindError(f"unknown session variable {ast.name!r}")
        value = ast.value
        if ast.name not in ("pallas", "vectorize"):  # string-valued vars
            if value in ("on", "true"):
                value = True
            elif value in ("off", "false"):
                value = False
        if ast.name == "vectorize" and value not in self._VECTORIZE:
            raise BindError(f"vectorize must be one of "
                            f"{', '.join(self._VECTORIZE)}, not {value!r}")
        key = self._VARS[ast.name]
        if key is None:
            self.vars[ast.name] = value
        else:
            Settings().set(key, value)
        return "ok", f"SET {ast.name}", None
