"""Per-statement-fingerprint execution statistics.

Reference: pkg/sql/sqlstats — statements are fingerprinted (literals
stripped), and per-fingerprint counts/latencies/row counts power the
statements page and insights. This slice records the same shape
in-process; the placement pass (sql/plan_compile.py) reads it.

The fingerprint map is bounded: `sql.metrics.max_stmt_fingerprints`
(reference: sql.metrics.max_mem_stmt_fingerprints) caps it with LRU
eviction so fingerprint-diverse load (literal-heavy generated SQL that
defeats the lexical fingerprinting) cannot grow it without bound; a
count of evictions makes eviction pressure observable.

Counterpart of cockroach_tpu/sql/sqlstats.py: `fingerprint`, `StmtStats`,
`SQLStats` and `default_sqlstats`, with the LRU cap. An eviction
increments the counter `sqlstats_fingerprints_evicted_total`, as in the
JAX package, and is also counted in exec/stats as the event
`sqlstats.fingerprints_evicted` (its `rows` are the entries evicted).
`crdb_internal.statement_statistics` (sql/vtable.py) reads `top`.
"""

from __future__ import annotations

import functools
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List

from cockroach_tpu_torch.util.settings import Settings

MAX_STMT_FINGERPRINTS = Settings.register(
    "sql.metrics.max_stmt_fingerprints",
    1000,
    "max statement fingerprints retained in sqlstats; least-recently "
    "updated entries are evicted past the cap",
)

_NUM = re.compile(r"\b\d+(\.\d+)?\b")
_STR = re.compile(r"'(?:[^']|'')*'")
_WS = re.compile(r"\s+")


@functools.lru_cache(maxsize=4096)
def fingerprint(sql: str) -> str:
    """Statement text with literals replaced by '_' (the fingerprinting
    the reference does over the AST, done lexically here). Memoized:
    the query registry, sqlstats, and insights each fingerprint every
    statement, and the warm serving path repeats identical text — the
    cache turns three regex passes into one dict hit."""
    s = _STR.sub("'_'", sql)
    s = _NUM.sub("_", s)
    return _WS.sub(" ", s).strip().lower()[:200]


@dataclass
class StmtStats:
    fingerprint: str
    count: int = 0
    total_seconds: float = 0.0
    max_seconds: float = 0.0
    rows_returned: int = 0
    errors: int = 0
    # per-operator attribution roll-up (exec/stats.py device_seconds /
    # bytes_scanned): the per-tenant cost-accounting substrate
    device_seconds: float = 0.0
    bytes_scanned: int = 0
    # per-operator-family device seconds (exec/stats.operator_device):
    # the measured-cost signal the placement pass (sql/cost.py) seeds
    # its per-operator tier decisions from
    op_device: dict = field(default_factory=dict)
    # session ids that ran this fingerprint (capped): concurrent-run
    # traces are attributable to their sessions on /_status/statements
    sessions: set = field(default_factory=set)
    _SESSION_CAP = 64

    def as_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "count": self.count,
            "total_seconds": round(self.total_seconds, 4),
            "mean_seconds": round(self.total_seconds / max(self.count, 1),
                                  4),
            "max_seconds": round(self.max_seconds, 4),
            "rows_returned": self.rows_returned,
            "errors": self.errors,
            "device_seconds": round(self.device_seconds, 4),
            "bytes_scanned": self.bytes_scanned,
            "op_device": {k: round(v, 4)
                          for k, v in sorted(self.op_device.items())},
            "sessions": sorted(self.sessions),
        }


def _evicted_counter():
    from cockroach_tpu_torch.util.metric import default_registry

    return default_registry().counter(
        "sqlstats_fingerprints_evicted_total",
        "sqlstats fingerprint entries evicted by the "
        "sql.metrics.max_stmt_fingerprints LRU cap")


class SQLStats:
    def __init__(self):
        self._mu = threading.Lock()
        self._stats: "OrderedDict[str, StmtStats]" = OrderedDict()

    def record(self, sql: str, seconds: float, rows: int = 0,
               error: bool = False,
               session_id: "int | None" = None,
               device_s: float = 0.0,
               bytes_scanned: int = 0,
               op_device: "dict | None" = None) -> None:
        fp = fingerprint(sql)
        cap = max(int(Settings().get(MAX_STMT_FINGERPRINTS)), 1)
        evicted = 0
        with self._mu:
            st = self._stats.get(fp)
            if st is None:
                st = self._stats[fp] = StmtStats(fp)
            st.count += 1
            st.total_seconds += seconds
            st.max_seconds = max(st.max_seconds, seconds)
            st.rows_returned += rows
            st.errors += int(error)
            st.device_seconds += device_s
            st.bytes_scanned += bytes_scanned
            if op_device:
                for fam, s in op_device.items():
                    st.op_device[fam] = st.op_device.get(fam, 0.0) + s
            if session_id is not None and \
                    len(st.sessions) < StmtStats._SESSION_CAP:
                st.sessions.add(session_id)
            self._stats.move_to_end(fp)
            while len(self._stats) > cap:
                self._stats.popitem(last=False)
                evicted += 1
        if evicted:
            from cockroach_tpu_torch.exec import stats as _stats

            _evicted_counter().inc(evicted)
            _stats.add("sqlstats.fingerprints_evicted", rows=evicted)

    def get(self, sql_or_fp: str) -> "dict | None":
        """Snapshot for one fingerprint (accepts raw SQL or an already
        computed fingerprint) — the placement pass's measured-cost read;
        does NOT bump LRU recency (reads are not usage)."""
        with self._mu:
            st = self._stats.get(sql_or_fp)
            if st is None:
                st = self._stats.get(fingerprint(sql_or_fp))
            return st.as_dict() if st is not None else None

    def top(self, n: int = 50) -> List[dict]:
        with self._mu:
            stats = sorted(self._stats.values(),
                           key=lambda s: -s.total_seconds)
        return [s.as_dict() for s in stats[:n]]

    def reset(self) -> None:
        with self._mu:
            self._stats.clear()


_default = SQLStats()


def default_sqlstats() -> SQLStats:
    return _default
