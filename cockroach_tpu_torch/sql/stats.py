"""Table statistics the planner reads: sampled per-column distinct counts,
bounds and equi-depth histograms, and selectivity estimates from them.

Counterpart of cockroach_tpu/sql/stats.py (numpy only): ColumnStats,
TableStats with its byte encoding, sample_stats, conjunct_selectivity
and estimate_rows, and the statistics persisted in a system keyspace of
an MVCC store (stats_key, save_stats, load_stats), byte for byte the
JAX package's.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.ops.expr import BoolOp, Cmp, Col, InList, Like, Lit
from cockroach_tpu_torch.util.hlc import Timestamp

STATS_TABLE = 0xFFE1  # system.table_statistics keyspace
HIST_BUCKETS = 16
SAMPLE_ROWS = 1 << 16


@dataclass
class ColumnStats:
    distinct: int
    null_frac: float
    lo: Optional[int] = None          # int-typed columns only
    hi: Optional[int] = None
    histogram: List[int] = field(default_factory=list)  # bucket uppers


@dataclass
class TableStats:
    row_count: int
    columns: Dict[str, ColumnStats] = field(default_factory=dict)

    def encode(self) -> bytes:
        return json.dumps({
            "row_count": self.row_count,
            "columns": {n: vars(c) for n, c in self.columns.items()},
        }, sort_keys=True).encode()

    @staticmethod
    def decode(b: bytes) -> "TableStats":
        d = json.loads(b.decode())
        return TableStats(d["row_count"], {
            n: ColumnStats(**c) for n, c in d["columns"].items()})


def stats_key(table_id: int) -> bytes:
    return struct.pack(">HQ", STATS_TABLE, table_id)


def sample_stats(chunks) -> TableStats:
    """Build TableStats from a chunk stream. Histograms and distinct
    counts come from a strided per-chunk sample of up to SAMPLE_ROWS rows;
    integer bounds are exact over every row of the stream."""
    cols: Dict[str, List[np.ndarray]] = {}
    bounds: Dict[str, Tuple[int, int]] = {}
    sampled = 0
    total = 0
    for c in chunks:
        n = len(next(iter(c.values())))
        total += n
        take = min(n, max(SAMPLE_ROWS // 16,
                          SAMPLE_ROWS - sampled)) if sampled \
            < SAMPLE_ROWS else 0
        for name, arr in c.items():
            a = np.asarray(arr)
            if np.issubdtype(a.dtype, np.integer) and len(a):
                lo, hi = int(a.min()), int(a.max())
                if name in bounds:
                    plo, phi = bounds[name]
                    bounds[name] = (min(plo, lo), max(phi, hi))
                else:
                    bounds[name] = (lo, hi)
            if take:
                stride = max(1, n // take)
                cols.setdefault(name, []).append(a[::stride][:take])
        if take:
            sampled += min(take, n)
    out = TableStats(total)
    scale = total / max(sampled, 1)
    for name, parts in cols.items():
        arr = np.concatenate(parts)
        distinct_sample = len(np.unique(arr))
        # key-like in the sample (every sampled value unique): assume the
        # distinct count grows with the table; small domains stay as
        # measured
        if distinct_sample >= 0.95 * len(arr):
            distinct = int(distinct_sample * scale)
        else:
            distinct = distinct_sample
        cs = ColumnStats(max(distinct, 1), 0.0)
        if name in bounds:
            cs.lo, cs.hi = bounds[name]
            if len(arr):
                qs = np.quantile(
                    arr, np.linspace(0, 1, HIST_BUCKETS + 1)[1:])
                cs.histogram = [int(q) for q in qs]
        out.columns[name] = cs
    return out


def save_stats(store, table_id: int, st: TableStats) -> None:
    store.engine.put(stats_key(table_id), store.clock.now(), st.encode())


def load_stats(store, table_id: int) -> Optional[TableStats]:
    hit = store.engine.get(stats_key(table_id), Timestamp.MAX)
    if hit is None or not hit[0]:
        return None
    return TableStats.decode(hit[0])


# ------------------------------------------------------------ selectivity --

_DEFAULT_SEL = 0.2    # the flat discount when there are no statistics
_MIN_SEL = 1e-4


def _range_frac(cs: ColumnStats, lo: float, hi: float) -> float:
    """Fraction of rows in [lo, hi] from the equi-depth histogram."""
    if cs.lo is None or cs.hi is None or cs.hi < cs.lo:
        return _DEFAULT_SEL
    if hi < cs.lo or lo > cs.hi:
        return 0.0
    if not cs.histogram:
        span = max(cs.hi - cs.lo, 1)
        return max(0.0, min(1.0, (min(hi, cs.hi) - max(lo, cs.lo) + 1)
                            / span))
    uppers = cs.histogram
    prev = cs.lo
    frac = 0.0
    per_bucket = 1.0 / len(uppers)
    for up in uppers:
        blo, bhi = prev, up
        if bhi >= lo and blo <= hi and bhi >= blo:
            width = max(bhi - blo, 1)
            overlap = min(hi, bhi) - max(lo, blo) + 1
            frac += per_bucket * max(0.0, min(1.0, overlap / width))
        prev = up
    return max(0.0, min(1.0, frac))


def conjunct_selectivity(e, stats: Optional[TableStats]) -> float:
    """Estimated fraction of rows satisfying one conjunct."""
    if isinstance(e, BoolOp):
        if e.op == "and":
            out = 1.0
            for part in e.args:
                out *= conjunct_selectivity(part, stats)
            return out
        if e.op == "or":
            out = 0.0
            for part in e.args:
                out = out + conjunct_selectivity(part, stats) * (1 - out)
            return out
    if stats is None:
        return _DEFAULT_SEL
    if isinstance(e, Cmp):
        if isinstance(e.left, Col) and isinstance(e.right, Lit):
            col, lit, op = e.left.name, e.right.value, e.op
        elif isinstance(e.right, Col) and isinstance(e.left, Lit):
            col, lit = e.right.name, e.left.value
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(
                e.op, e.op)
        else:
            return _DEFAULT_SEL
        cs = stats.columns.get(col)
        if cs is None or not isinstance(lit, (int, float, np.integer)):
            return _DEFAULT_SEL
        v = float(lit)
        if op in ("=", "=="):
            return max(1.0 / cs.distinct, _MIN_SEL)
        if op in ("!=", "<>"):
            return 1.0 - max(1.0 / cs.distinct, _MIN_SEL)
        if op == "<":
            return _range_frac(cs, -float("inf"), v - 1)
        if op == "<=":
            return _range_frac(cs, -float("inf"), v)
        if op == ">":
            return _range_frac(cs, v + 1, float("inf"))
        if op == ">=":
            return _range_frac(cs, v, float("inf"))
        return _DEFAULT_SEL
    if isinstance(e, InList):
        cs = (stats.columns.get(e.arg.name)
              if isinstance(e.arg, Col) else None)
        if cs is None:
            return _DEFAULT_SEL
        return min(1.0, len(e.values) / cs.distinct)
    if isinstance(e, Like):
        return 0.1
    return _DEFAULT_SEL


def estimate_rows(stats: Optional[TableStats], base_rows: int,
                  filters) -> float:
    """Cardinality: base rows x the product of the conjuncts'
    selectivities (independence assumption)."""
    est = float(stats.row_count if stats is not None else base_rows)
    for e in filters:
        est *= conjunct_selectivity(e, stats)
    return max(est, 1.0)
