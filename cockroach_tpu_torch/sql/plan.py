"""Logical query plans and the plan -> operator-tree builder.

Counterpart of cockroach_tpu/sql/plan.py, for the plan nodes Scan,
IndexScan, Filter, Shrink, Project, Join, Aggregate, OrderBy, Limit,
Distinct, Window, Apply (a correlated or scalar subquery) and
VectorTopK (ORDER BY <vector distance> LIMIT k: the exact arm lowers to
a distance projection, a TopKOp with NULLS LAST and a projection that
drops the distance; the ANN arm to VectorANNOp). `normalize` runs the JAX
package's passes in its order: decorrelate, push_filters, use_indexes,
insert_shrinks. `use_indexes` turns a filtered scan whose predicate
bounds an indexed column with literals into an IndexScan under the
same Filter; it changes nothing for a catalog without secondary indexes
(the TPC-H and MVCC catalogs). `decorrelate`
rewrites every Apply into joins and aggregates before the other passes
run, so they and `build` never see one. `insert_shrinks` reads the
catalog's sampled statistics (sql/stats.py) through the cardinality
model `estimate_cardinality`, so the port builds the JAX package's
operator tree, ShrinkOps and their start capacities included. `build`
assembles the port's exec/ operators: a projection that computes
strings, or a decimal division under `sql.tpu.exact_arithmetic`, runs in
the row engine (exec/rowexec.py RowMapOp). `run` compiles a plan
(sql/plan_compile.py) and collects it; distributed execution (`mesh`)
waits for ROADMAP.md queue 1, item 7.

Tables come from a `Catalog`: anything resolving a name to (schema,
chunk stream): `TPCHCatalog` (generated data), `MVCCCatalog` (the
tables of an MVCC store, storage/mvcc.py) or sql/session.py's
`SessionCatalog` (tables that SQL DDL and DML write, with secondary
indexes).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cockroach_tpu_torch.coldata.batch import INT, Kind, Schema
from cockroach_tpu_torch.exec.operators import (
    DistinctOp, HashAggOp, JoinOp, LimitOp, MapOp, Operator, OrderedAggOp,
    ScanOp, ShrinkOp, SortOp, TopKOp, VectorANNOp, WindowOp,
)
from cockroach_tpu_torch.exec.rowexec import (
    EXACT_ARITHMETIC, RowMapOp, has_decimal_division, has_string_compute,
)
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.expr import (
    BoolOp, Cmp, Col, Expr, Lit, VecDistance, VecLit,
)
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.sql.stats import (
    TableStats, conjunct_selectivity, sample_stats,
)
from cockroach_tpu_torch.util.settings import Settings


# ---------------------------------------------------------------- catalog --

class Catalog:
    """Resolve a table name to (Schema, chunks_thunk)."""

    def table_schema(self, name: str) -> Schema:
        raise NotImplementedError

    def table_chunks(self, name: str, capacity: int, columns=None):
        """-> a zero-arg callable yielding column-dict chunks."""
        raise NotImplementedError

    def table_rows(self, name: str) -> int:
        """Row-count estimate."""
        return 1 << 20

    def table_pk(self, name: str) -> Optional[Tuple[str, ...]]:
        """Primary-key columns."""
        return None

    def table_indexes(self, name: str) -> Dict[str, object]:
        """column name -> index metadata for secondary indexes."""
        return {}

    def table_stats(self, name: str) -> Optional[TableStats]:
        """Sampled statistics (sql/stats.py) for the cardinality model,
        or None."""
        return None

    def index_chunks(self, name: str, column: str, lo: int, hi: int,
                     capacity: int, columns=None):
        """Chunk thunk for an IndexScan (index entries in [lo, hi] ->
        primary-row lookups)."""
        raise NotImplementedError

    def scan_cache_key(self, name: str, columns, capacity: int
                       ) -> Optional[tuple]:
        """A content-identity key for the table's packed image (the
        ScanImageCache key, exec/scan_cache.py), or None when the
        catalog cannot vouch that the data behind a name is unchanged."""
        return None

    def scan_source(self, name: str, columns=None):
        """(store, table_id, read ts, column indices) of the MVCC store
        backing this table, or None when the table has no reachable
        store (generated data). The indices map each projected output
        column to its row in the resident value lanes. `build` stamps it
        on the ScanOp as `_mvcc_src`, which distributed ingest reads
        (ROADMAP.md queue 1, item 7)."""
        return None


_TPCH_PKS = {
    "part": ("p_partkey",), "supplier": ("s_suppkey",),
    "customer": ("c_custkey",), "orders": ("o_orderkey",),
    "nation": ("n_nationkey",), "region": ("r_regionkey",),
    "partsupp": ("ps_partkey", "ps_suppkey"),
    "lineitem": ("l_orderkey", "l_linenumber"),
}


class TPCHCatalog(Catalog):
    def __init__(self, gen):
        self.gen = gen
        self._stats_cache: Dict[str, TableStats] = {}

    def table_stats(self, name: str) -> TableStats:
        """A bounded sample: the first 4 chunks of 2^14 rows (drawing the
        whole table would generate it at plan time), with the exact row
        count from the generator. The bounds are the prefix's."""
        if name not in self._stats_cache:
            st = sample_stats(itertools.islice(self.gen.chunks(name, 1 << 14),
                                               4))
            st.row_count = self.gen.num_rows(name)
            self._stats_cache[name] = st
        return self._stats_cache[name]

    def table_schema(self, name: str) -> Schema:
        return self.gen.schema(name)

    def table_rows(self, name: str) -> int:
        return self.gen.num_rows(name)

    def table_pk(self, name: str) -> Optional[Tuple[str, ...]]:
        return _TPCH_PKS.get(name)

    def table_chunks(self, name: str, capacity: int, columns=None):
        gen = self.gen

        def chunks():
            for c in gen.chunks(name, capacity):
                yield ({k: c[k] for k in columns} if columns else c)

        return chunks

    def scan_cache_key(self, name: str, columns, capacity: int
                       ) -> Optional[tuple]:
        # generated data is a pure function of (sf, seed): images are
        # shareable across generator AND catalog instances
        return ("tpch", float(self.gen.sf),
                int(getattr(self.gen, "seed", 0)), name, int(capacity),
                tuple(columns or ()))


class MVCCCatalog(Catalog):
    """Tables served by the MVCC storage layer (storage/mvcc.py): name ->
    (table_id, Schema); scans stream the newest-visible rows through the
    native columnar scanner (or the store's resident tier).

    `ts` (not in the JAX catalog) reads every table at that timestamp
    instead of the clock's at plan time, and then keys no scan image:
    each run of a flow built over it reads the store again."""

    def __init__(self, store, tables: Dict[str, Tuple[int, Schema]],
                 rows: Optional[Dict[str, int]] = None,
                 pks: Optional[Dict[str, Tuple[str, ...]]] = None,
                 stats: Optional[Dict[str, object]] = None,
                 ts=None):
        self.store = store
        self.tables = dict(tables)
        self.rows = dict(rows or {})
        self.pks = dict(pks or {})
        self.stats = dict(stats or {})
        self.ts = ts
        self._scan_ts: Dict[str, object] = {}  # name -> pinned read ts

    def table_stats(self, name: str):
        return self.stats.get(name)

    def table_schema(self, name: str) -> Schema:
        return self.tables[name][1]

    def table_rows(self, name: str) -> int:
        return self.rows.get(name, super().table_rows(name))

    def table_pk(self, name: str) -> Optional[Tuple[str, ...]]:
        return self.pks.get(name)

    def table_chunks(self, name: str, capacity: int, columns=None):
        table_id, schema = self.tables[name]
        all_names = [f.name for f in schema]
        store = self.store
        # the row codec is positional: the scanner always decodes the
        # full field tuple; a pruned column subset is projected
        # host-side after decode
        wanted = list(columns) if columns else all_names
        # snapshot semantics: pin the read timestamp at plan time, the
        # same instant scan_cache_key samples the table's write version —
        # the cached image and the stream it came from can never diverge
        # (a later write is invisible at this ts AND rotates the key)
        ts = self.ts if self.ts is not None else store.clock.now()
        self._scan_ts[name] = ts  # scan_source shares the same snapshot

        def chunks():
            for c in store.scan_chunks(table_id, len(all_names), capacity,
                                       ts=ts, col_names=all_names):
                yield {n: c[n] for n in wanted}

        return chunks

    def scan_cache_key(self, name: str, columns, capacity: int
                       ) -> Optional[tuple]:
        # ScanOp appends the device when it calls the cache
        if self.ts is not None:
            return None
        table_id, schema = self.tables[name]
        cols = tuple(columns) if columns else tuple(f.name for f in schema)
        return self.store.scan_cache_prefix(table_id) + (
            self.store.table_version(table_id), int(capacity), cols)

    def scan_source(self, name: str, columns=None):
        table_id, schema = self.tables[name]
        all_names = [f.name for f in schema]
        wanted = list(columns) if columns else all_names
        ts = self._scan_ts.get(name) or self.store.clock.now()
        return (self.store, table_id, ts,
                tuple(all_names.index(n) for n in wanted))


# ------------------------------------------------------------------ plans --

@dataclass(frozen=True)
class Plan:
    def inputs(self) -> tuple:
        return ()


@dataclass(frozen=True)
class Scan(Plan):
    table: str
    columns: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class IndexScan(Plan):
    """Constrained scan through a secondary index: read the index
    entries in [lo, hi] on `column`, then fetch the matching primary
    rows (the index-join shape, rowexec/joinreader.go). The predicate
    stays in a Filter above: the bound is a superset guarantee."""

    table: str
    column: str
    lo: int
    hi: int          # inclusive
    columns: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class Filter(Plan):
    input: Plan
    predicate: Expr

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Shrink(Plan):
    """Capacity compaction (exec ShrinkOp) above an operator whose live
    output is expected to be a small fraction of its capacity (HAVING
    filters; selective joins)."""

    input: Plan
    start_capacity: int = 1 << 12

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Project(Plan):
    input: Plan
    outputs: Tuple[Tuple[str, Expr], ...]  # complete output column list

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Join(Plan):
    left: Plan
    right: Plan
    left_on: Tuple[str, ...]
    right_on: Tuple[str, ...]
    how: str = "inner"

    def inputs(self):
        return (self.left, self.right)


@dataclass(frozen=True)
class Aggregate(Plan):
    input: Plan
    group_by: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class OrderBy(Plan):
    input: Plan
    keys: Tuple[SortKey, ...]

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Limit(Plan):
    input: Plan
    n: int
    offset: int = 0

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Distinct(Plan):
    input: Plan
    keys: Optional[Tuple[str, ...]] = None

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Window(Plan):
    input: Plan
    partition_by: Tuple[str, ...]
    order_by: Tuple[SortKey, ...]
    specs: Tuple  # ops.window.WindowSpec

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class VectorTopK(Plan):
    """ORDER BY <vector distance> LIMIT k, the vector-search node.
    `ann=False` lowers to the distance projection -> TopK composition
    over existing operators (so the fused tier and the prepared cache
    apply unchanged); `ann=True` (bare scans only: filtered queries stay
    exact) lowers to VectorANNOp, a clustered-index probe with the
    recall/latency `nprobe` dial."""

    input: Plan
    column: str                 # VECTOR column being ranked
    query: Tuple[float, ...]    # bind-time constant query vector
    metric: str                 # "l2" (<->) | "cos" (<=>)
    k: int
    ann: bool = False
    nprobe: int = 4

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Apply(Plan):
    """Correlated subquery: for each `input` row, the subquery `sub`
    restricted to the rows whose `correlation` columns match. Never
    executed directly: `decorrelate()` rewrites every Apply into the
    join + aggregate form before the builder runs.

    - kind="exists"     -> semi Join(input, sub) on the correlation
    - kind="not_exists" -> anti Join(input, sub) on the correlation
    - kind="scalar"     -> Aggregate(sub, group_by=inner correlation
      cols, (scalar,)) + LEFT Join: an empty group surfaces as NULL
      through the left join's validity. An empty correlation (an
      uncorrelated scalar subquery, Q15's shape) joins on a constant
      key: the one aggregate row reaches every input row.
    """

    input: Plan
    sub: Plan
    correlation: Tuple[Tuple[str, str], ...]  # (outer col, inner col)
    kind: str = "exists"        # "exists" | "not_exists" | "scalar"
    scalar: Optional[AggSpec] = None   # kind="scalar": the aggregate

    def inputs(self):
        return (self.input, self.sub)


def _expr_columns(e: Expr, out: set) -> set:
    if isinstance(e, Col):
        out.add(e.name)
    for child in getattr(e, "__dict__", {}).values():
        if isinstance(child, Expr):
            _expr_columns(child, out)
        elif isinstance(child, (tuple, list)):
            for c in child:
                if isinstance(c, Expr):
                    _expr_columns(c, out)
    return out


def _plan_columns(p: Plan, catalog: Catalog) -> List[str]:
    """Output column names of a plan node."""
    if isinstance(p, (Scan, IndexScan)):
        schema = catalog.table_schema(p.table)
        return list(p.columns) if p.columns else schema.names()
    if isinstance(p, Project):
        return [n for n, _ in p.outputs]
    if isinstance(p, (Filter, OrderBy, Limit, Shrink)):
        return _plan_columns(p.input, catalog)
    if isinstance(p, Join):
        if p.how in ("semi", "anti"):
            return _plan_columns(p.left, catalog)
        return (_plan_columns(p.left, catalog)
                + _plan_columns(p.right, catalog))
    if isinstance(p, Aggregate):
        cols = list(p.group_by)
        for a in p.aggs:
            if a.func == "sum" and a.wide:
                cols += [f"{a.out}__hi", f"{a.out}__lo"]
            else:
                cols.append(a.out)
        return cols
    if isinstance(p, Distinct):
        return (list(p.keys) if p.keys
                else _plan_columns(p.input, catalog))
    if isinstance(p, Window):
        return (_plan_columns(p.input, catalog)
                + [s.out for s in p.specs])
    if isinstance(p, VectorTopK):
        return _plan_columns(p.input, catalog)
    if isinstance(p, Apply):
        cols = _plan_columns(p.input, catalog)
        if p.kind == "scalar" and p.scalar is not None:
            # the decorrelated form strips its helper join keys: output
            # is the input plus the one scalar column
            cols = cols + [p.scalar.out]
        return cols
    raise TypeError(type(p))


def _split_conjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, BoolOp) and e.op == "and":
        out: List[Expr] = []
        for part in e.args:
            out.extend(_split_conjuncts(part))
        return out
    return [e]


def _conjoin(parts: Sequence[Expr]) -> Expr:
    return parts[0] if len(parts) == 1 else BoolOp("and", tuple(parts))


def push_filters(p: Plan, catalog: Catalog) -> Plan:
    """Predicate pushdown: split conjunctions and sink each conjunct as
    deep as its column references allow — through pass-through
    projections and to the matching side of a join."""
    if isinstance(p, Filter):
        child = push_filters(p.input, catalog)
        remaining: List[Expr] = []
        for conj in _split_conjuncts(p.predicate):
            pushed, child = _try_push(conj, child, catalog)
            if not pushed:
                remaining.append(conj)
        if not remaining:
            return child
        return Filter(child, _conjoin(remaining))
    kids = tuple(push_filters(k, catalog) for k in p.inputs())
    if not kids:
        return p
    return _rebuild(p, kids)


def _rebuild(p: Plan, kids) -> Plan:
    """`p` over new children."""
    if isinstance(p, Filter):
        return Filter(kids[0], p.predicate)
    if isinstance(p, Shrink):
        return Shrink(kids[0], p.start_capacity)
    if isinstance(p, Project):
        return Project(kids[0], p.outputs)
    if isinstance(p, Join):
        return Join(kids[0], kids[1], p.left_on, p.right_on, p.how)
    if isinstance(p, Aggregate):
        return Aggregate(kids[0], p.group_by, p.aggs)
    if isinstance(p, OrderBy):
        return OrderBy(kids[0], p.keys)
    if isinstance(p, Limit):
        return Limit(kids[0], p.n, p.offset)
    if isinstance(p, Distinct):
        return Distinct(kids[0], p.keys)
    if isinstance(p, Window):
        # filters never push THROUGH a window (they'd change frames),
        # but pushdown inside its input subtree is preserved
        return Window(kids[0], p.partition_by, p.order_by, p.specs)
    if isinstance(p, VectorTopK):
        # filters above a top-K must not sink below it (they would
        # change WHICH k rows win); inside the subtree is fine
        return VectorTopK(kids[0], p.column, p.query, p.metric, p.k,
                          p.ann, p.nprobe)
    if isinstance(p, Apply):
        return Apply(kids[0], kids[1], p.correlation, p.kind, p.scalar)
    raise TypeError(f"unknown plan node {type(p).__name__}")


def _try_push(conj: Expr, node: Plan, catalog: Catalog) -> Tuple[bool, Plan]:
    refs = _expr_columns(conj, set())
    if isinstance(node, Filter):
        ok, pushed = _try_push(conj, node.input, catalog)
        if ok:
            return True, Filter(pushed, node.predicate)
        return False, node
    if isinstance(node, Project):
        # only through pass-through (renaming-free) output columns
        passthrough = {n for n, e in node.outputs
                       if isinstance(e, Col) and e.name == n}
        if refs <= passthrough:
            ok, pushed = _try_push(conj, node.input, catalog)
            if ok:
                return True, Project(pushed, node.outputs)
        return False, node
    if isinstance(node, Join):
        left_cols = set(_plan_columns(node.left, catalog))
        right_cols = set(_plan_columns(node.right, catalog))
        # NULL-extended sides must not receive pushed filters: the left
        # side of right/full joins and the right side of left/full joins
        # produce NULL rows the filter would wrongly suppress pre-join
        if refs <= left_cols and node.how in ("inner", "left", "semi",
                                              "anti"):
            ok, pushed = _try_push(conj, node.left, catalog)
            child = pushed if ok else Filter(node.left, conj)
            return True, Join(child, node.right, node.left_on,
                              node.right_on, node.how)
        if refs <= right_cols and node.how in ("inner", "right"):
            ok, pushed = _try_push(conj, node.right, catalog)
            child = pushed if ok else Filter(node.right, conj)
            return True, Join(node.left, child, node.left_on,
                              node.right_on, node.how)
        return False, node
    if isinstance(node, Scan):
        # land just above the scan
        return True, Filter(node, conj)
    return False, node


# ------------------------------------------------------ cardinality model --

def _walk_plan(p: Plan):
    yield p
    for k in p.inputs():
        yield from _walk_plan(k)


def _subtree_stats(p: Plan, catalog: Catalog, cols: set):
    """TableStats of the first scanned table covering `cols` (the
    independence assumption: a conjunct references one table)."""
    for sub in _walk_plan(p):
        if isinstance(sub, (Scan, IndexScan)) and cols <= set(
                catalog.table_schema(sub.table).names()):
            return catalog.table_stats(sub.table)
    return None


def _base_rows(p: Plan, catalog: Catalog) -> float:
    """Unfiltered cardinality of the largest scan under `p` (the PK-side
    denominator of an FK->PK join's fraction)."""
    best = 1.0
    for sub in _walk_plan(p):
        if isinstance(sub, (Scan, IndexScan)):
            st = catalog.table_stats(sub.table)
            best = max(best, float(st.row_count) if st is not None
                       else float(catalog.table_rows(sub.table)))
    return best


def estimate_cardinality(p: Plan, catalog: Catalog) -> float:
    """Output-row estimate from statistics: a selectivity per conjunct, an
    FK->PK fraction per join."""
    if isinstance(p, (Scan, IndexScan)):
        st = catalog.table_stats(p.table)
        return (float(st.row_count) if st is not None
                else float(catalog.table_rows(p.table)))
    if isinstance(p, Filter):
        base = estimate_cardinality(p.input, catalog)
        sel = 1.0
        for c in _split_conjuncts(p.predicate):
            st = _subtree_stats(p.input, catalog, _expr_columns(c, set()))
            sel *= conjunct_selectivity(c, st)
        return max(base * sel, 1.0)
    if isinstance(p, Join):
        le = estimate_cardinality(p.left, catalog)
        re_ = estimate_cardinality(p.right, catalog)
        rbase = _base_rows(p.right, catalog)
        frac = min(re_ / max(rbase, 1.0), 1.0)
        if p.how == "semi":
            return max(le * frac, 1.0)
        if p.how == "anti":
            return max(le * (1.0 - frac), 1.0)
        if p.how in ("inner", "left"):
            # FK->PK (unique build): each probe row matches <= 1 build row
            return max(le * (frac if p.how == "inner" else 1.0), 1.0)
        return max(le + re_, 1.0)
    if isinstance(p, Aggregate):
        ce = estimate_cardinality(p.input, catalog)
        return max(ce / 2.0, 1.0) if p.group_by else 1.0
    if isinstance(p, Limit):
        return float(min(estimate_cardinality(p.input, catalog), p.n))
    if isinstance(p, VectorTopK):
        return float(min(estimate_cardinality(p.input, catalog), p.k))
    if isinstance(p, Distinct):
        return max(estimate_cardinality(p.input, catalog) / 2.0, 1.0)
    if p.inputs():
        return estimate_cardinality(p.inputs()[0], catalog)
    return 1.0


# ----------------------------------------------------------- shrinks --

def insert_shrinks(p: Plan, catalog: Optional[Catalog] = None) -> Plan:
    """Place Shrink nodes: (1) above every HAVING-shaped filter (a filter
    over an aggregate); (2) above inner/semi joins whose build side is
    already small and whose probe side is not; (3) from statistics, above
    a selective join whose estimated output is at most a third of its
    probe input's, with capacity pow2(1.5 x the estimate), at least
    2^12 (Q9's 5% semi join against green parts). Smallness propagates
    through row-preserving nodes. A Shrink is never placed directly under
    an Aggregate. Its overflow restarts the flow with 16x the capacity,
    so a low estimate costs a restart, never a wrong answer."""
    node, _small = _shrink_rec(p, catalog, under_agg=False)
    return node


def _pow2_at_least(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def _shrink_rec(p: Plan, catalog: Optional[Catalog], under_agg: bool):
    if isinstance(p, Filter) and isinstance(p.input, Aggregate):
        inner, _ = _shrink_rec(p.input, catalog, False)
        return Shrink(Filter(inner, p.predicate)), True
    if not p.inputs():
        return p, False
    kid_under = isinstance(p, Aggregate)
    pairs = [_shrink_rec(k, catalog, kid_under) for k in p.inputs()]
    kids = tuple(n for n, _ in pairs)
    smalls = [sm for _, sm in pairs]
    out = _rebuild(p, kids)
    if isinstance(p, Shrink):
        return out, True
    if isinstance(p, Join):
        if (p.how in ("inner", "semi") and smalls[1] and not smalls[0]
                and not under_agg):
            return Shrink(out, start_capacity=1 << 14), True
        if (catalog is not None and not under_agg
                and p.how in ("inner", "semi", "anti")
                and not smalls[0]):
            est = estimate_cardinality(out, catalog)
            probe_est = estimate_cardinality(p.left, catalog)
            if est * 3.0 <= probe_est and est >= 1.0:
                cap = max(_pow2_at_least(int(est * 1.5) + 1), 1 << 12)
                return Shrink(out, start_capacity=cap), True
        return out, (smalls[0] and p.how in ("inner", "left", "semi",
                                             "anti"))
    if isinstance(p, (Filter, Project, Limit, OrderBy, Distinct,
                      Aggregate, VectorTopK)):
        # row-preserving (or row-reducing) single-child nodes keep their
        # child's smallness
        return out, smalls[0]
    return out, False


def decorrelate(p: Plan, catalog: Catalog) -> Plan:
    """Rewrite every Apply (correlated subquery) into join + aggregate
    form (see Apply's docstring). Runs first in normalize(): the later
    passes and the builder only see ordinary relational nodes."""
    kids = tuple(decorrelate(k, catalog) for k in p.inputs())
    if not isinstance(p, Apply):
        return _rebuild(p, kids) if kids else p
    outer, sub = kids
    outer_on = tuple(a for a, _ in p.correlation)
    inner_on = tuple(b for _, b in p.correlation)
    if p.kind in ("exists", "not_exists"):
        how = "semi" if p.kind == "exists" else "anti"
        return Join(outer, sub, outer_on, inner_on, how)
    if p.kind != "scalar" or p.scalar is None:
        raise TypeError(f"Apply kind {p.kind!r} needs a scalar AggSpec")
    out_cols = _plan_columns(outer, catalog)
    if not p.correlation:
        # uncorrelated scalar subquery: the single aggregate row reaches
        # every input row through a constant join key
        outer = Project(outer, tuple((n, Col(n)) for n in out_cols)
                        + (("__apply_c0", Lit(0, INT)),))
        outer_on = ("__apply_c0",)
        inner_on = ("__apply_c0_",)
        agg = Aggregate(sub, (), (p.scalar,))
        inner = Project(agg, (("__apply_c0_", Lit(0, INT)),
                              (p.scalar.out, Col(p.scalar.out))))
    else:
        # one aggregate row per distinct correlation key; the keys are
        # renamed so the join never collides with same-named outer
        # columns
        agg = Aggregate(sub, inner_on, (p.scalar,))
        renames = tuple((f"__apply_k{i}", Col(c))
                        for i, c in enumerate(inner_on))
        inner = Project(agg, renames
                        + ((p.scalar.out, Col(p.scalar.out)),))
        inner_on = tuple(f"__apply_k{i}" for i in range(len(inner_on)))
    joined = Join(outer, inner, outer_on, inner_on, "left")
    # strip the helper keys: Apply's contract is input cols + the scalar
    # (NULL where the group was empty, through the left join's validity)
    return Project(joined, tuple((n, Col(n)) for n in out_cols)
                   + ((p.scalar.out, Col(p.scalar.out)),))


_INT_MIN, _INT_MAX = -(1 << 63), (1 << 63) - 1


def _index_bounds(conjuncts, indexed):
    """-> (column, lo, hi) from the conjuncts' literal constraints on an
    indexed column, or None. The bound is a SUPERSET of the predicate
    (the residual filter stays), so several comparisons intersect; the
    narrowest column wins."""
    best = None
    for col in indexed:
        lo, hi = _INT_MIN, _INT_MAX
        constrained = False
        for c in conjuncts:
            if not isinstance(c, Cmp):
                continue
            if isinstance(c.left, Col) and c.left.name == col \
                    and isinstance(c.right, Lit) \
                    and isinstance(c.right.value, (int, np.integer)):
                op, v = c.op, int(c.right.value)
            elif isinstance(c.right, Col) and c.right.name == col \
                    and isinstance(c.left, Lit) \
                    and isinstance(c.left.value, (int, np.integer)):
                # literal OP col: mirror the comparison
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                      "=": "=", "==": "="}.get(c.op, c.op)
                v = int(c.left.value)
            else:
                continue
            if op in ("=", "=="):
                lo, hi = max(lo, v), min(hi, v)
            elif op == "<":
                hi = min(hi, v - 1)
            elif op == "<=":
                hi = min(hi, v)
            elif op == ">":
                lo = max(lo, v + 1)
            elif op == ">=":
                lo = max(lo, v)
            else:
                continue
            constrained = True
        if constrained and (best is None or (hi - lo) < (best[2] - best[1])):
            best = (col, lo, hi)
    return best


def use_indexes(p: Plan, catalog: Catalog) -> Plan:
    """Index selection (GenerateConstrainedScans, heuristic form): a
    filtered scan whose predicate bounds an indexed column with literals
    becomes an IndexScan under the same Filter."""
    if isinstance(p, Filter) and isinstance(p.input, Scan):
        indexed = catalog.table_indexes(p.input.table)
        if indexed:
            found = _index_bounds(_split_conjuncts(p.predicate), indexed)
            if found is not None:
                col, lo, hi = found
                return Filter(IndexScan(p.input.table, col, lo, hi,
                                        p.input.columns), p.predicate)
        return p
    kids = tuple(use_indexes(k, catalog) for k in p.inputs())
    if not kids:
        return p
    return _rebuild(p, kids)


def normalize(p: Plan, catalog: Catalog) -> Plan:
    """The JAX package's passes in its order:
    insert_shrinks(use_indexes(push_filters(decorrelate(p))))."""
    return insert_shrinks(use_indexes(push_filters(
        decorrelate(p, catalog), catalog), catalog), catalog)


# ------------------------------------------------------------------ build --

def _ordering_of(p: Plan) -> Tuple[str, ...]:
    """Column ordering the node's output is known to satisfy (prefix):
    only a direct OrderBy input qualifies."""
    if isinstance(p, OrderBy):
        return tuple(k.col for k in p.keys)
    return ()


def build(p: Plan, catalog: Catalog, capacity: int = 1 << 17,
          _normalized: bool = False, node_map=None) -> Operator:
    """Logical plan -> exec/ operator tree. With `sql.tpu.invariants` on
    (test builds) a CheckedOp (exec/invariants.py) wraps every operator,
    as the JAX package's build does. `node_map` (a dict) receives
    id(plan node) -> the operator its parent references (CheckedOp-
    wrapped in test builds): the placement pass (sql/plan_compile.py)
    pairs plan nodes with operators through it."""
    if not _normalized:
        p = normalize(p, catalog)

    from cockroach_tpu_torch.exec.invariants import CheckedOp, enabled

    checking = enabled()

    # common-subplan elimination: VALUE-equal plan nodes build ONE
    # operator (Q18 scans lineitem twice through identical Scan nodes).
    # Nodes whose predicates hash by identity (Expr eq=False) simply
    # never hit the memo.
    memo: Dict[Plan, Operator] = {}

    def rec(node: Plan) -> Operator:
        try:
            hit = memo.get(node)
        except TypeError:
            hit = None
        if hit is not None:
            if node_map is not None:
                node_map[id(node)] = hit
            return hit
        op = _rec(node)
        # test builds insert an invariants checker above every operator
        # (colexec/invariants_checker.go)
        if checking:
            op = CheckedOp(op)
        try:
            memo[node] = op
        except TypeError:
            pass
        if node_map is not None:
            node_map[id(node)] = op
        return op

    def _rec(node: Plan) -> Operator:
        if isinstance(node, Scan):
            schema = catalog.table_schema(node.table)
            cols = list(node.columns) if node.columns else None
            if cols:
                schema = schema.project(cols)
            chunks = catalog.table_chunks(node.table, capacity, cols)
            op = ScanOp(schema, chunks, capacity,
                        cache_key=catalog.scan_cache_key(
                            node.table, cols, capacity),
                        table=node.table)
            # the row estimate the placement pass reads (sql/cost.py)
            op.est_rows = catalog.table_rows(node.table)
            src = catalog.scan_source(node.table, cols)
            if src is not None:
                # the MVCC store behind the scan, for distributed ingest
                # (ROADMAP.md queue 1, item 7)
                op._mvcc_src = src
            return op
        if isinstance(node, IndexScan):
            schema = catalog.table_schema(node.table)
            cols = list(node.columns) if node.columns else None
            if cols:
                schema = schema.project(cols)
            chunks = catalog.index_chunks(node.table, node.column,
                                          node.lo, node.hi, capacity,
                                          cols)
            # no cache key: the index span is not a table image
            op = ScanOp(schema, chunks, capacity, table=node.table)
            op.est_rows = max(catalog.table_rows(node.table) // 4, 1)
            return op
        if isinstance(node, Filter):
            return MapOp(rec(node.input), [("filter", node.predicate)])
        if isinstance(node, Shrink):
            return ShrinkOp(rec(node.input), capacity=node.start_capacity)
        if isinstance(node, Project):
            child = rec(node.input)
            if _needs_row_engine(node.outputs, child.schema):
                return RowMapOp(child, list(node.outputs))
            return MapOp(child, [("project", list(node.outputs))])
        if isinstance(node, Join):
            return JoinOp(rec(node.left), rec(node.right),
                          list(node.left_on), list(node.right_on),
                          how=node.how)
        if isinstance(node, Aggregate):
            ordered = bool(node.group_by) and (
                tuple(node.group_by)
                == _ordering_of(node.input)[:len(node.group_by)])
            agg_cls = OrderedAggOp if ordered else HashAggOp
            return agg_cls(rec(node.input), list(node.group_by),
                           list(node.aggs))
        if isinstance(node, OrderBy):
            return SortOp(rec(node.input), list(node.keys))
        if isinstance(node, Limit):
            # OrderBy + Limit (no offset) -> top-K
            if isinstance(node.input, OrderBy) and node.offset == 0:
                return TopKOp(rec(node.input.input), list(node.input.keys),
                              node.n)
            return LimitOp(rec(node.input), node.n, node.offset)
        if isinstance(node, Distinct):
            return DistinctOp(rec(node.input),
                              list(node.keys) if node.keys else None)
        if isinstance(node, Window):
            return WindowOp(rec(node.input), list(node.partition_by),
                            list(node.order_by), list(node.specs))
        if isinstance(node, VectorTopK):
            if node.ann and isinstance(node.input, Scan):
                return VectorANNOp(rec(node.input), node.column,
                                   node.query, node.metric, node.k,
                                   node.nprobe)
            # exact path: distance projection -> sort-and-slice top-K
            # -> strip the helper column. Composed entirely from MapOp /
            # TopKOp so the fused tracer and the prepared cache treat a
            # vector query like any other scan program.
            child = rec(node.input)
            cols = _plan_columns(node.input, catalog)
            dist = VecDistance(node.metric, Col(node.column),
                               VecLit(node.query))
            proj = [(n, Col(n)) for n in cols] + [("__vdist", dist)]
            inner = MapOp(child, [("project", proj)])
            # NULL embeddings rank LAST (a NULL distance must not beat a
            # real neighbor), overriding the engine's ASC-nulls-first
            topk = TopKOp(inner,
                          [SortKey("__vdist", nulls_first=False)],
                          node.k)
            return MapOp(topk, [("project",
                                 [(n, Col(n)) for n in cols])])
        raise TypeError(f"unknown plan node {type(node).__name__}")

    return rec(p)


def _needs_row_engine(outputs, schema: Schema) -> bool:
    """A projection runs in the row engine when an output computes a
    string (a StrFunc, or a non-column output of STRING type such as a
    CASE over strings: dictionary minting is host-side by nature), or,
    under `sql.tpu.exact_arithmetic`, divides a decimal (the device path
    gives float32)."""
    def computes_string(e: Expr) -> bool:
        if has_string_compute(e):
            return True
        if isinstance(e, Col):
            return False
        try:
            return e.type(schema).kind is Kind.STRING
        except (KeyError, ValueError):  # an untypable expr mints none
            return False

    if any(computes_string(e) for _, e in outputs):
        return True
    return bool(Settings().get(EXACT_ARITHMETIC)) and any(
        has_decimal_division(e, schema) for _, e in outputs)


def run(p: Plan, catalog: Catalog, capacity: int = 1 << 17, mesh=None,
        with_schema: bool = False, op_sink=None, sql: Optional[str] = None,
        device=None, setting: str = "auto", resident: bool = False):
    """Execute a logical plan: compile it (sql/plan_compile.py: normalize,
    build, placement, the fused program) and collect it on `device`
    (CUDA unless the caller passes one). `setting` is the session's
    `vectorize`: "cpu" places the flow on the host. `with_schema=True`
    also returns the operator tree's output Schema; `op_sink` (a list)
    receives the built operator tree (the session's prepared cache);
    `sql` keys the placement pass's per-fingerprint cache; `resident`
    marks the scans resident (compile_plan)."""
    if mesh is not None:
        raise NotImplementedError("distributed execution (mesh) is not "
                                  "ported yet (ROADMAP.md queue 1, item 7)")
    from cockroach_tpu_torch.exec.operators import collect
    from cockroach_tpu_torch.sql.plan_compile import compile_plan

    compiled = compile_plan(p, catalog, capacity, sql=sql, setting=setting,
                            resident=resident)
    op = compiled.op
    if op_sink is not None:
        op_sink.append(op)
    result = collect(op, device=device, backend=compiled.backend)
    return (result, op.schema) if with_schema else result
