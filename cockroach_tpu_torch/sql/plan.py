"""Logical query plans and the plan -> operator-tree builder.

Counterpart of cockroach_tpu/sql/plan.py, for the plan nodes on TPC-H
Q1's path: Scan, Filter, Project, Aggregate and OrderBy. `normalize` holds
the pure rewrites Q1 passes through (predicate pushdown); the stats
passes (insert_shrinks, use_indexes, decorrelate) are not ported yet and
leave Q1 unchanged. `build` assembles the port's exec/ operators.

Tables come from a `Catalog`: anything resolving a name to (schema,
chunk stream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from cockroach_tpu_torch.coldata.batch import Schema
from cockroach_tpu_torch.exec.operators import (
    HashAggOp, MapOp, Operator, ScanOp, SortOp,
)
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.expr import BoolOp, Col, Expr
from cockroach_tpu_torch.ops.sort import SortKey


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
class Filter(Plan):
    input: Plan
    predicate: Expr

    def inputs(self):
        return (self.input,)


@dataclass(frozen=True)
class Project(Plan):
    input: Plan
    outputs: Tuple[Tuple[str, Expr], ...]  # complete output column list

    def inputs(self):
        return (self.input,)


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
    deep as its column references allow, through pass-through
    projections."""
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
    if isinstance(p, Project):
        return Project(kids[0], p.outputs)
    if isinstance(p, Aggregate):
        return Aggregate(kids[0], p.group_by, p.aggs)
    if isinstance(p, OrderBy):
        return OrderBy(kids[0], p.keys)
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
    if isinstance(node, Scan):
        # land just above the scan
        return True, Filter(node, conj)
    return False, node


def normalize(p: Plan, catalog: Catalog) -> Plan:
    return push_filters(p, catalog)


# ------------------------------------------------------------------ build --

def _ordering_of(p: Plan) -> Tuple[str, ...]:
    """Column ordering the node's output is known to satisfy (prefix):
    only a direct OrderBy input qualifies."""
    if isinstance(p, OrderBy):
        return tuple(k.col for k in p.keys)
    return ()


def build(p: Plan, catalog: Catalog, capacity: int = 1 << 17,
          _normalized: bool = False) -> Operator:
    """Logical plan -> exec/ operator tree."""
    if not _normalized:
        p = normalize(p, catalog)

    def rec(node: Plan) -> Operator:
        if isinstance(node, Scan):
            schema = catalog.table_schema(node.table)
            cols = list(node.columns) if node.columns else None
            if cols:
                schema = schema.project(cols)
            chunks = catalog.table_chunks(node.table, capacity, cols)
            return ScanOp(schema, chunks, capacity, table=node.table)
        if isinstance(node, Filter):
            return MapOp(rec(node.input), [("filter", node.predicate)])
        if isinstance(node, Project):
            return MapOp(rec(node.input), [("project", list(node.outputs))])
        if isinstance(node, Aggregate):
            if node.group_by and (tuple(node.group_by)
                                  == _ordering_of(node.input)[:len(node.group_by)]):
                raise NotImplementedError(
                    "ordered aggregation is not ported yet (ROADMAP.md "
                    "queue 1)")
            return HashAggOp(rec(node.input), list(node.group_by),
                             list(node.aggs))
        if isinstance(node, OrderBy):
            return SortOp(rec(node.input), list(node.keys))
        raise TypeError(f"unknown plan node {type(node).__name__}")

    return rec(p)
