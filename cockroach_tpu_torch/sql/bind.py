"""AST -> logical Plan binding: name resolution, literal typing, join
ordering, aggregate extraction.

Reference seams:
- optbuilder (pkg/sql/opt/optbuilder/builder.go:242): AST -> relational
  expression with resolved columns — this file's job.
- join ordering (pkg/sql/opt/xform join reordering rules): the reference
  runs Cascades exploration with stats costing; this binder uses the
  classic greedy heuristic — start from the largest (fact) relation and
  repeatedly attach the smallest-estimate connected relation, letting
  each dimension first absorb its own satellites (so customer joins
  orders before orders joins lineitem, Q3's shape).
- semi-join conversion (norm rules ConvertSemiToInnerJoin reversed):
  an inner join whose right side contributes no downstream columns and is
  unique on its join keys is executed as `semi` — the shape every
  hand-written TPC-H plan here used.
- IN (subquery) -> semi join, NOT IN -> anti join (decorrelation's
  trivial case; correlated subqueries are rejected at bind time).

Literal typing: SQL numeric literals are untyped; the binder retypes
them against the other operand (DECIMAL(s) columns make `0.05` a
scale-s scaled integer — ops/expr.py evaluates `Lit(v, DECIMAL(s))` as
`round(v*10^s)`), and DATE +- INTERVAL folds at bind time so the device
only ever sees int day comparisons.

Counterpart of cockroach_tpu/sql/bind.py: `Binder` (date folding,
literal retyping, the greedy join tree, IN-subqueries as semi/anti
joins, aggregates, windows, ORDER BY/LIMIT/OFFSET), `plan_sql` and
`run_sql`, with the vector forms (`<->` and `<=>` as VecDistance, a
`'[...]'` literal coerced to a VecLit, and `ORDER BY <distance> LIMIT
k` as a VectorTopK node) and `bind_changefeed`.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cockroach_tpu_torch.coldata.batch import (
    DATE, DECIMAL, FLOAT, Field, INT, Kind, Schema,
)
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.expr import (
    BinOp, BoolOp, Case, Cast, Cmp, Col, Expr, Extract, InList, IsNull,
    Like, Lit, Not, ScalarFunc, StrFunc, VecDistance, VecLit,
)
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.sql.plan import (
    Aggregate, Catalog, Distinct, Filter, Join, Limit, OrderBy, Plan,
    Project, Scan, VectorTopK, Window, _plan_columns,
)

class BindError(ValueError):
    pass


def _subst_cols(e: Expr, mapping: Dict[str, str]) -> Expr:
    """Structurally rewrite Col(name) references per `mapping`."""
    import dataclasses

    if isinstance(e, Col):
        return Col(mapping[e.name]) if e.name in mapping else e
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            nv = _subst_cols(v, mapping)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple):
            nv = tuple(
                _subst_cols(item, mapping) if isinstance(item, Expr)
                else tuple(_subst_cols(s, mapping) if isinstance(s, Expr)
                           else s for s in item)
                if isinstance(item, tuple) else item
                for item in v)
            if nv != v:
                changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


_AGG_FUNCS = {"sum", "avg", "min", "max", "count"}

_CAST_TYPES = {
    "int": INT, "integer": INT, "bigint": INT, "smallint": INT,
    "float": FLOAT, "double": FLOAT, "real": FLOAT, "date": DATE,
}


def _fold_dates(node: P.Node) -> P.Node:
    """Constant-fold DATE +- INTERVAL into a DateLit, recursing through
    the whole AST (bind-time calendar arithmetic; the device never sees
    intervals)."""
    if isinstance(node, P.Binary):
        left = _fold_dates(node.left)
        right = _fold_dates(node.right)
        if (node.op in ("+", "-") and isinstance(left, P.DateLit)
                and isinstance(right, P.IntervalLit)):
            base = datetime.date(1970, 1, 1) + datetime.timedelta(left.days)
            n = right.n if node.op == "+" else -right.n
            if right.unit == "day":
                d = base + datetime.timedelta(days=n)
            else:
                months = n * (12 if right.unit == "year" else 1)
                total = base.year * 12 + (base.month - 1) + months
                y, m = divmod(total, 12)
                # clamp day to target month length
                for day in range(base.day, 0, -1):
                    try:
                        d = datetime.date(y, m + 1, day)
                        break
                    except ValueError:
                        continue
            return P.DateLit((d - datetime.date(1970, 1, 1)).days)
        return P.Binary(node.op, left, right)
    if isinstance(node, P.Unary):
        return P.Unary(node.op, _fold_dates(node.arg))
    if isinstance(node, P.Between):
        return P.Between(_fold_dates(node.arg), _fold_dates(node.lo),
                         _fold_dates(node.hi), node.negate)
    if isinstance(node, P.InListAst):
        return P.InListAst(_fold_dates(node.arg),
                           [_fold_dates(v) for v in node.values],
                           node.negate)
    if isinstance(node, P.FuncCall):
        return P.FuncCall(node.name, [_fold_dates(a) for a in node.args],
                          node.star, node.distinct, node.params)
    if isinstance(node, P.CaseAst):
        return P.CaseAst(
            [(_fold_dates(c), _fold_dates(v)) for c, v in node.whens],
            _fold_dates(node.otherwise)
            if node.otherwise is not None else None)
    if isinstance(node, P.CastAst):
        return P.CastAst(_fold_dates(node.arg), node.to)
    if isinstance(node, P.ExtractAst):
        return P.ExtractAst(node.part, _fold_dates(node.arg))
    return node


@dataclass
class _Rel:
    """One relation in the FROM list (or an IN-subquery pseudo-relation)."""

    key: str                       # alias or table name (unique)
    table: Optional[str] = None    # base table name; None for subqueries
    subplan: Optional[Plan] = None
    filters: List[Expr] = dc_field(default_factory=list)
    est: float = float(1 << 20)
    forced_semi: Optional[str] = None  # "semi" | "anti" for IN-subqueries
    unique_cols: Optional[Tuple[str, ...]] = None  # pk / group-by cols


@dataclass
class _Edge:
    a: str
    b: str
    pairs: List[Tuple[str, str]]  # (a-side col, b-side col)


class Binder:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # ---------------------------------------------------------------- bind

    def bind(self, stmt: P.SelectStmt) -> Plan:
        # -- resolve FROM tables ------------------------------------------
        rels: Dict[str, _Rel] = {}
        schemas: Dict[str, Schema] = {}
        col_to_rel: Dict[str, str] = {}
        for tref in stmt.tables:
            key = tref.alias or tref.name
            if key in rels:
                raise BindError(f"duplicate table/alias {key!r} "
                                "(self-joins need distinct aliases; "
                                "self-join support not implemented)")
            schema = self.catalog.table_schema(tref.name)
            rels[key] = _Rel(key, table=tref.name,
                             est=float(self._rows(tref.name)),
                             unique_cols=self._pk(tref.name))
            schemas[key] = schema
            for name in schema.names():
                if name in col_to_rel:
                    raise BindError(f"ambiguous column {name!r} "
                                    f"(in {col_to_rel[name]} and {key})")
                col_to_rel[name] = key
        self._schemas = schemas
        self._col_to_rel = col_to_rel
        self._global = self._merge_schemas(schemas.values())
        self._alias_tables = {(tref.alias or tref.name): tref.name
                              for tref in stmt.tables}

        # -- outer joins: linear (syntactic) join order -------------------
        # LEFT/RIGHT/FULL OUTER joins are not freely reorderable; they
        # bind in FROM order with their ON equi-conditions, and the WHERE
        # applies wholesale ABOVE the joins (normalize()'s pushdown sinks
        # what is sound past NULL-extending sides).
        if any(t.how != "inner" for t in stmt.tables):
            plan = self._linear_join_tree(stmt)
            if stmt.where is not None:
                e, _refs = self._bind_scalar(_fold_dates(stmt.where))
                plan = Filter(plan, e)
            plan = self._select_and_aggregate(plan, stmt)
            if stmt.distinct:
                plan = self._exact_shape(plan)
                plan = Distinct(plan)
            plan = self._order_limit(plan, stmt)
            return self._exact_shape(plan)

        # -- WHERE decomposition ------------------------------------------
        edges: List[_Edge] = []
        post_filters: List[Expr] = []
        conjuncts = self._split_and(stmt.where) if stmt.where else []
        sub_n = 0
        for ast in conjuncts:
            ast = _fold_dates(ast)
            if isinstance(ast, (P.InSubquery,)):
                arg, refs = self._bind_scalar(ast.arg)
                if not isinstance(arg, Col) or len(refs) != 1:
                    raise BindError("IN (subquery) needs a plain column "
                                    "on the left")
                sub = Binder(self.catalog).bind(ast.query)
                sub_cols = _plan_columns(sub, self.catalog)
                key = f"__sub{sub_n}"
                sub_n += 1
                rels[key] = _Rel(
                    key, subplan=sub, est=float(1 << 16),
                    forced_semi="anti" if ast.negate else "semi")
                edges.append(_Edge(next(iter(refs)), key,
                                   [(arg.name, sub_cols[0])]))
                continue
            pair = self._as_join_pred(ast)
            if pair is not None:
                (ra, ca), (rb, cb) = pair
                if ra != rb:
                    self._add_edge(edges, ra, rb, ca, cb)
                    continue
            e, refs = self._bind_scalar(ast)
            if len(refs) == 1:
                rels[next(iter(refs))].filters.append(e)
            else:
                post_filters.append(e)

        # -- select-item / aggregate analysis -----------------------------
        plan = self._join_tree(rels, edges, stmt, post_filters)
        for f in post_filters:
            plan = Filter(plan, f)
        plan = self._select_and_aggregate(plan, stmt)
        if stmt.distinct:
            # DISTINCT dedups over the SELECT list ONLY: hidden
            # passthroughs must drop before dedup (SQL consequently
            # restricts ORDER BY to selected expressions here)
            plan = self._exact_shape(plan)
            plan = Distinct(plan)
        plan = self._order_limit(plan, stmt)
        # SQL defines the output shape EXACTLY: drop hidden columns
        # (scan passthroughs, ORDER BY-only refs, HAVING-only
        # aggregates) with a final projection above sort/limit
        return self._exact_shape(plan)

    def _exact_shape(self, plan: Plan) -> Plan:
        names = getattr(self, "_select_names", None)
        if names is not None and \
                names != _plan_columns(plan, self.catalog):
            plan = Project(plan, tuple((n, Col(n)) for n in names))
        return plan

    def _bind_vec_distance(self, op: str, left: Expr,
                           right: Expr) -> Expr:
        """`a <-> b` / `a <=> b` -> VecDistance. A string literal operand
        is coerced to a VecLit via the pgvector `'[1.0,2.0,...]'` text
        form (how prepared-statement query vectors arrive)."""
        from cockroach_tpu_torch.ops.vector import parse_vector_literal

        def coerce(e: Expr) -> Expr:
            if isinstance(e, Lit) and isinstance(e.value, str):
                try:
                    return VecLit(parse_vector_literal(e.value))
                except ValueError as err:
                    raise BindError(f"bad vector literal: {err}")
            return e

        left, right = coerce(left), coerce(right)
        dims = []
        for e in (left, right):
            try:
                t = e.type(self._global)
            except (KeyError, ValueError):
                t = None
            if t is None or t.kind is not Kind.VECTOR:
                raise BindError(
                    f"operand of {op!r} must be a VECTOR column or a "
                    "'[...]' vector literal")
            dims.append(t.dim)
        if dims[0] != dims[1]:
            raise BindError(
                f"vector dimension mismatch: {dims[0]} vs {dims[1]}")
        return VecDistance("l2" if op == "<->" else "cos", left, right)

    # ----------------------------------------------------- expr binding --

    def _bind_scalar(self, node: P.Node) -> Tuple[Expr, Set[str]]:
        """AST -> IR expr (no aggregates allowed) + referenced rel keys."""
        refs: Set[str] = set()
        e = self._bx(_fold_dates(node), refs, allow_agg=False, aggs=None)
        return e, refs

    def _bx(self, node: P.Node, refs: Set[str], allow_agg: bool,
            aggs) -> Expr:
        if isinstance(node, P.ColRef):
            return self._col(node, refs)
        if isinstance(node, P.Num):
            return Lit(node.value)
        if isinstance(node, P.Str):
            return Lit(node.value)
        if isinstance(node, P.DateLit):
            return Lit(node.days, INT)
        if isinstance(node, P.NullLit):
            return Lit(None, INT)
        if isinstance(node, P.BoolLit):
            return Lit(node.value)
        if isinstance(node, P.IntervalLit):
            raise BindError("INTERVAL only supported in date arithmetic")
        if isinstance(node, P.Unary):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            if node.op == "not":
                return Not(arg)
            if isinstance(arg, Lit) and isinstance(arg.value, (int, float)):
                return Lit(-arg.value, arg.ty)
            return BinOp("-", Lit(0), arg)
        if isinstance(node, P.Binary):
            if node.op in ("and", "or"):
                parts = tuple(self._bx(p, refs, allow_agg, aggs)
                              for p in self._flatten(node, node.op))
                return BoolOp(node.op, parts)
            left = self._bx(node.left, refs, allow_agg, aggs)
            right = self._bx(node.right, refs, allow_agg, aggs)
            if node.op == "||":
                return StrFunc("concat", (left, right))
            if node.op in ("<->", "<=>"):
                return self._bind_vec_distance(node.op, left, right)
            left, right = self._retype(left, right)
            if node.op in ("+", "-", "*", "/"):
                return BinOp(node.op, left, right)
            op = {"=": "==", "<>": "!=", "!=": "!="}.get(node.op, node.op)
            return Cmp(op, left, right)
        if isinstance(node, P.Between):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            lo = self._bx(node.lo, refs, allow_agg, aggs)
            hi = self._bx(node.hi, refs, allow_agg, aggs)
            a1, lo = self._retype(arg, lo)
            a2, hi = self._retype(arg, hi)
            e = BoolOp("and", (Cmp(">=", a1, lo), Cmp("<=", a2, hi)))
            return Not(e) if node.negate else e
        if isinstance(node, P.InListAst):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            values = []
            for v in node.values:
                bound = self._bx(v, refs, allow_agg, aggs)
                if not isinstance(bound, Lit):
                    raise BindError("IN list items must be literals")
                _, bound = self._retype(arg, bound)
                values.append(bound.value)
            e = InList(arg, tuple(values))
            return Not(e) if node.negate else e
        if isinstance(node, P.LikeAst):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            return Like(arg, node.pattern, node.negate)
        if isinstance(node, P.IsNullAst):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            return IsNull(arg, node.negate)
        if isinstance(node, P.CaseAst):
            whens = tuple(
                (self._bx(c, refs, allow_agg, aggs),
                 self._bx(v, refs, allow_agg, aggs))
                for c, v in node.whens)
            other = (self._bx(node.otherwise, refs, allow_agg, aggs)
                     if node.otherwise is not None else None)
            return Case(whens, other)
        if isinstance(node, P.CastAst):
            arg = self._bx(node.arg, refs, allow_agg, aggs)
            ty = node.to
            if ty.startswith(("decimal", "numeric")):
                scale = 0
                if "(" in ty:
                    parts = ty[ty.index("(") + 1:-1].split(",")
                    scale = int(parts[1]) if len(parts) > 1 else 0
                return Cast(arg, DECIMAL(scale))
            if ty not in _CAST_TYPES:
                raise BindError(f"unsupported cast type {ty!r}")
            return Cast(arg, _CAST_TYPES[ty])
        if isinstance(node, P.ExtractAst):
            if node.part not in ("year", "month", "day"):
                raise BindError(f"unsupported extract part {node.part!r}")
            return Extract(node.part,
                           self._bx(node.arg, refs, allow_agg, aggs))
        if isinstance(node, P.FuncCall):
            if node.name in _AGG_FUNCS:
                if not allow_agg:
                    raise BindError(
                        f"aggregate {node.name}() not allowed here")
                return aggs.add(node, self, refs)
            if node.name in ("abs", "mod", "sign", "floor", "ceil",
                             "coalesce", "nullif", "greatest", "least",
                             "length"):
                args = [self._bx(a, refs, allow_agg, aggs)
                        for a in node.args]
                arity = {"abs": 1, "sign": 1, "floor": 1, "ceil": 1,
                         "length": 1, "mod": 2, "nullif": 2}
                want = arity.get(node.name)
                if want is not None and len(args) != want:
                    raise BindError(f"{node.name}() takes {want} "
                                    f"argument(s)")
                if node.name in ("coalesce", "greatest", "least") \
                        and len(args) < 1:
                    raise BindError(f"{node.name}() needs arguments")
                # literals take the first typed argument's type
                if len(args) > 1:
                    for i in range(1, len(args)):
                        args[0], args[i] = self._retype(args[0], args[i])
                table = None
                if node.name == "length":
                    a0 = args[0]
                    if not (isinstance(a0, Col)
                            and a0.type(self._global).kind
                            is Kind.STRING):
                        raise BindError(
                            "length() takes a STRING column")
                    d = self._global.dictionary(a0.name)
                    if d is None:
                        raise BindError(
                            f"column {a0.name!r} has no dictionary")
                    table = tuple(len(str(s)) for s in d)
                return ScalarFunc(node.name, tuple(args), table)
            if node.name in ("upper", "lower", "substring", "concat"):
                args = tuple(self._bx(a, refs, allow_agg, aggs)
                             for a in node.args)
                for a in args:
                    if a.type(self._global).kind is not Kind.STRING:
                        raise BindError(
                            f"{node.name}() takes STRING arguments")
                return StrFunc(node.name, args, tuple(node.params))
            raise BindError(f"unknown function {node.name!r}")
        if isinstance(node, (P.InSubquery, P.ExistsAst)):
            raise BindError("subqueries are only supported as top-level "
                            "WHERE conjuncts (col IN (SELECT ...))")
        raise BindError(f"cannot bind {type(node).__name__}")

    def _col(self, ref: P.ColRef, refs: Set[str]) -> Col:
        if ref.qualifier is not None:
            key = ref.qualifier
            if key not in self._schemas:
                raise BindError(f"unknown table/alias {key!r}")
            if ref.name not in self._schemas[key].names():
                raise BindError(f"column {ref.name!r} not in {key!r}")
            refs.add(key)
            return Col(ref.name)
        key = self._col_to_rel.get(ref.name)
        if key is None:
            raise BindError(f"unknown column {ref.name!r}")
        refs.add(key)
        return Col(ref.name)

    def _flatten(self, node: P.Binary, op: str) -> List[P.Node]:
        out: List[P.Node] = []
        for side in (node.left, node.right):
            if isinstance(side, P.Binary) and side.op == op:
                out.extend(self._flatten(side, op))
            else:
                out.append(side)
        return out

    def _retype(self, left: Expr, right: Expr) -> Tuple[Expr, Expr]:
        """Give untyped numeric literals the scale of the other operand
        (DECIMAL columns make `0.05` an exact scaled integer)."""

        def fix(lit: Expr, other: Expr) -> Expr:
            if not isinstance(lit, Lit):
                return lit
            try:
                ty = other.type(self._global)
            except (KeyError, ValueError):
                return lit
            # '1999-01-01' compared against a DATE column: parse as a
            # date (Postgres string-to-date coercion in comparisons)
            if (ty.kind is Kind.DATE and isinstance(lit.value, str)):
                import datetime as _dt

                try:
                    d = _dt.date.fromisoformat(lit.value)
                except ValueError:
                    raise BindError(
                        f"invalid date literal {lit.value!r}")
                return Lit((d - _dt.date(1970, 1, 1)).days, INT)
            if not (lit.ty is None
                    and isinstance(lit.value, (int, float))
                    and not isinstance(lit.value, bool)):
                return lit
            if ty.kind is Kind.DECIMAL:
                return Lit(float(lit.value), ty)
            return lit

        return fix(left, right), fix(right, left)

    def _split_and(self, node: P.Node) -> List[P.Node]:
        if isinstance(node, P.Binary) and node.op == "and":
            return self._split_and(node.left) + self._split_and(node.right)
        return [node]

    def _as_join_pred(self, ast: P.Node):
        """col_a = col_b across two relations -> ((rel_a, col_a),
        (rel_b, col_b)); None otherwise."""
        if not (isinstance(ast, P.Binary) and ast.op == "="):
            return None
        if not (isinstance(ast.left, P.ColRef)
                and isinstance(ast.right, P.ColRef)):
            return None
        ra: Set[str] = set()
        rb: Set[str] = set()
        a = self._col(ast.left, ra)
        b = self._col(ast.right, rb)
        return (next(iter(ra)), a.name), (next(iter(rb)), b.name)

    @staticmethod
    def _add_edge(edges: List[_Edge], ra: str, rb: str, ca: str, cb: str):
        for e in edges:
            if {e.a, e.b} == {ra, rb}:
                if e.a == ra:
                    e.pairs.append((ca, cb))
                else:
                    e.pairs.append((cb, ca))
                return
        edges.append(_Edge(ra, rb, [(ca, cb)]))

    # ------------------------------------------------------- join tree --

    def _linear_join_tree(self, stmt: P.SelectStmt) -> Plan:
        """FROM-order join tree for queries with outer joins (the
        reference keeps outer joins in their syntactic association too,
        absent explicit reordering rules)."""
        trefs = stmt.tables
        plan: Plan = Scan(trefs[0].name)
        joined = {trefs[0].alias or trefs[0].name}
        for tref in trefs[1:]:
            key = tref.alias or tref.name
            if tref.on is None:
                raise BindError("outer JOIN requires an ON condition")
            left_on: List[str] = []
            right_on: List[str] = []
            for c in self._split_and(tref.on):
                pair = self._as_join_pred(_fold_dates(c))
                if pair is None:
                    raise BindError("outer-join ON conditions must be "
                                    "column equalities")
                (ra, ca), (rb, cb) = pair
                if ra in joined and rb == key:
                    left_on.append(ca)
                    right_on.append(cb)
                elif rb in joined and ra == key:
                    left_on.append(cb)
                    right_on.append(ca)
                else:
                    raise BindError(
                        f"ON condition must link {key!r} to an "
                        "already-joined table")
            plan = Join(plan, Scan(tref.name), tuple(left_on),
                        tuple(right_on), how=tref.how)
            joined.add(key)
        return plan

    def _join_tree(self, rels: Dict[str, _Rel], edges: List[_Edge],
                   stmt: P.SelectStmt, post_filters: List[Expr]) -> Plan:
        if len(rels) == 1:
            (rel,) = rels.values()
            return self._rel_plan(rel, stmt)

        # columns needed above the joins: select/group/having/order refs
        # + post-join filter refs
        needed: Set[str] = set()
        for ast, _alias in stmt.items:
            self._collect_cols(ast, needed)
        for ast in stmt.group_by:
            self._collect_cols(ast, needed)
        if stmt.having is not None:
            self._collect_cols(stmt.having, needed)
        for ast, _d in stmt.order_by:
            self._collect_cols(ast, needed)
        for e in post_filters:
            self._ir_cols(e, needed)

        # cost-ranked estimates: ANALYZE stats give per-conjunct
        # selectivities (histograms + distinct counts, sql/stats.py);
        # without stats, the flat 0.2 filter discount stands in
        from cockroach_tpu_torch.sql.stats import estimate_rows

        est = {}
        for k, r in rels.items():
            stats = (self.catalog.table_stats(r.table)
                     if r.table else None)
            if stats is not None:
                est[k] = estimate_rows(stats, r.est, r.filters)
            else:
                est[k] = r.est * (0.2 if r.filters else 1.0)
        fact = max((k for k in rels if rels[k].forced_semi is None),
                   key=lambda k: est[k])

        remaining = dict(rels)
        plan = self._rel_plan(remaining.pop(fact), stmt)
        joined = {fact}
        pending = list(edges)

        def attach_to(plan: Plan, joined: Set[str]) -> Plan:
            while True:
                cands = {}
                for e in pending:
                    for mine, other in ((e.a, e.b), (e.b, e.a)):
                        if mine in joined and other in remaining:
                            cands.setdefault(other, []).append(e)
                if not cands:
                    return plan
                key = min(cands, key=lambda k: est[k])
                rel = remaining.pop(key)
                # satellites: relations connected to `key` but not to the
                # current tree join into `key` first (Q3: customer->orders)
                sub = self._rel_plan(rel, stmt)
                sub_joined = {key}
                sub = attach_to(sub, sub_joined)
                joined_edges = [e for e in pending
                                if (e.a in joined and e.b in sub_joined)
                                or (e.b in joined and e.a in sub_joined)]
                for e in joined_edges:
                    pending.remove(e)
                left_on: List[str] = []
                right_on: List[str] = []
                for e in joined_edges:
                    for ca, cb in e.pairs:
                        if e.a in joined:
                            left_on.append(ca)
                            right_on.append(cb)
                        else:
                            left_on.append(cb)
                            right_on.append(ca)
                how = self._join_kind(rel, sub_joined, rels, right_on,
                                      needed, pending)
                plan = Join(plan, sub, tuple(left_on), tuple(right_on),
                            how=how)
                joined |= sub_joined
                # nested attach consumed edges internal to sub already

        # the inner attach for satellites uses the same pending list: edges
        # between two not-yet-joined relations are picked up when one side
        # becomes part of a subtree
        plan = attach_to(plan, joined)
        if remaining:
            raise BindError(
                f"cross join required for {sorted(remaining)} "
                "(no join predicate connects them)")
        return plan

    def _join_kind(self, rel: _Rel, sub_joined: Set[str],
                   rels: Dict[str, _Rel], right_on: Sequence[str],
                   needed: Set[str], pending: List[_Edge]) -> str:
        if rel.forced_semi:
            return rel.forced_semi
        if len(sub_joined) > 1:
            return "inner"  # subtree outputs: be conservative
        # right side unused above and unique on its join keys -> semi
        right_cols = set(self._schemas[rel.key].names()
                         if rel.table else
                         _plan_columns(rel.subplan, self.catalog))
        still_needed = right_cols & needed
        for e in pending:
            for ca, cb in e.pairs:
                still_needed |= ({ca, cb} & right_cols)
        if still_needed:
            return "inner"
        if rel.unique_cols and set(rel.unique_cols) <= set(right_on):
            return "semi"
        return "inner"

    def _rel_plan(self, rel: _Rel, stmt: P.SelectStmt) -> Plan:
        if rel.subplan is not None:
            return rel.subplan
        # prune scan columns to those referenced anywhere in the query
        used: Set[str] = set()
        for ast, _alias in stmt.items:
            self._collect_cols(ast, used)
        for ast in stmt.group_by:
            self._collect_cols(ast, used)
        if stmt.where is not None:
            self._collect_cols(stmt.where, used)
        if stmt.having is not None:
            self._collect_cols(stmt.having, used)
        for ast, _d in stmt.order_by:
            self._collect_cols(ast, used)
        schema = self._schemas[rel.key]
        cols = tuple(n for n in schema.names() if n in used)
        plan: Plan = Scan(rel.table, cols or None)
        for f in rel.filters:
            plan = Filter(plan, f)
        return plan

    def _collect_cols(self, ast: P.Node, out: Set[str]):
        if isinstance(ast, P.ColRef):
            out.add(ast.name)
            return
        if isinstance(ast, P.SelectStmt):
            return  # subquery scope is separate
        for v in getattr(ast, "__dict__", {}).values():
            if isinstance(v, P.Node):
                self._collect_cols(v, out)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, P.Node):
                        self._collect_cols(item, out)
                    elif (isinstance(item, tuple) and item
                          and isinstance(item[0], P.Node)):
                        for sub in item:
                            if isinstance(sub, P.Node):
                                self._collect_cols(sub, out)

    def _ir_cols(self, e: Expr, out: Set[str]):
        if isinstance(e, Col):
            out.add(e.name)
        for v in getattr(e, "__dict__", {}).values():
            if isinstance(v, Expr):
                self._ir_cols(v, out)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, Expr):
                        self._ir_cols(item, out)
                    elif isinstance(item, tuple):
                        for sub in item:
                            if isinstance(sub, Expr):
                                self._ir_cols(sub, out)

    # ------------------------------------------- select list / aggregate --

    def _select_and_aggregate(self, plan: Plan, stmt: P.SelectStmt) -> Plan:
        if any(self._has_window(ast) for ast, _ in stmt.items):
            return self._select_windows(plan, stmt)
        collector = _AggCollector(self)
        refs: Set[str] = set()

        items: List[Tuple[str, Expr]] = []  # (output name, post-agg expr)
        for idx, (ast, alias) in enumerate(stmt.items):
            ast = _fold_dates(ast)
            e = self._bx(ast, refs, allow_agg=True, aggs=collector)
            name = alias or self._default_name(ast, e, idx)
            items.append((name, e))

        # `sum(x) AS revenue` names the AggSpec output directly (before
        # HAVING binds, so structural dedup resolves to the final name).
        # First alias wins per spec; every item's expr is then rewritten,
        # so other references to the old output stay consistent.
        renames: Dict[str, str] = {}
        spec_outs = {a.out for a in collector.specs}
        for (ast, alias), (name, e) in zip(stmt.items, items):
            if (isinstance(ast, P.FuncCall) and ast.name in _AGG_FUNCS
                    and alias and isinstance(e, Col)
                    and alias != e.name
                    and e.name in spec_outs
                    and e.name not in renames
                    and alias not in self._col_to_rel
                    and alias not in spec_outs
                    and alias not in renames.values()):
                renames[e.name] = alias
        for old, new in renames.items():
            collector.rename(old, new)
        if renames:
            items = [(n, _subst_cols(e, renames)) for n, e in items]

        has_agg = bool(collector.specs) or bool(stmt.group_by)
        having_expr = None
        if stmt.having is not None:
            # make aggregate outputs typable for literal retyping
            self._global = self._merge_schemas(
                [self._global, collector.output_schema(self._global)])
            having_expr = self._bx(_fold_dates(stmt.having), refs,
                                   allow_agg=True, aggs=collector)
            has_agg = True

        self._select_names = [n for n, _ in items]
        self._select_items = list(items)
        if not has_agg:
            # plain projection; skip when it is an identity rename (the
            # final exact-shape projection in bind() drops any extra
            # passthrough columns after ORDER BY resolves)
            if all(isinstance(e, Col) and e.name == n for n, e in items):
                return plan
            return Project(plan, tuple((n, e) for n, e in items))

        # group keys: bind each GROUP BY entry; entries may be column
        # names, select aliases, or expressions matching a select item
        alias_map = {alias: i for i, (_, alias) in enumerate(stmt.items)
                     if alias}
        keys: List[Tuple[str, Expr]] = []
        for g_ast in stmt.group_by:
            g_ast = _fold_dates(g_ast)
            if isinstance(g_ast, P.ColRef) and g_ast.qualifier is None \
                    and g_ast.name in alias_map \
                    and g_ast.name not in self._col_to_rel:
                i = alias_map[g_ast.name]
                keys.append((g_ast.name, items[i][1]))
                continue
            ge = self._bx(g_ast, refs, allow_agg=False, aggs=None)
            if isinstance(ge, Col):
                keys.append((ge.name, ge))
                continue
            # computed key: find the select item with the same structure
            name = None
            for n, e in items:
                if repr(e) == repr(ge):
                    name = n
                    break
            keys.append((name or f"__g{len(keys)}", ge))

        key_names = [n for n, _ in keys]

        # select items that ARE group keys read the key's output column
        # (select n_name as nation ... group by nation)
        key_by_repr = {repr(e): n for n, e in keys}
        items = [(n, Col(key_by_repr[repr(e)])
                  if repr(e) in key_by_repr else e)
                 for n, e in items]

        # pre-aggregation projection: group keys + aggregate inputs
        pre_outputs: List[Tuple[str, Expr]] = []
        seen = set()
        for n, e in keys:
            if n not in seen:
                pre_outputs.append((n, e))
                seen.add(n)
        for n, e in collector.inputs:
            if n not in seen:
                pre_outputs.append((n, e))
                seen.add(n)
        if not all(isinstance(e, Col) and e.name == n
                   for n, e in pre_outputs):
            plan = Project(plan, tuple(pre_outputs))
        elif set(n for n, _ in pre_outputs) != set(
                _plan_columns(plan, self.catalog)):
            plan = Project(plan, tuple(pre_outputs))

        if collector.distinct_cols:
            dset = sorted(set(collector.distinct_cols))
            if len(dset) > 1:
                raise BindError("only one COUNT(DISTINCT col) column "
                                "per query is supported")
            if any(a.out not in collector.distinct_outs
                   for a in collector.specs):
                raise BindError("mixing COUNT(DISTINCT) with plain "
                                "aggregates is not supported")
            # dedup (group keys, col) rows before the aggregate; the
            # count spec then counts exactly the distinct values
            dkeys = tuple(key_names) + (
                () if dset[0] in key_names else (dset[0],))
            plan = Distinct(plan, dkeys)

        plan = Aggregate(plan, tuple(key_names), tuple(collector.specs))

        if having_expr is not None:
            plan = Filter(plan, having_expr)
        self._last_collector = collector  # ORDER BY agg-expr resolution

        # post-aggregation projection only when a select item computes
        # over aggregate outputs or renames one (identity projections are
        # skipped: the aggregate's outputs already carry the right names,
        # and extra hidden columns — HAVING-only aggregates — are
        # harmless, matching the hand-written plans)
        out_names = set(key_names) | {a.out for a in collector.specs}
        identity = all(isinstance(e, Col) and e.name == n
                       and n in out_names for n, e in items)
        if not identity:
            exprs = list(items)
            # keep hidden outputs that ORDER BY still references
            have = {n for n, _ in exprs}
            for ast, _d in stmt.order_by:
                bound = self._try_bind_order_ref(ast, collector, items,
                                                 out_names)
                if bound is not None and bound not in have:
                    exprs.append((bound, Col(bound)))
                    have.add(bound)
            plan = Project(plan, tuple(exprs))
        return plan

    # ------------------------------------------------------- windows --

    def _has_window(self, ast: P.Node) -> bool:
        if isinstance(ast, P.WindowCall):
            return True
        for v in getattr(ast, "__dict__", {}).values():
            if isinstance(v, P.Node) and self._has_window(v):
                return True
            if isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, P.Node) and self._has_window(item):
                        return True
        return False

    def _select_windows(self, plan: Plan, stmt: P.SelectStmt) -> Plan:
        """Select list containing window functions: one Window plan node
        per distinct OVER clause, then a final projection. Windows over
        GROUP BY output are not supported yet."""
        from cockroach_tpu_torch.ops.window import WINDOW_FUNCS, WindowSpec

        if stmt.group_by or stmt.having is not None:
            raise BindError("window functions over GROUP BY are not "
                            "supported yet")
        groups: Dict[str, Tuple[Tuple[str, ...], Tuple[SortKey, ...],
                                List[WindowSpec]]] = {}
        items: List[Tuple[str, Expr]] = []
        n_win = 0
        for idx, (ast, alias) in enumerate(stmt.items):
            ast = _fold_dates(ast)
            if not isinstance(ast, P.WindowCall):
                refs: Set[str] = set()
                e = self._bx(ast, refs, allow_agg=False, aggs=None)
                items.append((alias or self._default_name(ast, e, idx), e))
                continue
            call = ast.call
            if call.name not in WINDOW_FUNCS:
                raise BindError(f"unknown window function {call.name!r}")
            if call.distinct:
                raise BindError("DISTINCT window aggregates not supported")
            part_cols = []
            for p_ast in ast.partition_by:
                refs = set()
                pe = self._bx(p_ast, refs, allow_agg=False, aggs=None)
                if not isinstance(pe, Col):
                    raise BindError("PARTITION BY supports plain columns")
                part_cols.append(pe.name)
            order_keys = []
            for o_ast, desc in ast.order_by:
                refs = set()
                oe = self._bx(o_ast, refs, allow_agg=False, aggs=None)
                if not isinstance(oe, Col):
                    raise BindError("window ORDER BY supports plain "
                                    "columns")
                order_keys.append(SortKey(oe.name, descending=desc))
            col = None
            offset = 1
            if call.star:
                pass
            elif not call.args and call.name not in (
                    "row_number", "rank", "dense_rank", "count"):
                raise BindError(f"{call.name}() needs an argument")
            elif call.args:
                refs = set()
                arg = self._bx(call.args[0], refs, allow_agg=False,
                               aggs=None)
                if not isinstance(arg, Col):
                    raise BindError("window function arguments must be "
                                    "plain columns")
                col = arg.name
                if len(call.args) > 1:
                    off = self._bx(call.args[1], set(), False, None)
                    if not (isinstance(off, Lit)
                            and isinstance(off.value, int)):
                        raise BindError("lag/lead offset must be an "
                                        "integer literal")
                    offset = off.value
            out = alias or f"{call.name}_{n_win}"
            n_win += 1
            spec = WindowSpec(call.name, col, out, offset)
            gkey = repr((tuple(part_cols), tuple(order_keys)))
            groups.setdefault(
                gkey, (tuple(part_cols), tuple(order_keys), []))
            groups[gkey][2].append(spec)
            items.append((out, Col(out)))
        for part_cols, order_keys, specs in groups.values():
            plan = Window(plan, part_cols, order_keys, tuple(specs))
        self._select_names = [n for n, _ in items]
        out_cols = _plan_columns(plan, self.catalog)
        if [n for n, _ in items] != out_cols or not all(
                isinstance(e, Col) and e.name == n for n, e in items):
            plan = Project(plan, tuple(items))
        return plan

    def _default_name(self, ast: P.Node, e: Expr, idx: int) -> str:
        if isinstance(e, Col):
            return e.name
        if isinstance(ast, P.FuncCall):
            return ast.name
        return f"col{idx}"

    def _try_bind_order_ref(self, ast: P.Node, collector, items,
                            out_names) -> Optional[str]:
        if isinstance(ast, P.ColRef) and ast.qualifier is None:
            if ast.name in out_names:
                return ast.name
        if isinstance(ast, P.FuncCall) and ast.name in _AGG_FUNCS:
            spec = collector.find(ast, self)
            if spec is not None:
                return spec.out
        return None

    # --------------------------------------------------- order by / limit

    def _order_limit(self, plan: Plan, stmt: P.SelectStmt) -> Plan:
        vec = self._vector_topk(plan, stmt)
        if vec is not None:
            return vec
        if stmt.order_by:
            out_cols = _plan_columns(plan, self.catalog)
            sort_keys = []
            for ast, desc in stmt.order_by:
                name = self._order_name(ast, out_cols, stmt)
                sort_keys.append(SortKey(name, descending=desc))
            plan = OrderBy(plan, tuple(sort_keys))
        if stmt.limit is not None:
            plan = Limit(plan, stmt.limit, stmt.offset)
        elif stmt.offset:
            # OFFSET without LIMIT: int32-rank-safe "unbounded" limit
            plan = Limit(plan, (1 << 31) - 1 - stmt.offset, stmt.offset)
        return plan

    def _vector_topk(self, plan: Plan,
                     stmt: P.SelectStmt) -> Optional[Plan]:
        """`ORDER BY emb <-> '[..]' LIMIT k` -> VectorTopK (the vector
        search node). Fires only for a single ascending distance ORDER BY
        with a plain LIMIT; the distance need not be in the select list
        (when it IS selected, the generic OrderBy-on-alias path already
        handles it and this intercept never sees a Binary)."""
        if (len(stmt.order_by) != 1 or stmt.limit is None or stmt.offset
                or stmt.distinct):
            return None
        ast, desc = stmt.order_by[0]
        if desc or not (isinstance(ast, P.Binary)
                        and ast.op in ("<->", "<=>")):
            return None
        e, _refs = self._bind_scalar(ast)
        left, right = e.left, e.right
        if isinstance(left, VecLit) and isinstance(right, Col):
            left, right = right, left
        if not (isinstance(left, Col) and isinstance(right, VecLit)):
            raise BindError("vector ORDER BY needs a VECTOR column on "
                            "one side and a literal on the other")
        out_cols = _plan_columns(plan, self.catalog)
        # the same distance selected as an item: order by that column
        # through the generic TopK path (same VecDistance evaluation,
        # so results are identical to the VectorTopK lowering)
        for n, ie in getattr(self, "_select_items", []):
            if repr(ie) == repr(e) and n in out_cols:
                return Limit(OrderBy(plan, (SortKey(n),)),
                             stmt.limit, 0)
        if left.name not in out_cols:
            raise BindError(
                f"vector ORDER BY column {left.name!r} is not available "
                "at the top of the plan (aggregated/projected away)")
        from cockroach_tpu_torch.util.settings import (
            Settings, VECTOR_ANN, VECTOR_NPROBE,
        )

        st = Settings()
        # ANN only over a bare scan: residual filters/joins/projections
        # must see exact distances (the index ranks the WHOLE table)
        ann = bool(st.get(VECTOR_ANN)) and isinstance(plan, Scan)
        return VectorTopK(plan, left.name, right.values, e.metric,
                          int(stmt.limit), ann,
                          int(st.get(VECTOR_NPROBE)))

    def _order_name(self, ast: P.Node, out_cols: List[str],
                    stmt: P.SelectStmt) -> str:
        ast = _fold_dates(ast)
        if isinstance(ast, P.Num):
            i = int(ast.text) - 1
            if not 0 <= i < len(stmt.items):
                raise BindError(f"ORDER BY position {ast.text} out of range")
            item_ast, alias = stmt.items[i]
            if alias:
                return alias
            if isinstance(item_ast, P.ColRef):
                return item_ast.name
            raise BindError("ORDER BY position refers to an unnamed "
                            "expression; add an alias")
        if isinstance(ast, P.ColRef) and ast.qualifier is None:
            if ast.name in out_cols:
                return ast.name
            raise BindError(f"ORDER BY column {ast.name!r} is not in the "
                            f"output (have {out_cols})")
        if isinstance(ast, P.FuncCall) and ast.name in _AGG_FUNCS:
            # match the aggregate structurally against the collected specs
            collector = getattr(self, "_last_collector", None)
            if collector is not None:
                spec = collector.find(ast, self)
                if spec is not None and spec.out in out_cols:
                    return spec.out
        raise BindError("ORDER BY supports output columns, aliases, "
                        "positions, or aggregate expressions that appear "
                        "in the select list")

    # --------------------------------------------------------- catalog --

    def _rows(self, table: str) -> int:
        fn = getattr(self.catalog, "table_rows", None)
        if fn is not None:
            try:
                return int(fn(table))
            except (KeyError, NotImplementedError):
                pass
        return 1 << 20

    def _pk(self, table: str) -> Optional[Tuple[str, ...]]:
        fn = getattr(self.catalog, "table_pk", None)
        if fn is not None:
            try:
                return fn(table)
            except (KeyError, NotImplementedError):
                pass
        return None

    @staticmethod
    def _merge_schemas(schemas) -> Schema:
        fields: List[Field] = []
        dicts = {}
        for s in schemas:
            fields.extend(s.fields)
            dicts.update(s.dicts)
        return Schema(fields, dicts)


class _AggCollector:
    """Extracts aggregate calls from select/having expressions, returning
    Col refs to the aggregate's output; dedupes structurally."""

    def __init__(self, binder: Binder):
        self.binder = binder
        self.specs: List[AggSpec] = []
        self.inputs: List[Tuple[str, Expr]] = []  # pre-projection columns
        self._by_repr: Dict[str, AggSpec] = {}
        self.distinct_cols: List[str] = []  # COUNT(DISTINCT col) inputs
        self.distinct_outs: Set[str] = set()

    def add(self, call: P.FuncCall, binder: Binder,
            refs: Set[str]) -> Col:
        spec = self._make(call, binder, refs)
        return Col(spec.out)

    def find(self, call: P.FuncCall, binder: Binder) -> Optional[AggSpec]:
        key = self._key(call, binder)
        return self._by_repr.get(key) if key is not None else None

    def _key(self, call: P.FuncCall, binder: Binder) -> Optional[str]:
        try:
            refs: Set[str] = set()
            if call.star:
                return "count_star"
            arg = binder._bx(call.args[0], refs, allow_agg=False, aggs=None)
            d = "distinct " if call.distinct else ""
            return f"{call.name}({d}{arg!r})"
        except BindError:
            return None

    def _make(self, call: P.FuncCall, binder: Binder,
              refs: Set[str]) -> AggSpec:
        if call.distinct:
            # COUNT(DISTINCT col): plan-level rewrite — a Distinct node
            # (group keys + col) dedups BEFORE the aggregate, so a plain
            # count over the deduped stream IS the distinct count
            if call.name != "count" or call.star or len(call.args) != 1:
                raise BindError(
                    "DISTINCT aggregates: only COUNT(DISTINCT col) "
                    "is supported")
            arg = binder._bx(call.args[0], refs, allow_agg=False,
                             aggs=None)
            if not isinstance(arg, Col):
                raise BindError("COUNT(DISTINCT ...) needs a plain "
                                "column argument")
            key = f"count(distinct {arg!r})"
            if key in self._by_repr:
                return self._by_repr[key]
            if arg.name not in {n for n, _ in self.inputs}:
                self.inputs.append((arg.name, arg))
            self.distinct_cols.append(arg.name)
            spec = AggSpec("count", arg.name, self._fresh("count"))
            self.specs.append(spec)
            self._by_repr[key] = spec
            self.distinct_outs.add(spec.out)
            return spec
        if call.star:
            key = "count_star"
            if key in self._by_repr:
                return self._by_repr[key]
            spec = AggSpec("count_star", None, self._fresh("count"))
            self.specs.append(spec)
            self._by_repr[key] = spec
            return spec
        if len(call.args) != 1:
            raise BindError(f"{call.name}() takes one argument")
        arg = binder._bx(call.args[0], refs, allow_agg=False, aggs=None)
        key = f"{call.name}({arg!r})"
        if key in self._by_repr:
            return self._by_repr[key]
        if isinstance(arg, Col):
            in_name = arg.name
        else:
            in_name = self._fresh(f"__in{len(self.inputs)}")
        if in_name not in {n for n, _ in self.inputs}:
            self.inputs.append((in_name, arg))
        func = {"count": "count"}.get(call.name, call.name)
        spec = AggSpec(func, in_name, self._fresh(call.name))
        self.specs.append(spec)
        self._by_repr[key] = spec
        return spec

    def _fresh(self, base: str) -> str:
        names = {a.out for a in self.specs}
        if base not in names:
            return base
        i = 1
        while f"{base}_{i}" in names:
            i += 1
        return f"{base}_{i}"

    def rename(self, old: str, new: str) -> None:
        import dataclasses

        for i, spec in enumerate(self.specs):
            if spec.out == old:
                renamed = dataclasses.replace(spec, out=new)
                self.specs[i] = renamed
                for k, v in list(self._by_repr.items()):
                    if v is spec:
                        self._by_repr[k] = renamed
                if old in self.distinct_outs:
                    self.distinct_outs.discard(old)
                    self.distinct_outs.add(new)
                return

    def output_schema(self, global_schema: Schema) -> Schema:
        """Synthetic fields typing the aggregate outputs (for literal
        retyping in HAVING)."""
        fields = []
        for spec in self.specs:
            if spec.func in ("count", "count_star"):
                fields.append(Field(spec.out, INT))
                continue
            try:
                in_expr = next(e for n, e in self.inputs
                               if n == spec.col)
            except StopIteration:
                in_expr = Col(spec.col) if spec.col else None
            try:
                in_ty = (in_expr.type(global_schema)
                         if in_expr is not None else INT)
            except (KeyError, ValueError):
                continue
            fields.append(Field(
                spec.out, FLOAT if spec.func == "avg" else in_ty))
        return Schema(fields)


def plan_sql(sql: str, catalog: Catalog) -> Plan:
    """SQL text -> bound logical plan (parse + bind)."""
    ast = P.parse(sql)
    if isinstance(ast, P.ExplainStmt):
        raise BindError("EXPLAIN goes through sql.explain.execute()")
    return Binder(catalog).bind(ast)


def run_sql(sql: str, catalog: Catalog, capacity: int = 1 << 17,
            mesh=None, device=None):
    """SQL text -> executed result columns (the conn_executor analog:
    parse -> bind -> normalize -> build -> run), on `device` (CUDA
    unless the caller passes one)."""
    from cockroach_tpu_torch.sql.plan import run

    return run(plan_sql(sql, catalog), catalog, capacity, mesh=mesh,
               device=device)


# --------------------------------------------------------- changefeed bind

_CHANGEFEED_OPTIONS = {
    "resolved",          # emit resolved-timestamp messages
    "sink",              # 'file:<dir>' or a memory-sink token
    "max_polls",         # finite feed: stop after N poll cycles
    "target_wall",       # finite feed: stop once frontier.wall >= this
    "poll_interval_ms",  # sleep between poll cycles
    "once",              # single poll then SUCCEEDED
    "run",               # run inline via adopt_and_run (default for
                         # finite feeds)
    "limit",             # EXPERIMENTAL CHANGEFEED: row budget
}


def bind_changefeed(ast, catalog):
    """Resolve CREATE/EXPERIMENTAL CHANGEFEED against the catalog: the
    target table must exist and every option must be known (the
    reference rejects unknown changefeed options at plan time too)."""
    desc = catalog.desc(ast.table)
    unknown = set(ast.options) - _CHANGEFEED_OPTIONS
    if unknown:
        raise BindError(
            f"unknown changefeed option(s): {', '.join(sorted(unknown))}")
    return desc, dict(ast.options)
