"""Device-maintained incremental materialized views.

Counterpart of cockroach_tpu/sql/matview.py. `CREATE MATERIALIZED VIEW v
AS SELECT g..., agg(x) AS a... FROM t [WHERE simple predicates] GROUP BY
g...` keeps the standing aggregate's group state on the device
(ops/view_fold.py `GroupState`, on the session's device) and absorbs
each write-delta batch with one scatter fold instead of re-executing
the query. The delta source is the changefeed pipeline's engine replay
(sql/changefeed.py `EngineDeltaSource.endpoints`): for every key changed
in (frontier, horizon] it yields the visible row AT the view's frontier
(what the state reflects, folded out with sign -1, the count-per-group
retraction) and AT the horizon (folded in with sign +1); intermediate
versions cancel and never reach the device.

Any fold failure (a retraction under MIN/MAX, which is not incrementally
computable; group-key packing overflow; the MAX_GROUPS refusal; an
injected "view.fold" fault outliving its retry budget) degrades to a
full re-scan: the state is rebuilt, on the same device, from every
visible row at the horizon. The re-scan is the bit-exact oracle (the
same exact int64 sums and counts and the ops/agg.py float32 AVG), so
fold and re-scan agree bit for bit with the engine's own GROUP BY. Each
re-scan is counted (`rescans`, `matview_rescan_total`).

Reads serve from a snapshot memoized on the fold generation: idle polls
(frontier advances, no data change) keep the serving image; only an
actual fold rotates it.

Supported shape (checked at CREATE; anything else is a BindError, not a
silent wrong answer): single table; 1-2 NOT NULL / pk group columns of
int/string/date; aliased aggregates COUNT(*) / COUNT / SUM / MIN / MAX
over int, decimal or date columns and AVG over int columns; WHERE
limited to AND-ed comparisons of a column against a literal.

View definitions persist durably in the 0xFFC0 system keyspace; the
group state itself is volatile and rebuilt on first read after restart
(a re-scan, counted as such).

Departures from the JAX module: after a re-scan the JAX view compiles
its delta-fold program through the plan vault; the port runs one
all-padding fold at the new state's shape instead (ops/view_fold.py
`warm_fold`). A refresh takes its version and horizon inside the
store's write window (storage/mvcc.py `write_window`), as the
changefeed's source does.
"""

from __future__ import annotations

import json
from decimal import ROUND_HALF_UP, Decimal
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.coldata.batch import (
    FLOAT, INT, Field, Kind, Schema,
)
from cockroach_tpu_torch.ops import view_fold
from cockroach_tpu_torch.ops.view_fold import FoldUnsupported, GroupState
from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.sql.bind import BindError
from cockroach_tpu_torch.sql.changefeed import EngineDeltaSource
from cockroach_tpu_torch.storage.mvcc import encode_key
from cockroach_tpu_torch.util.fault import maybe_fail
from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.metric import default_registry
from cockroach_tpu_torch.util.retry import with_retry

MATVIEW_TABLE = 0xFFC0  # view-definition system keyspace

_AGG_KINDS = ("count", "sum", "avg", "min", "max")
_GROUP_TYPES = (Kind.INT, Kind.STRING, Kind.DATE)
_SUMMABLE = (Kind.INT, Kind.DECIMAL)
_ORDERED = (Kind.INT, Kind.DECIMAL, Kind.DATE)


class _Metrics:
    def __init__(self):
        reg = default_registry()
        self.folds = reg.counter(
            "matview_fold_total",
            "incremental delta folds applied to materialized views")
        self.rescans = reg.counter(
            "matview_rescan_total",
            "full re-scan rebuilds of materialized-view state")


_metrics = _Metrics()


def _type_of(tname: str):
    from cockroach_tpu_torch.sql.session import _type_of as f

    return f(tname)


# ------------------------------------------------------------- definition

class MatViewDef:
    """Validated view shape: which columns group, which fold, and the
    compiled WHERE filter over raw codec fields."""

    def __init__(self, view_id: int, name: str, sql: str):
        self.id = view_id
        self.name = name
        self.sql = sql
        stmt = P.Parser(sql).parse()
        if not isinstance(stmt, P.SelectStmt):
            raise BindError("materialized view body must be a SELECT")
        self.stmt = stmt

    def encode(self) -> bytes:
        return json.dumps({"id": self.id, "name": self.name,
                           "sql": self.sql}).encode()

    @staticmethod
    def decode(raw: bytes) -> "MatViewDef":
        d = json.loads(raw.decode())
        return MatViewDef(d["id"], d["name"], d["sql"])

    def analyze(self, desc) -> "_Shape":
        return _Shape(self.stmt, desc)


class _Shape:
    """The fold plan for one view against the current descriptor."""

    def __init__(self, stmt: P.SelectStmt, desc):
        if len(stmt.tables) != 1 or stmt.tables[0].how != "inner" \
                or stmt.tables[0].on is not None:
            raise BindError("materialized views take exactly one table")
        if stmt.having is not None or stmt.order_by or stmt.distinct \
                or stmt.limit is not None or stmt.offset:
            raise BindError("materialized views support only "
                            "SELECT ... [WHERE ...] GROUP BY ...")
        if not stmt.group_by:
            raise BindError("materialized views need a GROUP BY")
        self.desc = desc
        cols = dict(desc.visible_columns())
        self.group_cols: List[str] = []
        for g in stmt.group_by:
            if not isinstance(g, P.ColRef):
                raise BindError("GROUP BY must name plain columns")
            cname = g.name
            if cname not in cols:
                raise BindError(f"unknown column {cname!r}")
            ty = _type_of(cols[cname])
            if ty.kind not in _GROUP_TYPES:
                raise BindError(
                    f"cannot group a materialized view on {ty!r}")
            if cname != desc.pk and desc.nullable(cname):
                raise BindError(
                    f"group column {cname!r} must be NOT NULL")
            self.group_cols.append(cname)
        if len(self.group_cols) > 2:
            raise BindError("materialized views group on at most "
                            "2 columns")
        # select list: the group columns (in order), then aliased aggs
        self.aggs: List[Tuple[str, Optional[str], str]] = []
        for i, (item, alias) in enumerate(stmt.items):
            if i < len(self.group_cols):
                if not (isinstance(item, P.ColRef)
                        and item.name == self.group_cols[i]):
                    raise BindError(
                        "select list must lead with the GROUP BY "
                        "columns in order")
                continue
            if not (isinstance(item, P.FuncCall)
                    and item.name in _AGG_KINDS):
                raise BindError(
                    f"select item {i + 1} must be an aggregate")
            if item.distinct:
                raise BindError("DISTINCT aggregates not supported "
                                "in materialized views")
            if alias is None:
                raise BindError(
                    f"aggregate {item.name}() needs an AS alias")
            if item.star:
                if item.name != "count":
                    raise BindError("only count(*) may take *")
                self.aggs.append(("count", None, alias))
                continue
            if len(item.args) != 1 \
                    or not isinstance(item.args[0], P.ColRef):
                raise BindError("aggregates take one plain column")
            cname = item.args[0].name
            if cname not in cols:
                raise BindError(f"unknown column {cname!r}")
            ty = _type_of(cols[cname])
            if item.name in ("sum",) and ty.kind not in _SUMMABLE:
                raise BindError(f"sum over {ty!r} not supported")
            if item.name == "avg" and ty.kind is not Kind.INT:
                raise BindError("avg is fold-exact over int columns "
                                "only")
            if item.name in ("min", "max") and ty.kind not in _ORDERED:
                raise BindError(f"{item.name} over {ty!r} not supported")
            if item.name == "count" and ty.kind is Kind.VECTOR:
                raise BindError("count over vector not supported")
            self.aggs.append((item.name, cname, alias))
        if not self.aggs:
            raise BindError("materialized views need at least one "
                            "aggregate")
        self.has_minmax = any(k in ("min", "max") for k, _c, _a in
                              self.aggs)
        # distinct agg input columns -> fold input lanes
        self.inputs: List[str] = []
        for _k, c, _a in self.aggs:
            if c is not None and c not in self.inputs:
                self.inputs.append(c)
        self.n_inputs = max(1, len(self.inputs))
        self.where = _compile_where(stmt.where, desc) \
            if stmt.where is not None else None
        vcols = desc.value_columns()
        self._vidx = {c: i for i, (c, _t) in enumerate(vcols)}

    # --- raw-field accessors ------------------------------------------

    def _field(self, pk: int, fields: List[int], cname: str):
        if cname == self.desc.pk:
            return pk
        return self.desc.field_value(fields, self._vidx[cname])

    def delta_row(self, pk: int, fields: List[int]):
        """(packed-able key cols, input vals, input valid) for one row,
        or None when the WHERE filter drops it."""
        if self.where is not None and not self.where(pk, fields):
            return None
        keys = []
        for c in self.group_cols:
            v = self._field(pk, fields, c)
            if v is None:
                raise FoldUnsupported("NULL group key")
            keys.append(int(v))
        vals = np.zeros(self.n_inputs, np.int64)
        valid = np.zeros(self.n_inputs, bool)
        for j, c in enumerate(self.inputs):
            v = self._field(pk, fields, c)
            if v is not None:
                vals[j] = int(v)
                valid[j] = True
        return keys, vals, valid


def _encode_literal(ty, node: P.Node) -> Optional[int]:
    """Literal -> the raw int64 code the codec stores, so WHERE
    comparisons happen in exactly the engine's value domain."""
    if isinstance(node, P.Unary) and node.op == "-":
        inner = _encode_literal(ty, node.arg)
        return None if inner is None else -inner
    if isinstance(node, P.DateLit):
        return node.days
    if isinstance(node, P.Num):
        if ty.kind is Kind.DECIMAL:
            return int(Decimal(str(node.value)).scaleb(ty.scale)
                       .to_integral_value(ROUND_HALF_UP))
        if node.is_float and not float(node.value).is_integer():
            # int(1.5) would compile x = 1.5 into x = 1 and silently
            # match the wrong rows
            raise BindError(
                f"non-integral literal {node.text} cannot compare "
                f"against {ty!r} in a materialized-view WHERE")
        return int(node.value)
    if isinstance(node, P.Str) and ty.kind is Kind.DATE:
        import datetime

        d = datetime.date.fromisoformat(node.value)
        return (d - datetime.date(1970, 1, 1)).days
    return None


def _compile_where(node: P.Node, desc) -> Callable:
    """AND-tree of (col op literal) -> predicate over (pk, raw fields).
    Comparisons run on raw codec values (scaled decimals, epoch days),
    which is exactly the engine's comparison domain for these types."""
    cols = dict(desc.visible_columns())
    vidx = {c: i for i, (c, _t) in enumerate(desc.value_columns())}

    def compile_node(n) -> Callable:
        if isinstance(n, P.Binary) and n.op == "and":
            l, r = compile_node(n.left), compile_node(n.right)
            return lambda pk, f: l(pk, f) and r(pk, f)
        if isinstance(n, P.Binary) and n.op in ("=", "<>", "!=", "<",
                                                "<=", ">", ">="):
            col, lit = n.left, n.right
            flip = False
            if not isinstance(col, P.ColRef):
                col, lit, flip = lit, col, True
            if not isinstance(col, P.ColRef) or col.name not in cols:
                raise BindError("materialized-view WHERE supports only "
                                "column-vs-literal comparisons")
            ty = _type_of(cols[col.name])
            if ty.kind is Kind.STRING:
                if n.op not in ("=", "<>", "!=") \
                        or not isinstance(lit, P.Str):
                    raise BindError("string WHERE supports = / <> only")
                want = lit.value
                d = desc.dicts.get(col.name, [])
                code = d.index(want) if want in d else None
                name = col.name

                def pred(pk, f, code=code, name=name, eq=(n.op == "=")):
                    v = pk if name == desc.pk \
                        else desc.field_value(f, vidx[name])
                    if v is None:
                        return False
                    hit = (code is not None and v == code)
                    return hit if eq else not hit

                return pred
            if ty.kind not in (Kind.INT, Kind.DECIMAL, Kind.DATE):
                raise BindError(f"WHERE over {ty!r} not supported in "
                                "materialized views")
            enc = _encode_literal(ty, lit)
            if enc is None:
                raise BindError("materialized-view WHERE needs literal "
                                "comparands")
            op = n.op
            if flip:
                op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(
                    op, op)
            name = col.name

            def pred(pk, f, enc=enc, op=op, name=name):
                v = pk if name == desc.pk \
                    else desc.field_value(f, vidx[name])
                if v is None:
                    return False
                if op == "=":
                    return v == enc
                if op in ("<>", "!="):
                    return v != enc
                if op == "<":
                    return v < enc
                if op == "<=":
                    return v <= enc
                if op == ">":
                    return v > enc
                return v >= enc

            return pred
        raise BindError("materialized-view WHERE supports only AND-ed "
                        "column-vs-literal comparisons")

    return compile_node(node)


# ---------------------------------------------------------------- runtime

class MatView:
    """One live view: device group state + frontier over the source."""

    def __init__(self, vdef: MatViewDef, catalog, device=None):
        self.vdef = vdef
        self.catalog = catalog
        self.device = device
        self.table = vdef.stmt.tables[0].name
        self.frontier = Timestamp()
        self.state: Optional[GroupState] = None
        self.shape: Optional[_Shape] = None
        self.folds = 0
        self.rescans = 0
        self._last_version: Optional[int] = None
        self._serve_cache: Optional[Tuple[tuple, dict, Schema]] = None

    # ------------------------------------------------------------ deltas

    def _source(self) -> EngineDeltaSource:
        desc = self.catalog.desc(self.table)
        return EngineDeltaSource(self.catalog.store, desc.table_id)

    def _delta_batch(self, frontier: Timestamp, horizon: Timestamp):
        """endpoints -> (packed, sign, vals, valid) fold arrays."""
        shape = self.shape
        keys, signs, vals, valid = [], [], [], []
        retractions = 0
        for pk, old_f, new_f in self._source().endpoints(frontier,
                                                         horizon):
            for fields, sign in ((old_f, -1), (new_f, +1)):
                if fields is None:
                    continue
                row = shape.delta_row(pk, fields)
                if row is None:
                    continue
                k, v, ok = row
                keys.append(k)
                signs.append(sign)
                vals.append(v)
                valid.append(ok)
                if sign < 0:
                    retractions += 1
        if retractions and shape.has_minmax:
            raise FoldUnsupported(
                "retraction under MIN/MAX needs a re-scan")
        if not keys:
            return None
        packed = view_fold.pack_keys(
            [np.asarray([k[i] for k in keys], np.int64)
             for i in range(len(shape.group_cols))])
        return (packed, np.asarray(signs, np.int64),
                np.stack(vals, axis=1), np.stack(valid, axis=1))

    # ----------------------------------------------------------- refresh

    def refresh(self) -> None:
        """Pull the source up to now: incremental fold when possible,
        full re-scan rebuild otherwise. Always leaves the state exactly
        at the new horizon."""
        store = self.catalog.store
        desc = self.catalog.desc(self.table)
        # version BEFORE the horizon (and before sync(), which releases
        # the GIL), mirroring EngineDeltaSource.poll: a write racing
        # this refresh leaves the cached version stale, so the next
        # refresh folds its window instead of the fast-path skipping it
        # while the frontier advances past it (silent divergence).
        with store.write_window():  # no write mid-apply below horizon
            ver = store.table_version(desc.table_id)
            horizon = store.clock.now()
        store.sync()
        if self.state is not None and ver == self._last_version:
            self.frontier = horizon  # idle: resolved progress only
            return
        if self.state is None or self.shape is None:
            self._rescan(horizon)
        else:
            try:
                batch = self._delta_batch(self.frontier, horizon)
                if batch is not None:
                    def once():
                        maybe_fail("view.fold")

                    with_retry(once, name="view.fold")
                    self.state.fold(*batch)
                    if not self.state.counts_consistent():
                        raise FoldUnsupported(
                            "negative group count after fold")
                    self.folds += 1
                    _metrics.folds.inc()
                    self._serve_cache = None
                self.frontier = horizon
            except FoldUnsupported:
                self._rescan(horizon)
            except Exception:
                # retry budget exhausted on the fold seam (or a device
                # refusal): the re-scan oracle is always available
                self._rescan(horizon)
        self._last_version = ver

    def _rescan(self, horizon: Timestamp) -> None:
        """Rebuild group state from every visible row at `horizon` — the
        bit-exact oracle and the degraded path for unfoldable deltas."""
        desc = self.catalog.desc(self.table)
        self.shape = self.vdef.analyze(desc)
        state = GroupState(self.shape.n_inputs, self.device)
        keys, vals, valid = [], [], []
        for pk, _old, new_f in self._source().endpoints(Timestamp(),
                                                        horizon):
            if new_f is None:
                continue
            row = self.shape.delta_row(pk, new_f)
            if row is None:
                continue
            k, v, ok = row
            keys.append(k)
            vals.append(v)
            valid.append(ok)
        if keys:
            packed = view_fold.pack_keys(
                [np.asarray([k[i] for k in keys], np.int64)
                 for i in range(len(self.shape.group_cols))])
            state.fold(packed, np.ones(len(keys), np.int64),
                       np.stack(vals, axis=1), np.stack(valid, axis=1))
        self.state = state
        self.frontier = horizon
        self.rescans += 1
        _metrics.rescans.inc()
        self._serve_cache = None
        # the first delta finds the fold's buffers at this shape
        view_fold.warm_fold(state, view_fold.delta_bucket(1))

    # ------------------------------------------------------------- serve

    def serve(self) -> Tuple[dict, Schema]:
        """(payload, schema) for SELECT * FROM <view>, rows sorted by
        group key. Memoized on the fold generation — the write-stable
        serving identity: idle frontier advances keep the image."""
        desc = self.catalog.desc(self.table)
        shape = self.shape
        key = (id(self.state), self.state.generation)
        if self._serve_cache is not None and self._serve_cache[0] == key:
            return self._serve_cache[1], self._serve_cache[2]
        snap = self.state.read()
        gcols = view_fold.unpack_keys(snap["keys"],
                                      len(shape.group_cols))
        cols = dict(desc.visible_columns())
        payload: Dict[str, np.ndarray] = {}
        fields: List[Field] = []
        dicts: Dict[str, np.ndarray] = {}
        for i, cname in enumerate(shape.group_cols):
            ty = _type_of(cols[cname])
            ref = None
            if ty.kind is Kind.STRING:
                ref = f"{desc.name}.{cname}"
                dicts[ref] = np.asarray(desc.dicts[cname], dtype=object)
            fields.append(Field(cname, ty, dict_ref=ref))
            payload[cname] = gcols[i]
        in_idx = {c: j for j, c in enumerate(shape.inputs)}
        for kind, cname, alias in shape.aggs:
            if kind == "count" and cname is None:
                payload[alias] = snap["counts"].astype(np.int64)
                fields.append(Field(alias, INT))
                continue
            j = in_idx[cname]
            ity = _type_of(cols[cname])
            cnt = snap["acnt"][j]
            if kind == "count":
                payload[alias] = cnt.astype(np.int64)
                fields.append(Field(alias, INT))
            elif kind == "sum":
                payload[alias] = snap["asum"][j]
                payload[alias + "__valid"] = cnt > 0
                fields.append(Field(alias, ity, nullable=True))
            elif kind == "avg":
                payload[alias] = view_fold.avg_f32(snap["asum"][j], cnt)
                payload[alias + "__valid"] = cnt > 0
                fields.append(Field(alias, FLOAT, nullable=True))
            elif kind == "min":
                payload[alias] = snap["amin"][j]
                payload[alias + "__valid"] = cnt > 0
                fields.append(Field(alias, ity, nullable=True))
            else:  # max
                payload[alias] = snap["amax"][j]
                payload[alias + "__valid"] = cnt > 0
                fields.append(Field(alias, ity, nullable=True))
        schema = Schema(fields, dicts)
        self._serve_cache = (key, payload, schema)
        return payload, schema


# ---------------------------------------------------------------- manager

class MatViewManager:
    """Catalog-attached registry: durable definitions, live states (on
    `device`, CUDA unless the caller passes one)."""

    def __init__(self, catalog, device=None):
        self.catalog = catalog
        self.device = device
        self.views: Dict[str, MatView] = {}
        self._load()

    def _span(self):
        return encode_key(MATVIEW_TABLE, 0), encode_key(MATVIEW_TABLE + 1,
                                                        0)

    def _load(self) -> None:
        eng = self.catalog.store.engine
        lo, hi = self._span()
        for key in eng.scan_keys(lo, hi, Timestamp.MAX):
            hit = eng.get(key, Timestamp.MAX)
            if hit is None or not hit[0]:
                continue
            vdef = MatViewDef.decode(hit[0])
            self.views[vdef.name] = MatView(vdef, self.catalog,
                                            self.device)

    def _save(self, vdef: MatViewDef) -> None:
        store = self.catalog.store
        store.engine.put(encode_key(MATVIEW_TABLE, vdef.id),
                         store.clock.now(), vdef.encode())
        store.sync()

    def create(self, name: str, sql: str,
               if_not_exists: bool = False) -> MatView:
        if name in self.views:
            if if_not_exists:
                return self.views[name]
            raise BindError(f"materialized view {name!r} already exists")
        if name in getattr(self.catalog, "_descs", {}):
            raise BindError(f"{name!r} is a table")
        view_id = 1 + max((v.vdef.id for v in self.views.values()),
                          default=0)
        vdef = MatViewDef(view_id, name, sql)
        mv = MatView(vdef, self.catalog, self.device)
        # validate the shape against the live descriptor before persist
        vdef.analyze(self.catalog.desc(mv.table))
        self._save(vdef)
        self.views[name] = mv
        mv.refresh()  # initial build (counts as the first re-scan)
        return mv

    def drop(self, name: str, if_exists: bool = False) -> None:
        mv = self.views.pop(name, None)
        if mv is None:
            if if_exists:
                return
            raise BindError(f"no materialized view {name!r}")
        store = self.catalog.store
        store.engine.delete(encode_key(MATVIEW_TABLE, mv.vdef.id),
                            store.clock.now())
        store.sync()

    def get(self, name: str) -> Optional[MatView]:
        return self.views.get(name)

    def read(self, name: str) -> Tuple[dict, Schema]:
        mv = self.views[name]
        mv.refresh()
        return mv.serve()

    def report(self) -> dict:
        """Per-view counters for the chaos report / status surface."""
        return {name: {"folds": mv.folds, "rescans": mv.rescans,
                       "groups": (len(mv.state.keys)
                                  if mv.state is not None else 0),
                       "frontier": [mv.frontier.wall,
                                    mv.frontier.logical]}
                for name, mv in self.views.items()}
