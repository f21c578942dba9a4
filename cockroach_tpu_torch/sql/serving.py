"""Cross-session continuous batching: the shared serving queue.

Counterpart of cockroach_tpu/sql/serving.py: `BatchSpec`, the matchers
(`_pk_bounds` to `match_batchable`), `ServingQueue`, `spec_schema`,
`probe`, `_class_vkey`, `maybe_submit` and `match_bound_sql`, with the
JAX module's names, settings and metrics. Warm prepared micro-queries
arriving on DIFFERENT pgwire connections coalesce into one batched
device dispatch (exec/fused.py's serving runners: one computation over a
(B, window) lane grid where the JAX runners `jax.vmap` one lane
function) and de-multiplex back to each waiting session with
bit-identical results.

The batchable class is a FAMILY of compatibility classes, each with its
own batched runner (exec/fused.py):

  scan    SELECT <int cols> FROM t WHERE pk range [ORDER BY pk] [LIMIT]
          — each lane gathers its own [lo, hi) window (point lookups
          ride a window-1 variant)
  agg     SELECT agg(col), ... FROM t WHERE pk range — each lane folds
          its own range through the ops/agg.py scalar-agg formulas
  topk    scan shape + ORDER BY <non-pk int col> [DESC] LIMIT k — each
          lane sorts its window with ops/sort.py's lexicographic keys
  vector  SELECT <int cols> FROM t ORDER BY vcol <-> '[..]' LIMIT k —
          concurrent queries against the same (table, vcol, metric, k)
          become ONE multi-query distance + top-K dispatch, the
          ops/vector.py ExactSearcher shape (exact path only: ANN-mode
          ranking is nprobe-dependent and stays serial)

plus parameterized EXECUTE binds: pgwire Bind substitutes parameters and
re-matches the BOUND text, so prepared statements differing only in bind
values join their class's group directly. Groups are keyed per (class
fingerprint, table, MVCC version, device): a mixed workload keeps every
table's groups independently warm, demux can never cross classes or
tables, and a CPU session and a CUDA session never share a group or a
runner.

Placement (the admission seam): Session.execute marks a statement
serving-exempt when its shared prepared-cache entry carries a batchable
spec — the member thread skips per-statement admission and enqueues here
instead, and the batch LEADER acquires a single admission slot for the
whole batch. Batch formation respects per-session priorities: members
dispatch in (admission priority, arrival) order. Non-batchable
statements bypass the queue untouched.

Cancellation: a cancelled or timed-out MEMBER leaves the queue
immediately (57014 for itself); its lane still computes and is discarded
— lazy mask-out, never a batch-wide 57014. A cancelled leader (drain
included) flushes the window FIRST so queued members are never stranded,
then raises for itself. Any batch-level failure (armed fault past
retries, admission shed, image build error) degrades the members to the
serial per-session path, on the session's own device, instead of
poisoning them.

Departures from the JAX module:
  - the runners are keyed by device as well (`_device_key`), and built
    on the leader session's device (CUDA unless the session has one);
  - a leader whose key has a dispatch running waits for it with its
    group still open (`_turns`), so members keep joining: the port's
    dispatch holds the runner for its host-side launches and its
    readback, where a JAX dispatch is queued asynchronously, and without
    the wait concurrent leaders of one key dispatched one member each in
    turn;
  - caching a runner drops the runners of the same shape and device
    under other table versions (dead once the version moved), where the
    JAX queue leaves them to its 8-entry LRU, which a write burst over
    the frozen-snapshot classes fills, evicting live runners;
  - a runner's per-bucket "program" is a record of the padded shape it
    has run (exec/fused.py `_BucketPrograms`); `prewarm` fills one entry
    per bucket, as the JAX ladder compiles one executable per bucket;
  - not ported yet (ROADMAP.md queue 1, item 8e): `prewarm_async` (the
    plan_prewarm job) and `_note_serving_placement` (the placement cache
    it writes to); `prewarm_shape` and `prewarm_tasks`, the job's
    entries, are here.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.ops.vector import parse_vector_literal
from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.util import cancel as _cancel
from cockroach_tpu_torch.util import retry as _retry
from cockroach_tpu_torch.util.fault import maybe_fail
from cockroach_tpu_torch.util.metric import default_registry
from cockroach_tpu_torch.util.settings import VECTOR_ANN, Settings

SERVING_ENABLED = Settings.register(
    "sql.serving.enabled",
    True,
    "coalesce compatible warm prepared statements from concurrent "
    "sessions into one batched device dispatch",
)
COALESCE_WINDOW_MS = Settings.register(
    "sql.serving.coalesce_window_ms",
    -1.0,
    "how long a batch leader holds the coalescing window open for more "
    "members before dispatching (skipped when it is the only in-flight "
    "submitter, so a lone client pays no window latency); negative = "
    "adaptive — a PER-CLASS EWMA of submit inter-arrival time clamped "
    "to [0, sql.serving.coalesce_window_max_ms], so sparse traffic pays "
    "near-zero window latency and dense bursts coalesce deeply, and a "
    "chatty point-lookup stream cannot shrink the window under slower "
    "vector/aggregate arrivals",
)
COALESCE_WINDOW_MAX_MS = Settings.register(
    "sql.serving.coalesce_window_max_ms",
    2.0,
    "ceiling of the adaptive coalescing window (and its cold-start "
    "value, until the EWMA has seen an arrival interval)",
)
# adaptive window shape: window ~= K inter-arrival EWMAs — enough room
# for a handful of concurrent submitters to land in one flush without
# stretching a sparse stream's latency to the ceiling
_WINDOW_EWMA_ALPHA = 0.2
_WINDOW_K = 4.0
MAX_BATCH = Settings.register(
    "sql.serving.max_batch",
    64,
    "lanes per batched serving dispatch (pow2-padded); a flush "
    "larger than this executes in several priority-ordered dispatches",
)

# widest static per-op row window that stays batchable; the floor makes
# every narrow range share ONE program shape (the pow2 ladder above it
# adds at most log2(MAX_WINDOW/MIN_WINDOW) more)
MAX_WINDOW = 1024
MIN_WINDOW = 128
_RUNNER_ENTRIES = 8     # resident serving images (LRU, like EXEC_CACHE)
_FOLLOWER_BAIL_S = 30.0  # leader presumed dead -> degrade to serial

# the batch-compatibility classes ("execute" is a submission SOURCE —
# bind-path members join one of these four groups — but gets its own
# metric family so the bench/chaos reports show EXECUTE coalescing)
CLASSES = ("scan", "agg", "topk", "vector")
_METRIC_CLASSES = CLASSES + ("execute",)

# batchable scalar aggregates (must stay the exact set ops/agg.py's
# _scalar_agg implements — the lane formulas mirror it function by
# function)
_BATCH_AGGS = ("count", "sum", "min", "max", "avg")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _session_device(session):
    """The device a session's statements run on (CUDA unless it has
    one)."""
    from cockroach_tpu_torch import resolve_device

    return resolve_device(getattr(session, "device", None))


def _device_key(session) -> tuple:
    dev = _session_device(session)
    return (dev.type, dev.index)


class BatchSpec:
    """The batchable-statement fingerprint of one prepared entry, tagged
    with its compatibility class (`kind`). `shape_key` — the class tag
    plus the class's static fingerprint — joined with the table's
    MVCC scan-cache key is the batch-compatibility group; everything
    else (`lo`/`hi`/`limit`/`qvec`) is per-member lane data."""

    __slots__ = ("kind", "table", "cols", "lo", "hi", "limit", "window",
                 "order_col", "descending", "aggs", "names", "vcol",
                 "metric", "qvec", "shape_key")

    def __init__(self, kind: str, table: str, cols: Tuple[str, ...],
                 lo: int, hi: int, limit: Optional[int], window: int,
                 order_col: Optional[str] = None,
                 descending: bool = False,
                 aggs: Optional[tuple] = None,
                 names: Optional[Tuple[str, ...]] = None,
                 vcol: Optional[str] = None,
                 metric: Optional[str] = None,
                 qvec=None):
        self.kind = kind
        self.table = table
        self.cols = tuple(cols)
        self.lo = lo
        self.hi = hi
        self.limit = limit
        self.window = window
        self.order_col = order_col
        self.descending = bool(descending)
        self.aggs = (None if aggs is None else tuple(
            (f, None if c is None else str(c)) for f, c in aggs))
        self.names = None if names is None else tuple(names)
        self.vcol = vcol
        self.metric = metric
        self.qvec = qvec
        if kind == "scan":
            self.shape_key = ("scan", table, self.cols, window)
        elif kind == "agg":
            self.shape_key = ("agg", table, self.aggs, self.names,
                              window)
        elif kind == "topk":
            self.shape_key = ("topk", table, self.cols, order_col,
                              self.descending, window)
        elif kind == "vector":
            self.shape_key = ("vector", table, self.cols, vcol, metric,
                              window)
        else:
            raise ValueError(f"unknown batch class {kind!r}")


def _pk_bounds(where, pk: str) -> Optional[Tuple[int, int]]:
    """Normalize a conjunction of integer comparisons on the pk column
    into one [lo, hi) range; None when any conjunct is something else."""
    lo = None
    hi = None
    stack = [where]
    while stack:
        n = stack.pop()
        if isinstance(n, P.Binary) and n.op == "and":
            stack.append(n.left)
            stack.append(n.right)
            continue
        if not isinstance(n, P.Binary):
            return None
        op, l, r = n.op, n.left, n.right
        if isinstance(l, P.Num) and isinstance(r, P.ColRef):
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                  "=": "="}.get(op)
            l, r = r, l
        if (op not in (">=", ">", "<", "<=", "=")
                or not isinstance(l, P.ColRef)
                or not isinstance(r, P.Num)
                or l.qualifier is not None or l.name != pk
                or r.is_float):
            return None
        v = int(r.value)
        if op == ">=":
            lo = v if lo is None else max(lo, v)
        elif op == ">":
            lo = v + 1 if lo is None else max(lo, v + 1)
        elif op == "<":
            hi = v if hi is None else min(hi, v)
        elif op == "<=":
            hi = v + 1 if hi is None else min(hi, v + 1)
        else:  # =
            lo = v if lo is None else max(lo, v)
            hi = v + 1 if hi is None else min(hi, v + 1)
    if lo is None or hi is None:
        return None
    return lo, hi


def _int_projection(ast, types) -> Optional[Tuple[str, ...]]:
    """The select list as a tuple of distinct bare INT columns, or None
    when anything fancier appears (alias, qualifier, expression)."""
    cols: List[str] = []
    for item, alias in ast.items:
        if (alias is not None or not isinstance(item, P.ColRef)
                or item.qualifier is not None):
            return None
        if types.get(item.name) != "int" or item.name in cols:
            return None
        cols.append(item.name)
    return tuple(cols) if cols else None


def _range_window(span: int, eff: int) -> Optional[int]:
    """The static lane window for a pk range: 1 for point lookups (their
    own single-row class), else the pow2 of the effective row count with
    the MIN_WINDOW floor; None when the range outgrows MAX_WINDOW."""
    if span <= 1:
        # point lookup (WHERE pk = $1, normalized to [pk, pk+1)): its
        # own single-row batch class — point-heavy YCSB traffic rides
        # the same batched dispatch without paying MIN_WINDOW-wide lanes
        return 1
    window = max(MIN_WINDOW, _pow2(max(eff, 1)))
    return None if window > MAX_WINDOW else window


def _match_scan_or_topk(ast, table: str, pk: str,
                        types) -> Optional[BatchSpec]:
    cols = _int_projection(ast, types)
    if cols is None or ast.where is None:
        return None
    bounds = _pk_bounds(ast.where, pk)
    if bounds is None:
        return None
    lo, hi = bounds
    limit = ast.limit
    if limit is not None and limit < 0:
        return None
    span = max(hi - lo, 0)
    order_col = None
    descending = False
    if ast.order_by:
        ob = ast.order_by
        if (len(ob) != 1 or not isinstance(ob[0][0], P.ColRef)
                or ob[0][0].qualifier is not None):
            return None
        oc = ob[0][0].name
        if oc == pk:
            if ob[0][1]:
                return None  # pk DESC would demux reversed — serial
        else:
            # the topk class: non-pk INT order key, either direction,
            # LIMIT required (an unbounded non-pk sort is a full sort,
            # not a serving-shaped micro-query)
            if types.get(oc) != "int" or limit is None:
                return None
            order_col = oc
            descending = bool(ob[0][1])
    if order_col is None:
        eff = span if limit is None else min(span, limit)
        window = _range_window(span, eff)
        if window is None:
            return None
        return BatchSpec("scan", table, cols, lo, hi, limit, window)
    # topk: the lane must HOLD the whole range before sorting, so the
    # window comes from the span alone — LIMIT only trims the demux
    window = _range_window(span, span)
    if window is None:
        return None
    return BatchSpec("topk", table, cols, lo, hi, limit, window,
                     order_col=order_col, descending=descending)


def _match_agg(ast, table: str, pk: str, types) -> Optional[BatchSpec]:
    """`SELECT agg(col), ... FROM t WHERE pk range` — the batchable
    scalar-aggregate class: every select item a plain count/sum/min/
    max/avg over a bare INT column (or count(*)), distinct output
    names, no ORDER BY / LIMIT (a scalar aggregate is one row)."""
    if ast.order_by or ast.limit is not None or ast.where is None:
        return None
    aggs: List[tuple] = []
    names: List[str] = []
    for item, alias in ast.items:
        f = item  # caller guarantees every item is a FuncCall
        if f.distinct or getattr(f, "params", None):
            return None
        if f.name not in _BATCH_AGGS:
            return None
        if f.star:
            if f.name != "count" or f.args:
                return None
            aggs.append(("count_star", None))
        else:
            if len(f.args) != 1:
                return None
            a = f.args[0]
            if (not isinstance(a, P.ColRef) or a.qualifier is not None
                    or types.get(a.name) != "int"):
                return None
            aggs.append((f.name, a.name))
        name = alias or f.name
        if name in names:
            return None
        names.append(name)
    bounds = _pk_bounds(ast.where, pk)
    if bounds is None:
        return None
    lo, hi = bounds
    span = max(hi - lo, 0)
    window = _range_window(span, span)
    if window is None:
        return None
    return BatchSpec("agg", table, (), lo, hi, None, window,
                     aggs=tuple(aggs), names=tuple(names))


def _match_vector(ast, table: str, types) -> Optional[BatchSpec]:
    """`SELECT <int cols> FROM t ORDER BY vcol <-> '[..]' LIMIT k` —
    the batched vector top-K class. Exact path only: with
    sql.vector.ann_topk on, the per-statement plan ranks via the
    clustered index (nprobe-dependent), so ANN-mode vector statements
    stay serial (known residue)."""
    if bool(Settings().get(VECTOR_ANN)):
        return None
    if ast.where is not None or ast.limit is None or ast.limit < 1:
        return None
    (expr, desc), = ast.order_by
    if desc:
        return None
    lhs, rhs = expr.left, expr.right
    if isinstance(lhs, P.Str) and isinstance(rhs, P.ColRef):
        lhs, rhs = rhs, lhs
    if not (isinstance(lhs, P.ColRef) and lhs.qualifier is None
            and isinstance(rhs, P.Str)):
        return None
    vty = types.get(lhs.name, "")
    if not (isinstance(vty, str) and vty.startswith("vector(")):
        return None
    dim = int(vty[7:-1])
    try:
        q = parse_vector_literal(rhs.value)
    except ValueError:
        return None
    if len(q) != dim:
        return None
    cols = _int_projection(ast, types)
    if cols is None:
        return None
    k = int(ast.limit)
    if k > MAX_WINDOW:
        return None
    metric = "l2" if expr.op == "<->" else "cos"
    return BatchSpec("vector", table, cols, 0, 0, k, k, vcol=lhs.name,
                     metric=metric, qvec=np.asarray(q, np.float32))


def match_batchable(ast, catalog, capacity: int) -> Optional[BatchSpec]:
    """BatchSpec for `ast` when it falls in one of the batch
    compatibility classes (module docstring); None means the statement
    takes the normal per-session path. Common bar for every class:
    single table with a single INT primary key, bare projections, no
    DISTINCT/GROUP BY/HAVING/OFFSET — anything fancier is not a
    serving-shaped micro-query."""
    if not isinstance(ast, P.SelectStmt):
        return None
    if (ast.distinct or ast.group_by or ast.having is not None
            or ast.offset):
        return None
    if len(ast.tables) != 1 or ast.tables[0].on is not None:
        return None
    table = ast.tables[0].name
    try:
        pk_cols = catalog.table_pk(table)
        desc = catalog.desc(table)
    except Exception:  # noqa: BLE001 — non-SessionCatalog / no table
        return None
    if pk_cols is None or len(pk_cols) != 1:
        return None
    pk = pk_cols[0]
    types = dict(desc.visible_columns())
    if types.get(pk) != "int":
        return None
    if ast.items and all(isinstance(i, P.FuncCall)
                         for i, _ in ast.items):
        return _match_agg(ast, table, pk, types)
    if (len(ast.order_by) == 1
            and isinstance(ast.order_by[0][0], P.Binary)
            and ast.order_by[0][0].op in ("<->", "<=>")):
        return _match_vector(ast, table, types)
    return _match_scan_or_topk(ast, table, pk, types)


# ----------------------------------------------------------- the queue --


class _Member:
    __slots__ = ("spec", "prio", "seq", "ev", "result", "error",
                 "fallback", "t_enq", "via")

    def __init__(self, spec: BatchSpec, prio: int, seq: int,
                 via: Optional[str] = None):
        self.spec = spec
        self.prio = prio
        self.seq = seq
        self.ev = threading.Event()
        self.result = None
        self.error = None
        self.fallback = False
        self.t_enq = time.monotonic()
        self.via = via


class ServingQueue:
    """The process-wide coalescing point. submit() is called by session
    threads (pgwire connection threads blocking in Session.execute are
    the natural waiters); the FIRST member of a compatibility group
    becomes its leader, holds the coalescing window open, then flushes
    EVERY queued member of the group — in priority order, in up to
    ceil(n/max_batch) pow2-padded batched dispatches — and delivers each
    member its demuxed rows."""

    def __init__(self):
        self._mu = threading.Lock()
        self._groups: Dict[tuple, List[_Member]] = {}
        # group key -> the lock its dispatches take turns on (_lead)
        self._turns: Dict[tuple, threading.Lock] = {}
        self._seq = itertools.count()
        self._inflight = 0
        # resident (image + batched runner) per compatibility group —
        # the batch-shaped exec-cache variants, keyed alongside (not
        # inside) FusedRunner's per-statement entries because these are
        # shared across every session of the catalog
        self._runners: "OrderedDict[tuple, object]" = OrderedDict()
        self._runners_mu = threading.Lock()
        # true occupancy: real member lanes over dispatched (pow2-padded)
        # lanes — same definition as ScanTopKBatcher.occupancy()
        self.ops_submitted = 0
        self.slots_dispatched = 0
        self.dispatches = 0
        self.cls_ops: Dict[str, int] = {c: 0 for c in _METRIC_CLASSES}
        self.cls_slots: Dict[str, int] = {c: 0 for c in _METRIC_CLASSES}
        self._recent_depth: deque = deque(maxlen=4096)
        self._recent_delay: deque = deque(maxlen=4096)
        # adaptive-window state: PER-CLASS EWMA of submit() inter-arrival
        # time (guarded by _mu; a class is absent until it has seen two
        # arrivals) — global EWMA let a chatty scan stream collapse the
        # window under slower vector/agg arrivals
        self._ewma_interarrival: Dict[str, float] = {}
        self._last_arrival: Dict[str, float] = {}
        reg = default_registry()
        self.batched_dispatch_total = reg.counter(
            "serving.batched_dispatch_total",
            "batched multi-statement serving dispatches")
        self.coalesced_total = reg.counter(
            "serving.coalesced_statements_total",
            "statements served through a batched dispatch")
        self.fallback_total = reg.counter(
            "serving.fallback_total",
            "serving members degraded to the serial per-session path")
        self.occupancy_gauge = reg.gauge(
            "serving.occupancy",
            "real statement lanes per dispatched lane (1.0 = no "
            "padding waste)")
        # per-class metric family: which class coalesces and which falls
        # back ("execute" counts bind-path members inside whatever class
        # group they joined)
        self.cls_metrics: Dict[str, Dict[str, object]] = {}
        for cls in _METRIC_CLASSES:
            self.cls_metrics[cls] = {
                "dispatch": reg.counter(
                    f"serving.batched_dispatch_total.{cls}",
                    f"batched serving dispatches ({cls})"),
                "coalesced": reg.counter(
                    f"serving.coalesced_statements_total.{cls}",
                    f"statements served through a batched dispatch "
                    f"({cls})"),
                "fallback": reg.counter(
                    f"serving.fallback_total.{cls}",
                    f"serving members degraded to the serial path "
                    f"({cls})"),
            }
        self.coalesce_depth = reg.histogram(
            "serving.coalesce_depth",
            "members coalesced per window flush",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        self.queue_delay = reg.histogram(
            "serving.queue_delay_seconds",
            "enqueue-to-result latency of serving members",
            buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1.0, 5.0))

    # -- submission ------------------------------------------------------

    def _observe_arrival(self, kind: str, t: float) -> None:
        """Fold one submit() arrival into its class's inter-arrival
        EWMA (the adaptive-window signal)."""
        with self._mu:
            last = self._last_arrival.get(kind)
            if last is not None:
                dt = t - last
                ew = self._ewma_interarrival.get(kind)
                self._ewma_interarrival[kind] = dt if ew is None else (
                    _WINDOW_EWMA_ALPHA * dt
                    + (1.0 - _WINDOW_EWMA_ALPHA) * ew)
            self._last_arrival[kind] = t

    def submit(self, session, spec: BatchSpec, vkey: tuple,
               via: Optional[str] = None
               ) -> Optional[Dict[str, np.ndarray]]:
        """Serve one warm statement through the batch path. Returns the
        collect()-shaped payload, or None when the member should fall
        back to the serial path (batch-level failure, leader lost).
        Raises QueryCancelled when THIS member's statement is cancelled
        or deadlined — the batch itself is unaffected. `via` labels the
        submission source for the per-class metric split ("execute" for
        pgwire bind-path members)."""
        key = spec.shape_key + (vkey, _device_key(session))
        me = _Member(spec, session._admission_priority(),
                     next(self._seq), via=via)
        # phase contract: submitters register their statement as
        # serving-batched BEFORE calling submit (session.execute's probe
        # branch, execute_spec's bind path) — no registry write here,
        # this is the per-statement hot path
        self._observe_arrival(spec.kind, me.t_enq)
        with self._mu:
            self._inflight += 1
            grp = self._groups.get(key)
            leader = grp is None
            if leader:
                self._groups[key] = [me]
            else:
                grp.append(me)
        try:
            if leader:
                self._lead(session, key, me)
            else:
                self._follow(me)
        finally:
            with self._mu:
                self._inflight -= 1
        # a cancelled/deadlined statement raises 57014 even when its
        # (discarded) lane computed a result — statement semantics win
        _cancel.checkpoint()
        if me.error is not None:
            raise me.error
        if me.fallback or me.result is None:
            self.fallback_total.inc()
            self.cls_metrics[spec.kind]["fallback"].inc()
            if via == "execute":
                self.cls_metrics["execute"]["fallback"].inc()
            return None
        return me.result

    # -- leader ----------------------------------------------------------

    def effective_window_s(self, kind: str = "scan") -> float:
        """The coalescing window a leader holds open right now for class
        `kind`. A non-negative sql.serving.coalesce_window_ms is a fixed
        window (deterministic tests, operators pinning behavior);
        negative = adaptive: K× the class's submit inter-arrival EWMA,
        clamped to [0, sql.serving.coalesce_window_max_ms] — a sparse
        stream's window collapses toward zero, a dense burst's stretches
        to the ceiling, where max_batch caps the damage (the fixed 2 ms
        default was wrong at both extremes, and one global EWMA was
        wrong across classes with different arrival rates)."""
        fixed = float(Settings().get(COALESCE_WINDOW_MS))
        if fixed >= 0.0:
            return fixed / 1000.0
        ceil_s = max(float(Settings().get(COALESCE_WINDOW_MAX_MS)),
                     0.0) / 1000.0
        with self._mu:
            ew = self._ewma_interarrival.get(kind)
        if ew is None:
            # cold start: no interval observed for this class yet — hold
            # the full window, the safe end (lone submitters skip it)
            return ceil_s
        return min(max(_WINDOW_K * ew, 0.0), ceil_s)

    def _lead(self, session, key: tuple, me: _Member) -> None:
        ctx = _cancel.current()
        window = self.effective_window_s(me.spec.kind)
        max_batch = max(int(Settings().get(MAX_BATCH)), 1)
        deadline = time.monotonic() + window
        while True:
            with self._mu:
                n = len(self._groups.get(key, ()))
                inflight = self._inflight
            if n >= max_batch:
                break
            if inflight <= 1:
                # lone submitter: nobody can join this window — flush
                # now so a single client pays no coalescing latency
                break
            if ctx is not None and ctx.cancelled():
                # cancelled (or draining) leader still flushes so queued
                # members are not stranded; its own 57014 raises after
                # delivery, in submit()'s checkpoint
                break
            now = time.monotonic()
            if now >= deadline:
                break
            time.sleep(min(deadline - now, 0.0005))
        # one dispatch of a group key at a time: while the previous one
        # runs, this group stays open and its members keep joining, so a
        # busy key's batches deepen instead of queueing one by one on
        # the runner
        with self._mu:
            turn = self._turns.setdefault(key, threading.Lock())
        members: List[_Member] = []
        try:
            with turn:
                with self._mu:
                    members = self._groups.pop(key, [])
                # priority-ordered batch formation: HIGH sessions
                # dispatch in the first batch chunk, FIFO within a
                # priority class
                members.sort(key=lambda m: (-m.prio, m.seq))
                self._dispatch(session, key, members, max_batch)
        except BaseException:  # noqa: BLE001 — never strand members
            pass
        finally:
            with self._mu:
                if key not in self._groups and not turn.locked():
                    self._turns.pop(key, None)
            now = time.monotonic()
            for m in members:
                if m.result is None and m.error is None:
                    m.fallback = True
                self._recent_delay.append(now - m.t_enq)
                self.queue_delay.observe(now - m.t_enq)
                m.ev.set()

    def _dispatch(self, session, key: tuple, members: List[_Member],
                  max_batch: int) -> None:
        from cockroach_tpu_torch.exec import stats
        from cockroach_tpu_torch.util.admission import (
            SESSION_QUEUE_TIMEOUT, session_queue,
        )

        spec = members[0].spec
        cls = spec.kind
        vkey = key[-2]
        queue = session_queue()
        acquired = False
        if queue is not None:
            try:
                # ONE admission slot covers the whole batch (members
                # skipped per-statement admission): the batch is the
                # admission unit, at the highest member priority
                queue.acquire(
                    priority=max(m.prio for m in members),
                    timeout=float(Settings().get(SESSION_QUEUE_TIMEOUT)))
                acquired = True
            except TimeoutError:
                from cockroach_tpu_torch.sql.session import SQLError

                err = SQLError(
                    "53300", "statement shed: admission queue timed "
                    "out under overload")
                for m in members:
                    m.error = err
                return
        try:
            runner = self._runner_for(session, spec, vkey)
            depth = len(members)
            self._recent_depth.append(depth)
            self.coalesce_depth.observe(depth)
            for a in range(0, depth, max_batch):
                chunk = members[a:a + max_batch]
                specs = [m.spec for m in chunk]

                def attempt():
                    _cancel.checkpoint()
                    maybe_fail("fused.exec")
                    return runner.serve(specs)

                with stats.timed("serving.exec"):
                    payloads = _retry.with_retry(
                        attempt, name="fused.exec")
                rows = 0
                for m, payload in zip(chunk, payloads):
                    m.result = payload
                    if payload:
                        rows += len(next(iter(payload.values())))
                n_real = len(chunk)
                bucket = _pow2(n_real)
                self.ops_submitted += n_real
                self.slots_dispatched += bucket
                self.cls_ops[cls] += n_real
                self.cls_slots[cls] += bucket
                self.dispatches += 1
                self.batched_dispatch_total.inc()
                self.coalesced_total.inc(n_real)
                cm = self.cls_metrics[cls]
                cm["dispatch"].inc()
                cm["coalesced"].inc(n_real)
                n_exec = sum(1 for m in chunk if m.via == "execute")
                if n_exec:
                    em = self.cls_metrics["execute"]
                    em["dispatch"].inc()
                    em["coalesced"].inc(n_exec)
                    self.cls_ops["execute"] += n_exec
                    self.cls_slots["execute"] += bucket
                self.occupancy_gauge.set(self.occupancy())
                stats.add("serving.batched_dispatch", rows=rows,
                          events=1)
        finally:
            if acquired:
                queue.release()

    # -- follower --------------------------------------------------------

    def _follow(self, me: _Member) -> None:
        ctx = _cancel.current()
        bail = time.monotonic() + _FOLLOWER_BAIL_S
        while not me.ev.wait(0.005):
            if ctx is not None and ctx.cancelled():
                # lazy mask-out: leave immediately; the leader still
                # computes (and discards) this lane — no slot surgery,
                # and the batch never sees a 57014
                ctx.checkpoint()
            if time.monotonic() > bail:
                me.fallback = True
                return

    # -- runners ---------------------------------------------------------

    def _cache_runner(self, rkey: tuple, r) -> None:
        with self._runners_mu:
            # a runner of the same shape and device under another table
            # version can never serve again (the version only moves
            # forward): it goes now, not when the LRU reaches it, so a
            # write burst rebuilding the frozen-snapshot classes cannot
            # push a live runner out
            for k in [k for k in self._runners if k[:-2] == rkey[:-2]
                      and k[-1] == rkey[-1] and k != rkey]:
                del self._runners[k]
            self._runners[rkey] = r
            self._runners.move_to_end(rkey)
            while len(self._runners) > _RUNNER_ENTRIES:
                self._runners.popitem(last=False)

    def _runner_for(self, session, spec: BatchSpec, vkey: tuple):
        from cockroach_tpu_torch.exec.fused import (
            ResidentServingRunner, build_serving_batch_runner,
        )

        rkey = spec.shape_key + (vkey, _device_key(session))
        with self._runners_mu:
            r = self._runners.get(rkey)
            if r is not None and not getattr(r, "alive", lambda: True)():
                # a resident-backed runner whose table detached: its
                # stable key would otherwise pin a dead runner forever
                self._runners.pop(rkey, None)
                r = None
            if r is not None:
                self._runners.move_to_end(rkey)
                return r
        # built OUTSIDE the lock (host scan + device transfer); a
        # concurrent duplicate build is benign — last writer wins the
        # LRU slot and the loser's image is garbage collected
        r = build_serving_batch_runner(session.catalog, session.capacity,
                                       spec, device=_session_device(session))
        # a write-stable "resident-serving" key may only ever pin a
        # runner that refreshes per dispatch; if the resident build
        # declined (e.g. the table detached between keying and building)
        # the host snapshot serves THIS batch but is not cached — caching
        # it under a key writes never rotate would serve stale forever
        if ("resident-serving" in vkey
                and not isinstance(r, ResidentServingRunner)):
            return r
        self._cache_runner(rkey, r)
        return r

    def prewarm_shape(self, catalog, capacity: int, table: str, cols,
                      window: int, buckets, cls: str = "scan",
                      order_col: Optional[str] = None,
                      descending: bool = False, aggs=None, names=None,
                      vcol: Optional[str] = None,
                      metric: Optional[str] = None, device=None) -> int:
        """Pre-warm ONE batch shape from its serving-task description
        (the pre-warm job's worker, item 8e): build/install the class's
        runner on `device` (CUDA unless given) at the table's CURRENT
        scan-cache version and record the given pow2 batch buckets.
        Returns the buckets recorded; 0 when the catalog can't version
        the table (nothing safe to install)."""
        from cockroach_tpu_torch.exec.fused import (
            ResidentServingRunner, build_serving_batch_runner,
        )

        try:
            spec = BatchSpec(
                cls, table, tuple(cols or ()), 0, 0,
                int(window) if cls == "vector" else None, int(window),
                order_col=order_col, descending=bool(descending),
                aggs=None if aggs is None else tuple(
                    (a[0], a[1]) for a in aggs),
                names=None if names is None else tuple(names),
                vcol=vcol, metric=metric)
        except ValueError:
            return 0
        vkey = _class_vkey(catalog, capacity, spec)
        if vkey is None:
            return 0
        from cockroach_tpu_torch import resolve_device

        dev = resolve_device(device)
        rkey = spec.shape_key + (vkey, (dev.type, dev.index))
        with self._runners_mu:
            r = self._runners.get(rkey)
            if r is not None:
                self._runners.move_to_end(rkey)
        if r is None:
            try:
                r = build_serving_batch_runner(catalog, capacity, spec,
                                               device=dev)
            except Exception:  # noqa: BLE001 — table dropped/reshaped
                return 0
            # same contract as _runner_for: a write-stable resident key
            # must never pin a frozen host snapshot
            if ("resident-serving" not in vkey
                    or isinstance(r, ResidentServingRunner)):
                self._cache_runner(rkey, r)
        n = 0
        for b in buckets:
            if r.compile_bucket(int(b)):
                n += 1
        return n

    def prewarm_tasks(self, max_batch: Optional[int] = None,
                      capacity: Optional[int] = None) -> List[dict]:
        """The resident runners' shapes as plan_prewarm job tasks — what
        the pre-warm job (item 8e) persists so a RESTARTED node can
        rebuild and re-record the same serving set from the job record
        alone."""
        mb = max_batch if max_batch is not None else \
            max(int(Settings().get(MAX_BATCH)), 1)
        buckets = []
        b = 1
        while b <= _pow2(mb):
            buckets.append(b)
            b *= 2
        with self._runners_mu:
            rkeys = list(self._runners.keys())
        tasks = []
        for rkey in rkeys:
            cls = rkey[0]
            task = {"kind": "serving", "class": cls, "table": rkey[1],
                    "buckets": buckets}
            if cls == "scan":
                task.update(cols=list(rkey[2]), window=int(rkey[3]))
            elif cls == "agg":
                task.update(aggs=[list(a) for a in rkey[2]],
                            names=list(rkey[3]), window=int(rkey[4]))
            elif cls == "topk":
                task.update(cols=list(rkey[2]), order_col=rkey[3],
                            descending=bool(rkey[4]),
                            window=int(rkey[5]))
            elif cls == "vector":
                task.update(cols=list(rkey[2]), vcol=rkey[3],
                            metric=rkey[4], window=int(rkey[5]))
            else:
                continue
            if capacity is not None:
                task["capacity"] = int(capacity)
            if task not in tasks:
                tasks.append(task)
        return tasks

    def prewarm(self, max_batch: Optional[int] = None) -> int:
        """Run the pow2 batch shapes of every resident runner once — the
        serving-stack warmup step: each bucket's first dispatch (its
        allocations, the staging buffers) happens at deploy time, not
        under the first burst of traffic. Empty ranges ([0, 0) matches
        nothing) and zero query vectors run the same shapes real batches
        will. Returns the number of (runner, shape) programs touched.
        Only shapes the traffic can reach: pow2 buckets up to
        `max_batch` (default: the sql.serving.max_batch setting). It
        BLOCKS for the full ladder."""
        mb = max_batch if max_batch is not None else \
            max(int(Settings().get(MAX_BATCH)), 1)
        with self._runners_mu:
            runners = list(self._runners.values())
        touched = 0
        for r in runners:
            b = 1
            while b <= _pow2(mb):
                r.prewarm_batch(b)
                touched += 1
                b *= 2
        return touched

    # -- observability ---------------------------------------------------

    def occupancy(self) -> float:
        """True occupancy: real member lanes over dispatched lanes —
        padding counts as dispatched, never as occupied (comparable to
        ScanTopKBatcher.occupancy())."""
        return (self.ops_submitted / self.slots_dispatched
                if self.slots_dispatched else 0.0)

    def snapshot(self) -> Dict[str, object]:
        def pct(xs, q):
            if not xs:
                return 0.0
            s = sorted(xs)
            return float(s[min(int(q * len(s)), len(s) - 1)])

        depth = list(self._recent_depth)
        delay = list(self._recent_delay)
        with self._mu:
            ewma = dict(self._ewma_interarrival)
        classes: Dict[str, Dict[str, object]] = {}
        for cls in _METRIC_CLASSES:
            cm = self.cls_metrics[cls]
            slots = self.cls_slots.get(cls, 0)
            entry: Dict[str, object] = {
                "batched_dispatch_total": int(cm["dispatch"].value()),
                "coalesced_statements": int(cm["coalesced"].value()),
                "fallbacks": int(cm["fallback"].value()),
                "occupancy": (round(self.cls_ops.get(cls, 0) / slots, 4)
                              if slots else 0.0),
            }
            if cls in CLASSES:
                ew = ewma.get(cls)
                entry["coalesce_window_ms"] = round(
                    self.effective_window_s(cls) * 1e3, 4)
                entry["ewma_interarrival_ms"] = (
                    None if ew is None else round(ew * 1e3, 4))
            classes[cls] = entry
        # the legacy top-level window/EWMA fields describe the scan
        # class (what they meant before the per-class split)
        return {
            "batched_dispatch_total": int(
                self.batched_dispatch_total.value()),
            "coalesced_statements": int(self.coalesced_total.value()),
            "fallbacks": int(self.fallback_total.value()),
            "dispatches": self.dispatches,
            "occupancy": round(self.occupancy(), 4),
            "coalesce_depth_p50": pct(depth, 0.50),
            "coalesce_depth_p99": pct(depth, 0.99),
            "queue_delay_p50_ms": round(pct(delay, 0.50) * 1e3, 3),
            "queue_delay_p99_ms": round(pct(delay, 0.99) * 1e3, 3),
            "coalesce_window_ms": round(
                self.effective_window_s("scan") * 1e3, 4),
            "ewma_interarrival_ms": (
                None if ewma.get("scan") is None
                else round(ewma["scan"] * 1e3, 4)),
            "classes": classes,
        }


def spec_lim(spec: BatchSpec) -> int:
    return spec.window if spec.limit is None else min(spec.limit,
                                                      spec.window)


def _demux(spec: BatchSpec, vals: np.ndarray, valid: np.ndarray,
           count: int) -> Dict[str, np.ndarray]:
    """One member's collect()-shaped payload out of its batch lane.
    Matching rows occupy a PREFIX of the window (keys are sorted — or
    post-sort order for the top-K classes), so the first `count` lanes
    are exactly the statement's rows — bit-identical to the streaming
    path."""
    payload: Dict[str, np.ndarray] = {}
    for ci, name in enumerate(spec.cols):
        payload[name] = np.array(vals[ci, :count])
        payload[name + "__valid"] = np.array(valid[ci, :count])
    return payload


def spec_schema(spec: BatchSpec):
    """The result Schema a spec's demuxed payload renders under — what
    the per-statement bound plan would have produced: INT projections
    for the row classes, INT per aggregate except avg (float32)."""
    from cockroach_tpu_torch.coldata.batch import FLOAT, INT, Field, Schema

    if spec.kind == "agg":
        fields = []
        for (func, _c), name in zip(spec.aggs, spec.names):
            fields.append(Field(name, FLOAT if func == "avg" else INT))
        return Schema(fields)
    return Schema([Field(c, INT) for c in spec.cols])


_queue: Optional[ServingQueue] = None
_queue_mu = threading.Lock()


def serving_queue() -> ServingQueue:
    global _queue
    with _queue_mu:
        if _queue is None:
            _queue = ServingQueue()
        return _queue


def enabled() -> bool:
    return bool(Settings().get(SERVING_ENABLED))


def probe(session, sql: str) -> bool:
    """Pre-admission peek: is this statement going to take the serving
    path? A dict-get on the shared prepared cache — no parse, no vkey
    validation (if the entry turns stale by _execute time the statement
    simply runs the normal path; one statement slipping the per-session
    admission gate is harmless, the batch leader still admits)."""
    if not enabled() or session._txn is not None:
        return False
    with session._prepared_mu:
        prep = session._prepared.get(sql)
    return prep is not None and getattr(prep, "bspec", None) is not None


def _class_vkey(catalog, capacity: int, spec: BatchSpec):
    """The MVCC-version component of a spec's compatibility key. The
    scan class rides serving_image_key when the catalog offers it —
    STABLE across writes for device-resident tables, whose runner
    refreshes its image per dispatch from the resident delta fold. The
    other classes snapshot frozen host images, so they key off the
    plain scan-cache key, which rotates on EVERY write — a write makes
    the next batch rebuild; frozen snapshots can never serve stale."""
    vkey = None
    if spec.kind == "scan":
        sik = getattr(catalog, "serving_image_key", None)
        if sik is not None:
            try:
                vkey = sik(spec.table, capacity)
            except Exception:  # noqa: BLE001 — e.g. table dropped
                vkey = None
    if vkey is None:
        try:
            vkey = catalog.scan_cache_key(spec.table, None, capacity)
        except Exception:  # noqa: BLE001
            vkey = None
    return vkey


def maybe_submit(session, prep,
                 sql: str = "") -> Optional[Dict[str, np.ndarray]]:
    """Serve a warm prepared hit through the batch path when possible;
    None means: run the serial path. The version component of the
    compatibility key is computed FRESH per class (_class_vkey) —
    serving-only prepared entries can outlive their prepare-time keys,
    and a frozen-snapshot class must never group under a stale one —
    falling back to the prepare-time key when the catalog can't produce
    one now."""
    spec = getattr(prep, "bspec", None)
    if spec is None or not enabled():
        return None
    vkey = _class_vkey(session.catalog, prep.capacity, spec)
    if vkey is None:
        vkey = prep.vkeys.get(spec.table)
    if vkey is None:
        return None
    return serving_queue().submit(session, spec, vkey)


def match_bound_sql(session, sql: str) -> Optional[BatchSpec]:
    """The EXECUTE seam (pgwire Bind): after textual parameter
    substitution, re-match the BOUND statement against the batch
    classes. One extra parse per Bind buys prepared statements whose
    only differences are bind values a direct seat in their class's
    group. Never raises — any failure just means the portal executes
    the normal path."""
    if not enabled():
        return None
    head = sql.lstrip()[:7].lower()
    if not head.startswith("select"):
        return None
    try:
        ast = P.parse(sql)
        return match_batchable(ast, session.catalog, session.capacity)
    except Exception:  # noqa: BLE001 — matching must never fail Bind
        return None
