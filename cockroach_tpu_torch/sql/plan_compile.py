"""Plan compilation and measured-cost operator placement.

Counterpart of cockroach_tpu/sql/plan_compile.py. `compile_plan` takes
any bound plan tree: it normalizes it (decorrelation included), builds
the operator tree (sql/plan.py build), runs the placement pass
(sql/cost.py) and attaches the fused whole-query program
(exec/fused.py) when the tree admits one. LOWERING_RULES names, for each
plan-node kind, the operator it lowers to and the device work the fused
program composes for it; build() and the fused tracer implement them.

Every operator gets a tier: "fused" (inside the whole-query program: on
CUDA one graph replay), "streaming" (the chunked operators) or "host"
(the row engine, or a flow placed on the host). The tier follows from
the tree's structure and the backend; the estimates beside it come from
the card's coefficients (sql/cost.py `CARD`), and an operator family
that sqlstats has measured for the fingerprint shows its measured
per-execution seconds instead.

Mixed tiers: when a host-only operator (RowMapOp's computed strings or
exact decimals) caps an otherwise fusible subtree, the subtree is
wrapped in CompiledSubtreeOp, so everything below the row engine still
runs as one fused program (on CUDA one CUDA graph, whose packed result
the row engine reads once per replay).

Departures: the backend under `auto` is the caller's device, so the JAX
package's placement cache, `measured_route` and `mark_degraded` are not
carried (sql/cost.py says why). A VectorTopK's exact arm lowers to
MapOp and TopKOp, which fuse like any other scan program; its ANN arm
(VectorANNOp) probes its index outside the fused program, so its tier
is "streaming". An IndexScan lowers to a ScanOp over
the index's chunk stream with no cache key: the fused tracer takes it as
the JAX tracer does (a scan it stacks for the one run, so no capture),
and an empty index span sends the flow to the streaming operators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set

from cockroach_tpu_torch.exec.operators import (
    Operator, ScanOp, VectorANNOp, flow_backend, walk_operators,
)
from cockroach_tpu_torch.exec.rowexec import RowMapOp
from cockroach_tpu_torch.sql.cost import (
    CARD, OpCost, QueryPlacement, est_device_seconds, est_host_seconds,
)
from cockroach_tpu_torch.sql.plan import (
    Aggregate, Apply, Catalog, Distinct, Filter, IndexScan, Join, Limit,
    OrderBy, Plan, Project, Scan, Shrink, VectorTopK, Window, _walk_plan,
    build, estimate_cardinality, normalize,
)

# plan-node kind -> (display name, exec operator, the device work the
# fused program composes for it). EXPLAIN's tier rendering reads the
# display names; build() and the fused tracer implement the rules.
LOWERING_RULES: Dict[type, tuple] = {
    Scan: ("scan", "ScanOp", "packed stacked image + flat unpack"),
    IndexScan: ("index scan", "ScanOp", "index-bounded chunk stream"),
    Filter: ("filter", "MapOp", "ops/expr.filter_mask"),
    Project: ("project", "MapOp", "ops/expr.eval_expr"),
    Shrink: ("shrink", "ShrinkOp", "compact-to-pow2 gather"),
    Join: ("join", "JoinOp", "ops/join.hash_join (inner/left/right/"
           "full/semi/anti) over the sort join (ops/sortjoin.py)"),
    Aggregate: ("aggregate", "HashAggOp", "ops/agg dense (the dense_sums "
                "kernel), range-dense, hash and sort GROUP BY; "
                "ops/groupjoin"),
    Distinct: ("distinct", "DistinctOp", "hash aggregation on keys"),
    OrderBy: ("sort", "SortOp", "ops/sort stable lexicographic sort"),
    Limit: ("limit", "LimitOp", "top-K when ordered, slice otherwise"),
    Window: ("window", "WindowOp", "ops/window segmented scans over "
             "the partition sort"),
    VectorTopK: ("vector top-k", "TopKOp", "ops/vector distances + "
                 "top-K"),
    Apply: ("apply", "JoinOp", "decorrelated to join+agg before "
            "lowering (plan.decorrelate)"),
}

# family key into sqlstats' per-operator measured seconds
# (exec/stats.operator_device) for each plan-node kind
_FAMILY = {
    Scan: "scan", IndexScan: "scan", Join: "join", Apply: "join",
    Aggregate: "agg", Distinct: "agg", OrderBy: "sort", Limit: "sort",
    Window: "sort", VectorTopK: "vector", Filter: "fused",
    Project: "fused", Shrink: "fused",
}


@dataclass
class CompiledPlan:
    """compile_plan's output: the wired operator tree, the flow backend,
    the per-operator tier table, and (when the whole tree fused) the
    root FusedRunner."""
    op: Operator
    backend: str
    placement: QueryPlacement
    runner: object = None


class CompiledSubtreeOp(Operator):
    """A fused subtree presented as an ordinary streaming operator: the
    device program below a host-only parent. batches() yields the
    runner's packed single-readback result; a FlowRestart from a deferred
    overflow propagates to the outer flow driver, which widens and reruns
    the whole flow, as every operator does."""

    def __init__(self, runner, child: Operator):
        self.runner = runner
        self.child = child
        self.schema = child.schema

    def batches(self, device):
        yield from self.runner.batches(device)


def _unwrap(op: Operator) -> Operator:
    # invariant test builds interpose CheckedOp above every operator
    while type(op).__name__ == "CheckedOp":
        op = op.child
    return op


def _est_scan_rows(op: Operator) -> Optional[int]:
    """Sum of the planner-stamped scan estimates (the rows the cost
    model prices)."""
    est, known = 0, False
    for sub in walk_operators(op):
        sub = _unwrap(sub)
        if isinstance(sub, ScanOp):
            rows = getattr(sub, "est_rows", None)
            if rows is not None:
                est += rows
                known = True
    return est if known else None


def _wrap_mixed(root: Operator) -> Set[int]:
    """The root did not fuse: wrap the child subtree of every row-engine
    operator (RowMapOp) that does fuse in a CompiledSubtreeOp — host
    above, one device program below. Returns the ids of the operators
    now running fused."""
    from cockroach_tpu_torch.exec.fused import try_compile

    fused_ids: Set[int] = set()
    candidates = [op for op in walk_operators(root)
                  if isinstance(op, RowMapOp)
                  and not isinstance(op.child, CompiledSubtreeOp)
                  and not isinstance(_unwrap(op.child), ScanOp)]
    for op in candidates:
        r = try_compile(op.child)
        if r is None:
            continue
        for sub in walk_operators(op.child):
            fused_ids.add(id(sub))
        op.child = CompiledSubtreeOp(r, op.child)
    return fused_ids


def _node_tier(op: Optional[Operator], backend: str, whole_fused: bool,
               fused_ids: Set[int]):
    """-> (tier, reason) for one plan node's operator."""
    if backend == "cpu":
        return "host", "flow placed on the host"
    inner = _unwrap(op) if op is not None else None
    if isinstance(inner, RowMapOp):
        return "host", "row-engine projection (computed strings / " \
                       "exact decimal semantics)"
    if isinstance(inner, VectorANNOp):
        return "streaming", "IVF index probe runs as its own dispatch"
    if whole_fused:
        return "fused", "inside the single whole-query device program"
    if op is not None and id(op) in fused_ids:
        return "fused", "fused device subtree under a host operator"
    return "streaming", "outside the fusion grammar here: chunked " \
                        "device kernels"


def compile_plan(p: Plan, catalog: Catalog, capacity: int = 1 << 17,
                 sql: Optional[str] = None, setting: str = "auto",
                 resident: bool = False,
                 _normalized: bool = False) -> CompiledPlan:
    """Compile a bound plan tree: normalize (decorrelation included),
    build the operator tree, give every operator its tier, and attach the
    fused whole-query program when the tree admits one.

    `setting` is the session's `vectorize` (auto|gpu|cpu); under `auto`
    (and `gpu`, its alias) the flow runs on the caller's device. `sql`
    names the fingerprint whose measured seconds sqlstats holds.
    `resident=True` marks every scan with a cache key resident
    (exec/operators.py ScanOp): its first complete pass pins its image in
    the scan-image cache, so later runs of the tree (and of any tree over
    the same data) read it there and a fused run is a CUDA graph
    replay."""
    from cockroach_tpu_torch.exec.fused import try_compile
    from cockroach_tpu_torch.sql.sqlstats import default_sqlstats, fingerprint

    norm = p if _normalized else normalize(p, catalog)
    node_map: Dict[int, Operator] = {}
    op = build(norm, catalog, capacity, _normalized=True,
               node_map=node_map)
    if resident:
        for sub in walk_operators(op):
            sub = _unwrap(sub)
            if isinstance(sub, ScanOp) and sub.cache_key is not None:
                sub.resident = True
    nodes = list(_walk_plan(norm))

    backend = flow_backend(setting)
    fp = fingerprint(sql) if sql else ""
    est = _est_scan_rows(op) or 0
    stats_snap = default_sqlstats().get(fp) if fp else None

    # structural pass: does the whole tree fuse; if not, which subtrees
    runner = None
    fused_ids: Set[int] = set()
    whole_fused = False
    if backend != "cpu":
        runner = getattr(op, "_fused_runner", None) or try_compile(op)
        if runner is not None:
            op._fused_runner = runner
            whole_fused = True
        else:
            fused_ids = _wrap_mixed(op)

    placement = QueryPlacement(
        backend=backend, source="device" if setting == "auto" else "forced",
        fingerprint=fp, est_scan_rows=est,
        est_device_s=est_device_seconds(est),
        est_host_s=est_host_seconds(est))
    measured_ops = (stats_snap or {}).get("op_device") or {}
    execs = max((stats_snap or {}).get("count", 0), 1)
    for node in nodes:
        name = LOWERING_RULES.get(type(node),
                                  (type(node).__name__.lower(),))[0]
        nop = node_map.get(id(node))
        tier, reason = _node_tier(nop, backend, whole_fused, fused_ids)
        try:
            rows = estimate_cardinality(node, catalog)
        except Exception:  # noqa: BLE001 — the estimate is advisory
            rows = 0.0
        oc = OpCost(name=name, detail=_describe(node),
                    est_rows=rows,
                    device_s=rows / CARD.device_rows_per_s,
                    host_s=rows / CARD.host_rows_per_s,
                    tier=tier, source="static", reason=reason)
        fam = _FAMILY.get(type(node))
        if fam in measured_ops:
            # sqlstats accumulated this family's execution seconds for
            # this fingerprint: the operator's device cost is the
            # measured per-execution mean
            oc.device_s = measured_ops[fam] / execs
            oc.source = "measured"
        placement.ops.append(oc)

    return CompiledPlan(op=op, backend=backend, placement=placement,
                        runner=runner)


def _describe(node: Plan) -> str:
    if isinstance(node, (Scan, IndexScan)):
        return node.table
    if isinstance(node, Join):
        return node.how + " " + ",".join(node.left_on)
    if isinstance(node, Aggregate):
        return ",".join(node.group_by) if node.group_by else "scalar"
    if isinstance(node, OrderBy):
        return ",".join(k.col for k in node.keys)
    if isinstance(node, Window):
        return ",".join(s.func for s in node.specs)
    if isinstance(node, Project):
        return f"{len(node.outputs)} cols"
    return ""

