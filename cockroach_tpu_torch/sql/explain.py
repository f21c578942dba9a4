"""EXPLAIN / EXPLAIN ANALYZE + the statement executor entry point.

Reference: sql/instrumentation.go:72 (EXPLAIN ANALYZE assembly from
ComponentStats trailing metadata), opt/exec/explain. `execute`
is the conn_executor dispatch seam: one call takes SQL text and returns
either result columns or an explain rendering.

Counterpart of cockroach_tpu/sql/explain.py: `render_plan`, `execute`
and `execute_with_plan`, with the placement pass's tier annotations and
the `engine:` line, which prints the card's coefficients (sql/cost.py).
EXPLAIN ANALYZE runs the query under exec/stats and a `query` trace
span (always traced, whatever `sql.trace.enabled` says) and prints the
stage report, the per-operator breakdown with tiers, the span tree and
its one-line resilience digest (util/tracing.py `summarize`); EXPLAIN
ANALYZE (DEBUG) also writes the statement bundle
(server/debugzip.py `write_statement_bundle`) under the temporary
directory and prints its path. A statement naming `crdb_internal.` binds
and runs over a per-statement sql/vtable.py VirtualCatalog. The
statement's query-registry entry (server/registry.py) goes from
`compiling` (bind) to `executing` (run).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.sql.bind import Binder
from cockroach_tpu_torch.sql.plan import (
    Aggregate, Catalog, Distinct, Filter, IndexScan, Join, Limit, OrderBy,
    Plan, Project, Scan, VectorTopK, Window, _walk_plan, normalize,
)


def render_plan(p: Plan, catalog: Catalog) -> List[str]:
    """Normalized logical plan -> indented tree lines (EXPLAIN), with
    estimated row counts from ANALYZE stats where available (the
    coster's cardinalities, opt/xform/coster.go)."""
    lines: List[str] = []

    def _est(scan_node, predicate) -> str:
        from cockroach_tpu_torch.sql.stats import estimate_rows

        try:
            stats = catalog.table_stats(scan_node.table)
            base = catalog.table_rows(scan_node.table)
        except Exception:
            return ""
        if stats is None and predicate is None:
            return ""
        filters = [predicate] if predicate is not None else []
        est = estimate_rows(stats, base, filters)
        return f" (~{int(est)} rows)"

    def describe(node: Plan) -> str:
        if isinstance(node, IndexScan):
            return (f"index scan {node.table}@{node.column} "
                    f"[{node.lo}, {node.hi}]{_est(node, None)}")
        if isinstance(node, Scan):
            cols = f" columns=({', '.join(node.columns)})" \
                if node.columns else ""
            return f"scan {node.table}{cols}{_est(node, None)}"
        if isinstance(node, Filter):
            inner = node.input
            if isinstance(inner, (Scan, IndexScan)):
                return f"filter {node.predicate!r}" \
                    + _est(inner, node.predicate)
            return f"filter {node.predicate!r}"
        if isinstance(node, Project):
            return f"project {', '.join(n for n, _ in node.outputs)}"
        if isinstance(node, Join):
            keys = ", ".join(f"{a}={b}"
                             for a, b in zip(node.left_on, node.right_on))
            return f"{node.how} join on {keys}"
        if isinstance(node, Aggregate):
            aggs = ", ".join(f"{a.func}({a.col or '*'}) as {a.out}"
                             for a in node.aggs)
            gb = (f" group by {', '.join(node.group_by)}"
                  if node.group_by else "")
            return f"aggregate {aggs}{gb}"
        if isinstance(node, OrderBy):
            keys = ", ".join(k.col + (" desc" if k.descending else "")
                             for k in node.keys)
            return f"sort {keys}"
        if isinstance(node, Limit):
            off = f" offset {node.offset}" if node.offset else ""
            return f"limit {node.n}{off}"
        if isinstance(node, Distinct):
            return "distinct" + (f" on ({', '.join(node.keys)})"
                                 if node.keys else "")
        if isinstance(node, VectorTopK):
            metric = {"l2": "<->", "cos": "<=>"}.get(node.metric,
                                                     node.metric)
            mode = (f"ann nprobe={node.nprobe}" if node.ann
                    else "exact")
            return (f"vector top-k [{mode}] {node.column} {metric} "
                    f"[{len(node.query)}-dim] k={node.k}")
        if isinstance(node, Window):
            fns = ", ".join(f"{s.func}({s.col or ''}) as {s.out}"
                            for s in node.specs)
            pb = (f" partition by {', '.join(node.partition_by)}"
                  if node.partition_by else "")
            ob = (" order by " + ", ".join(
                k.col + (" desc" if k.descending else "")
                for k in node.order_by) if node.order_by else "")
            return f"window {fns}{pb}{ob}"
        return type(node).__name__.lower()

    def walk(node: Plan, depth: int):
        lines.append("  " * depth + "-> " + describe(node)
                     if depth else describe(node))
        for k in node.inputs():
            walk(k, depth + 1)

    walk(p, 0)
    return lines


def execute(sql: str, catalog: Catalog, capacity: int = 1 << 17,
            mesh=None, device=None) -> Tuple[str, object]:
    """-> ("rows", columns-dict) | ("explain", [lines]).

    EXPLAIN renders the normalized plan; EXPLAIN ANALYZE also runs the
    query with the stats collector and appends the per-stage attribution
    (the ComponentStats -> EXPLAIN ANALYZE path).
    """
    kind, payload, _schema = execute_with_plan(sql, catalog, capacity,
                                               mesh, device=device)
    return kind, payload


def execute_with_plan(sql: str, catalog: Catalog, capacity: int = 1 << 17,
                      mesh=None, ast=None, op_sink=None, device=None,
                      setting: str = "auto", resident: bool = False
                      ) -> Tuple[str, object, object]:
    """-> (kind, payload, output Schema or None) — the schema is the
    built operator tree's own, for exact result decoding. Pass `ast` to
    skip re-parsing (Session already parsed for dispatch). `op_sink` (a
    list) receives {"plan": bound plan, "op": built operator tree} for
    non-EXPLAIN statements — Session's prepared-statement cache. The
    flow runs on `device` (CUDA unless the caller passes one); `setting`
    is the session's `vectorize`; `resident` marks the scans resident
    (sql/plan_compile.py compile_plan)."""
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.server.registry import default_query_registry
    from cockroach_tpu_torch.sql.plan import run

    if ast is None:
        ast = P.parse(sql)
    is_explain = isinstance(ast, P.ExplainStmt)
    analyze = ast.analyze if is_explain else False
    stmt = ast.stmt if is_explain else ast
    if "crdb_internal." in sql:
        # virtual-schema statements bind and run against a per-statement
        # VirtualCatalog wrapper: crdb_internal.* names materialize from
        # the live registries, everything else delegates (sql/vtable.py)
        from cockroach_tpu_torch.sql.vtable import VirtualCatalog

        catalog = VirtualCatalog(catalog)
    qreg = default_query_registry()
    qreg.set_phase_current("compiling")
    plan = Binder(catalog).bind(stmt)
    if not is_explain:
        qreg.set_phase_current("executing")
        sink = [] if op_sink is not None else None
        result, schema = run(plan, catalog, capacity, mesh=mesh,
                             with_schema=True, op_sink=sink, sql=sql,
                             device=device, setting=setting,
                             resident=resident)
        if op_sink is not None:
            op_sink.append({"plan": plan,
                            "op": sink[0] if sink else None})
        return "rows", result, schema

    norm = normalize(plan, catalog)
    lines = render_plan(norm, catalog)
    # operator placement (sql/plan_compile.py): annotate every plan line
    # with its tier and the cost inputs that chose it — render_plan and
    # the placement pass walk the SAME pre-order, so lines and OpCosts
    # zip 1:1.
    from cockroach_tpu_torch.sql.cost import (
        crossover_rows, est_device_seconds,
    )
    from cockroach_tpu_torch.sql.plan_compile import _FAMILY, compile_plan

    placement = compile_plan(norm, catalog, capacity, sql=sql,
                             setting=setting,
                             _normalized=True).placement
    for i, oc in enumerate(placement.ops[:len(lines)]):
        lines[i] += (f"  [tier={oc.tier} est={int(oc.est_rows)} rows"
                     f" device={oc.device_s * 1e3:.1f}ms"
                     f" host={oc.host_s * 1e3:.1f}ms"
                     f" src={oc.source}]")
    lines.append(
        f"engine: {placement.backend} ({placement.source}; est "
        f"{placement.est_scan_rows} scan rows, device "
        f"{placement.est_device_s * 1e3:.0f}ms vs host "
        f"{placement.est_host_s * 1e3:.0f}ms, crossover "
        f"~{crossover_rows()} rows; gpu dispatch floor "
        f"{1000 * est_device_seconds(0):.3f}ms)")
    if analyze:
        from cockroach_tpu_torch.util.tracing import summarize, tracer

        st = stats.enable()
        try:
            qreg.set_phase_current("executing")
            with tracer().span("query", sql=sql[:60]) as sp:
                t0 = time.perf_counter()
                res = run(norm, catalog, capacity, mesh=mesh, sql=sql,
                          device=device, setting=setting,
                          resident=resident)
                elapsed = time.perf_counter() - t0
            n = len(next(iter(res.values()))) if res else 0
            lines.append("")
            lines.append(f"execution: {elapsed * 1e3:.1f}ms, "
                         f"{n} result rows")
            rep = st.report()
            if rep:
                lines.extend(rep.splitlines())
            # per-operator attribution: the stage timers grouped by
            # operator family (exec/stats.operator_breakdown), annotated
            # with each family's placement tier. Host-tier operators get
            # an EXPLICIT tier=host row — the row engine spends no device
            # time, and a 0/missing device-ms line misreads as "free"
            # rather than "placed on the host".
            ops = stats.operator_breakdown(st)
            fam_tier: Dict[str, str] = {}
            host_ops: List[object] = []
            rank = {"fused": 0, "streaming": 1, "host": 2}
            for node, oc in zip(_walk_plan(norm), placement.ops):
                fam = ("host" if oc.tier == "host"
                       else _FAMILY.get(type(node), "fused"))
                if rank[oc.tier] > rank.get(fam_tier.get(fam, ""), -1):
                    fam_tier[fam] = oc.tier
                if oc.tier == "host":
                    host_ops.append(oc)
            if ops or host_ops:
                lines.append("")
                lines.append("operators:")
            seen_host_fam = False
            for o in ops:
                tier = fam_tier.get(o["operator"])
                if tier == "host" or o["operator"] == "host":
                    # host family: the time is host milliseconds by
                    # construction — label it as such
                    seen_host_fam = True
                    row = (f"  {o['operator']:<12}"
                           f" {o['device_ms'] + o['other_ms']:9.1f}"
                           f" host-ms")
                else:
                    row = (f"  {o['operator']:<12}"
                           f" {o['device_ms']:9.1f} device-ms")
                    if o["other_ms"]:
                        row += f" (+{o['other_ms']:.1f} compile-ms)"
                if o["rows"]:
                    row += f" {o['rows']:12d} rows"
                if o["bytes"]:
                    row += f" {o['bytes'] / 1e6:9.1f} MB"
                if tier is not None:
                    row += f"  tier={tier}"
                lines.append(row)
            if host_ops and not seen_host_fam:
                # nothing in the stage table covered the host work:
                # still attribute it explicitly
                for oc in {(oc.name, oc.reason): oc
                           for oc in host_ops}.values():
                    lines.append(f"  {oc.name:<12}       0.0 host-ms"
                                 f"  tier=host ({oc.reason})")
            lines.append("")
            lines.extend(sp.render().splitlines())
            # resilience digest: what the span tree says happened to the
            # query on its way down the ladder (one line, greppable)
            summ = summarize(sp)
            lines.append("")
            lines.append(
                f"resilience: tier={summ['tier'] or 'n/a'} "
                f"retries={summ['retries']} "
                f"degradations={summ['degradations']} "
                f"restarts={summ['restarts']}")
            if getattr(ast, "debug", False):
                # EXPLAIN ANALYZE (DEBUG): persist the statement bundle
                # (plan + span tree + operator times + digest) and say
                # where it landed
                import os
                import tempfile

                from cockroach_tpu_torch.server.debugzip import (
                    write_statement_bundle,
                )

                path = os.path.join(
                    tempfile.gettempdir(),
                    f"stmt-bundle-{sp.trace_id:x}.zip")
                write_statement_bundle(path, sql, lines, span=sp,
                                       operators=ops, digest=summ)
                lines.append("")
                lines.append(f"statement bundle: {path}")
        finally:
            stats.disable()
    return "explain", lines, None
