"""TPC-H Q6, Q3 and Q18 end to end: the port on the CPU against the JAX
package and the numpy oracles.

At SF 0.01, capacity 2^14 (Q18 with threshold 150, since no order of SF
0.01 passes the spec's 300), each query's port result
(workload.tpch_queries -> exec.collect, device="cpu") must equal the JAX
package's streaming collect (fuse=False) column for column in values,
validity and row order — integer, decimal, date and dictionary-code
columns all — and must equal the query's oracle. The port's columnar
oracles must equal its row-loop oracles. At capacity 2^12 Q18's first
aggregate (about 15,000 groups) overflows its accumulator: the flow
restarts, widens, and still gives the same rows."""

import numpy as np
import pytest
import torch

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.operators import (
    HashAggOp, JoinOp, MapOp, ScanOp, ShrinkOp, TopKOp, walk_operators,
)
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14
Q18_THRESHOLD = 150

QUERIES = {
    "q6": (lambda g, cap: jq.q6(g, cap), lambda g, cap: tq.q6(g, cap)),
    "q3": (lambda g, cap: jq.q3(g, cap), lambda g, cap: tq.q3(g, cap)),
    "q18": (lambda g, cap: jq.q18(g, Q18_THRESHOLD, cap),
            lambda g, cap: tq.q18(g, Q18_THRESHOLD, cap)),
}


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


def _run(name, gens, capacity):
    jgen, tgen = gens
    jflow, tflow = QUERIES[name]
    want = jcollect(jflow(jgen, capacity), fuse=False)
    with stats.query_stats() as col:
        got = tcollect(tflow(tgen, capacity), device="cpu", fuse=False)
    return want, got, col


@pytest.fixture(scope="module")
def results(gens):
    return {name: _run(name, gens, CAPACITY) for name in QUERIES}


def _assert_equal_results(want, got):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_on_card_matches_cpu(gens, name):
    """The same flow on the card and on the CPU: equal results, row
    order included (chip_smoke.py phase 6 runs the queries at SF 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 6 runs the "
                    "queries at SF 1 there)")
    build = QUERIES[name][1]
    cpu = tcollect(build(gens[1], CAPACITY), device="cpu", fuse=False)
    with stats.query_stats() as col:
        card = tcollect(build(gens[1], CAPACITY), device="cuda", fuse=False)
    _assert_equal_results(cpu, card)
    assert "flow.restart" not in col.stages


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax_collect(results, name):
    want, got, _col = results[name]
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0


def test_q6_matches_oracle(results, gens):
    _want, got, _col = results["q6"]
    assert got["revenue"].tolist() == [tq.q6_oracle(gens[1])]
    assert got["revenue__valid"].tolist() == [True]


def test_q3_matches_oracles(results, gens):
    _want, got, _col = results["q3"]
    rows = list(zip(got["l_orderkey"].tolist(), got["revenue"].tolist(),
                    got["o_orderdate"].tolist()))
    assert rows == tq.q3_oracle(gens[1])
    columnar = tq.q3_oracle_columnar(gens[1])
    assert [r[:3] for r in columnar] == rows
    assert [r[3] for r in columnar] == got["o_shippriority"].tolist()


def test_q18_matches_oracles(results, gens):
    _want, got, _col = results["q18"]
    rows = list(zip(*(got[c].tolist() for c in (
        "c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice",
        "sum_qty"))))
    assert rows == tq.q18_oracle(gens[1], Q18_THRESHOLD)
    assert tq.q18_oracle_columnar(gens[1], Q18_THRESHOLD) == rows


@pytest.mark.parametrize("name", ["q3", "q18"])
def test_columnar_oracles_match_jax_package(gens, name):
    """The port's columnar oracles agree with the JAX package's on the
    rows both define (the JAX ones break ties of the sort keys by
    array order; none occurs at this size)."""
    jgen, tgen = gens
    if name == "q3":
        assert tq.q3_oracle_columnar(tgen) == jq.q3_oracle_columnar(jgen)
    else:
        assert (tq.q18_oracle_columnar(tgen, Q18_THRESHOLD)
                == jq.q18_oracle_columnar(jgen, Q18_THRESHOLD))


def test_q18_restarts_on_overflow_and_matches(gens):
    """At capacity 2^12 the first aggregate's ~15,000 groups overflow a
    4,096-lane accumulator: the flow restarts (twice, doubling the
    expansion each time) and equals the JAX package's run."""
    want, got, col = _run("q18", gens, 1 << 12)
    _assert_equal_results(want, got)
    assert col.stages["flow.restart"].events == 2
    # a widened flow keeps its expansion: a second run restarts no more
    tflow = tq.q18(gens[1], Q18_THRESHOLD, 1 << 12)
    tcollect(tflow, device="cpu", fuse=False)
    with stats.query_stats() as again:
        tcollect(tflow, device="cpu", fuse=False)
    assert "flow.restart" not in again.stages


def test_q18_operator_tree():
    flow = tq.q18(ttpch.TPCH(sf=SF), Q18_THRESHOLD, CAPACITY)
    kinds = [type(op).__name__ for op in walk_operators(flow)]
    # Q18's two lineitem scans are one ScanOp (value-equal plan memo), so
    # the deduplicated walk meets it once; the JAX package's plan puts a
    # ShrinkOp above the semi join and one above the HAVING filter
    assert kinds == ["TopKOp", "HashAggOp", "JoinOp", "ScanOp", "JoinOp",
                     "ShrinkOp", "JoinOp", "ScanOp", "MapOp", "ShrinkOp",
                     "MapOp", "HashAggOp", "ScanOp"]
    shrinks = [op for op in walk_operators(flow) if isinstance(op, ShrinkOp)]
    assert [s.capacity for s in shrinks] == [1 << 14, 1 << 12]
    assert shrinks[0].child.how == "semi"
    assert isinstance(shrinks[1].child, MapOp)
    lineitem = flow.child.child.probe
    assert lineitem.table == "lineitem"
    assert [op for op in walk_operators(flow)
            if isinstance(op, HashAggOp)][1].child is lineitem
    joins = [op for op in walk_operators(flow) if isinstance(op, JoinOp)]
    assert [j.how for j in joins] == ["inner", "inner", "semi"]
    aggs = [op for op in walk_operators(flow) if isinstance(op, HashAggOp)]
    assert [a.group_by for a in aggs] == [
        ["c_name", "c_custkey", "o_orderkey", "o_orderdate", "o_totalprice"],
        ["l_orderkey"]]
    assert all(a.dense_sizes is None for a in aggs)
    scans = [op for op in walk_operators(flow) if isinstance(op, ScanOp)]
    assert sorted(s.table for s in scans) == ["customer", "lineitem",
                                              "orders"]


def test_q3_operator_tree():
    flow = tq.q3(ttpch.TPCH(sf=SF), CAPACITY)
    assert isinstance(flow, TopKOp) and flow.k == 10
    kinds = [type(op).__name__ for op in walk_operators(flow)]
    assert kinds == ["TopKOp", "HashAggOp", "JoinOp", "MapOp", "MapOp",
                     "ScanOp", "ShrinkOp", "JoinOp", "MapOp", "ScanOp",
                     "MapOp", "MapOp", "ScanOp"]
    # the JAX package's plan compacts the orders side of the big join
    # (start capacity 2^12 at SF 0.01, 2^18 at SF 1)
    shrink = flow.child.child.build
    assert isinstance(shrink, ShrinkOp) and shrink.capacity == 1 << 12
    assert shrink.child.how == "semi"
    agg = flow.child
    assert agg.group_by == ["l_orderkey", "o_orderdate", "o_shippriority"]
    assert agg.dense_sizes is None
    # the pushed-down filters land just above their scans
    semi = [op for op in walk_operators(flow)
            if isinstance(op, JoinOp) and op.how == "semi"][0]
    assert isinstance(semi.probe, MapOp) and isinstance(semi.probe.child,
                                                        ScanOp)


def test_q6_is_a_scalar_aggregate():
    flow = tq.q6(ttpch.TPCH(sf=SF), CAPACITY)
    assert isinstance(flow, HashAggOp) and flow.group_by == []
    assert flow.dense_sizes is None


def test_past_workmem_raises_naming_roadmap(gens):
    """The grace (out-of-core) paths are ported: past workmem Q18's first
    aggregate (at 1 KiB) takes the grace GROUP BY and Q3's joins (at 16
    KiB, where the JAX package's grace join partitions once instead of
    recursing to its deepest level) the grace join; both complete and
    equal the JAX package's results under the same budgets, row order
    included, and release every spilled byte."""
    from cockroach_tpu_torch.exec.spill import host_spill_monitor

    jgen, tgen = gens
    cases = (("q18", HashAggOp, jops.HashAggOp, 1 << 10, "agg.grace_spill"),
             ("q3", JoinOp, jops.JoinOp, 1 << 14, "join.grace_spill"))
    for name, tcls, jcls, workmem, stage in cases:
        flows = []
        for mod, gen, cls, walk in ((jq, jgen, jcls, jops.walk_operators),
                                    (tq, tgen, tcls, walk_operators)):
            flow = (mod.q18(gen, Q18_THRESHOLD, CAPACITY) if name == "q18"
                    else mod.q3(gen, CAPACITY))
            for op in walk(flow):
                if isinstance(op, cls) and (
                        name == "q3" or op.group_by == ["l_orderkey"]):
                    op.workmem = workmem
            flows.append(flow)
        want = jcollect(flows[0], fuse=False)
        with stats.query_stats() as col:
            got = tcollect(flows[1], device="cpu", fuse=False)
        assert col.stages[stage].events >= 1, name
        _assert_equal_results(want, got)
        assert host_spill_monitor().used == 0


def test_empty_scalar_aggregate_emits_one_row(gens):
    """Q6 over no qualifying rows: one row, revenue NULL (as JAX)."""
    from cockroach_tpu.sql import plan as jplan
    from cockroach_tpu.ops.expr import Cmp as JCmp, Col as JCol, Lit as JLit
    from cockroach_tpu_torch.ops.expr import Cmp, Col, Lit
    from cockroach_tpu_torch.sql import plan as tplan

    jgen, tgen = gens
    jp = jq.q6_plan()
    jp = jplan.Aggregate(jplan.Filter(jp.input, JCmp("<", JCol("rev"),
                                                     JLit(0))),
                         jp.group_by, jp.aggs)
    tp = tq.q6_plan()
    tp = tplan.Aggregate(tplan.Filter(tp.input, Cmp("<", Col("rev"),
                                                    Lit(0))),
                         tp.group_by, tp.aggs)
    want = jcollect(jplan.build(jp, jplan.TPCHCatalog(jgen), CAPACITY),
                    fuse=False)
    got = tcollect(tplan.build(tp, tplan.TPCHCatalog(tgen), CAPACITY),
                   device="cpu", fuse=False)
    _assert_equal_results(want, got)
    assert got["revenue__valid"].tolist() == [False]


def _plan_pair(make):
    """The same plan built from each package's plan classes: `make(P, E)`
    takes a plan module and an expression module."""
    from cockroach_tpu.ops import agg as jagg
    from cockroach_tpu.ops import expr as jexpr
    from cockroach_tpu.ops import sort as jsort
    from cockroach_tpu.sql import plan as jplan
    from cockroach_tpu_torch.ops import agg as tagg
    from cockroach_tpu_torch.ops import expr as texpr
    from cockroach_tpu_torch.ops import sort as tsort
    from cockroach_tpu_torch.sql import plan as tplan

    return (make(jplan, jexpr, jagg, jsort), make(tplan, texpr, tagg, tsort),
            jplan, tplan)


@pytest.mark.parametrize("n,offset", [(7, 0), (5, 3), (40000, 10)])
def test_limit_matches_jax(gens, n, offset):
    """Limit without an ORDER BY below it: LimitOp over the stream."""
    jgen, tgen = gens
    (jp, tp, jplan, tplan) = _plan_pair(
        lambda P, E, A, S: P.Limit(P.Scan("orders", ("o_orderkey",
                                                     "o_totalprice")),
                                   n, offset))
    want = jcollect(jplan.build(jp, jplan.TPCHCatalog(jgen), 1 << 12),
                    fuse=False)
    flow = tplan.build(tp, tplan.TPCHCatalog(tgen), 1 << 12)
    assert type(flow).__name__ == "LimitOp"
    _assert_equal_results(want, tcollect(flow, device="cpu", fuse=False))


def test_ordered_aggregate_plan_matches_jax(gens):
    """An Aggregate whose input is ordered on its keys builds an
    OrderedAggOp, whose partial skips the sort."""
    jgen, tgen = gens

    def make(P, E, A, S):
        line = P.Scan("lineitem", ("l_orderkey", "l_quantity",
                                   "l_extendedprice"))
        ordered = P.OrderBy(line, (S.SortKey("l_orderkey"),))
        return P.Aggregate(ordered, ("l_orderkey",),
                           (A.AggSpec("sum", "l_quantity", "q"),
                            A.AggSpec("max", "l_extendedprice", "mx"),
                            A.AggSpec("count_star", None, "n")))

    jp, tp, jplan, tplan = _plan_pair(make)
    want = jcollect(jplan.build(jp, jplan.TPCHCatalog(jgen), 1 << 13),
                    fuse=False)
    flow = tplan.build(tp, tplan.TPCHCatalog(tgen), 1 << 13)
    assert type(flow).__name__ == "OrderedAggOp"
    _assert_equal_results(want, tcollect(flow, device="cpu", fuse=False))
