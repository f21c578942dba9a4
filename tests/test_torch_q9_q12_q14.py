"""TPC-H Q9, Q12 and Q14 end to end: the port on the CPU against the JAX
package and the numpy oracles.

At SF 0.01, capacity 2^14, each query's port result
(workload.tpch_queries -> exec.collect, device="cpu") must equal the JAX
package's streaming collect (fuse=False) column for column in values,
validity and row order, and must equal the query's oracle; the columnar
oracles must equal the row-loop ones. Q9 runs LIKE, EXTRACT, a
composite-key join and the ShrinkOp the JAX plan puts above its semi
join; Q12 runs IN and CASE and its dense GROUP BY (K1's path); Q14 runs
LIKE inside CASE. With Q9's ShrinkOp set to 256 lanes in both packages,
the flow restarts once, widens 16x and gives the same rows."""

import numpy as np
import pytest
import torch

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec.operators import ShrinkOp as JShrinkOp
from cockroach_tpu.exec.operators import walk_operators as jwalk
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.operators import (
    HashAggOp, JoinOp, ShrinkOp, SortOp, walk_operators,
)
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14

QUERIES = ("q9", "q12", "q14")


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


def _run(name, gens, capacity, shrink_capacity=None):
    jgen, tgen = gens
    jflow = getattr(jq, name)(jgen, capacity)
    tflow = getattr(tq, name)(tgen, capacity)
    if shrink_capacity is not None:
        for op in jwalk(jflow):
            if isinstance(op, JShrinkOp):
                op.capacity = shrink_capacity
        for op in walk_operators(tflow):
            if isinstance(op, ShrinkOp):
                op.capacity = shrink_capacity
    want = jcollect(jflow, fuse=False)
    with stats.query_stats() as col:
        got = tcollect(tflow, device="cpu", fuse=False)
    return want, got, col, tflow


@pytest.fixture(scope="module")
def results(gens):
    return {name: _run(name, gens, CAPACITY) for name in QUERIES}


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax_collect(results, name):
    want, got, col, _flow = results[name]
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0
    assert "flow.restart" not in col.stages


def _q9_rows(got, gen):
    names = gen.schema("nation").dicts["n_name"]
    return [(str(names[n]), y, s) for n, y, s in zip(
        got["n_name"].tolist(), got["o_year"].tolist(),
        got["sum_profit"].tolist())]


def test_q9_matches_oracles(results, gens):
    _want, got, _col, _flow = results["q9"]
    rows = _q9_rows(got, gens[1])
    # ORDER BY n_name, o_year DESC
    assert [r[:2] for r in rows] == sorted(
        (r[:2] for r in rows), key=lambda k: (k[0], -k[1]))
    oracle = tq.q9_oracle(gens[1])
    assert {(n, y): s for n, y, s in rows} == oracle
    assert tq.q9_oracle_columnar(gens[1]) == oracle
    assert all(got[c + "__valid"].all() for c in ("n_name", "o_year",
                                                   "sum_profit"))


def test_q12_matches_oracles(results, gens):
    _want, got, _col, _flow = results["q12"]
    rows = {m: (h, lo) for m, h, lo in zip(
        got["l_shipmode"].tolist(), got["high_line_count"].tolist(),
        got["low_line_count"].tolist())}
    oracle = tq.q12_oracle(gens[1])
    assert rows == oracle and len(rows) == 2
    assert tq.q12_oracle_columnar(gens[1]) == oracle
    names = gens[1].schema("lineitem").dicts["l_shipmode"]
    modes = [str(names[m]) for m in got["l_shipmode"].tolist()]
    assert modes == sorted(modes) == ["MAIL", "SHIP"]


def test_q14_matches_oracles(results, gens):
    _want, got, _col, _flow = results["q14"]
    row = (int(got["promo_revenue"][0]), int(got["total_revenue"][0]))
    assert row == tq.q14_oracle(gens[1]) == tq.q14_oracle_columnar(gens[1])
    assert 0 < row[0] < row[1]


@pytest.mark.parametrize("name", ["q9", "q12", "q14"])
def test_columnar_oracles_match_jax_package(gens, name):
    """The port's oracles agree with the JAX package's row-loop ones."""
    jgen, tgen = gens
    want = getattr(jq, name + "_oracle")(jgen)
    assert getattr(tq, name + "_oracle_columnar")(tgen) == want
    if name == "q9":
        assert tq.q9_oracle_columnar(tgen) == jq.q9_oracle_columnar(jgen)


def test_q9_shrink_restarts_widens_and_matches(gens):
    """A 256-lane ShrinkOp overflows on Q9's semi-join output (about
    3,000 rows at SF 0.01): the flow restarts once, the ShrinkOp widens
    16x to 4,096 lanes, and the rows equal the JAX package's run under
    the same start capacity."""
    want, got, col, tflow = _run("q9", gens, CAPACITY, shrink_capacity=256)
    _assert_equal_results(want, got)
    assert col.stages["flow.restart"].events == 1
    shrink = [op for op in walk_operators(tflow)
              if isinstance(op, ShrinkOp)][0]
    assert shrink.capacity == 256 * 16
    # the widened flow keeps its capacity: a second run restarts no more
    with stats.query_stats() as again:
        _assert_equal_results(got, tcollect(tflow, device="cpu", fuse=False))
    assert "flow.restart" not in again.stages


def test_q9_operator_tree():
    flow = tq.q9(ttpch.TPCH(sf=SF), CAPACITY)
    assert isinstance(flow, SortOp)
    shrinks = [op for op in walk_operators(flow) if isinstance(op, ShrinkOp)]
    assert len(shrinks) == 1 and shrinks[0].capacity == 1 << 14
    assert shrinks[0].child.how == "semi"
    joins = [op for op in walk_operators(flow) if isinstance(op, JoinOp)]
    assert [j.probe_on for j in joins] == [
        ["s_nationkey"], ["l_orderkey"], ["l_suppkey", "l_partkey"],
        ["l_suppkey"], ["l_partkey"]]
    agg = [op for op in walk_operators(flow) if isinstance(op, HashAggOp)]
    assert agg[0].group_by == ["n_name", "o_year"]
    assert agg[0].dense_sizes is None


def test_q12_takes_the_dense_route_and_q14_the_scalar_one():
    gen = ttpch.TPCH(sf=SF)
    agg = tq.q12(gen, CAPACITY).child
    assert isinstance(agg, HashAggOp) and agg.group_by == ["l_shipmode"]
    assert agg.dense_sizes is not None
    q14 = tq.q14(gen, CAPACITY)
    assert isinstance(q14, HashAggOp) and q14.group_by == []
    assert not [op for op in walk_operators(q14) if isinstance(op, ShrinkOp)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", QUERIES)
def test_query_on_card_matches_cpu(gens, name):
    """The same flow on the card and on the CPU: equal results, row
    order included (chip_smoke.py phase 7 runs the queries at SF 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 7 runs the "
                    "queries at SF 1 there)")
    build = getattr(tq, name)
    cpu = tcollect(build(gens[1], CAPACITY), device="cpu", fuse=False)
    card = tcollect(build(gens[1], CAPACITY), device="cuda", fuse=False)
    _assert_equal_results(cpu, card)
    assert all(np.asarray(v).size for v in card.values())
