"""TPC-H Q5, Q10, Q16 and Q19 end to end: the port on the CPU against the
JAX package and the numpy oracles.

Q5 joins on the composite key (l_suppkey, c_nationkey) and groups by
n_name on the dense route (K1's path). Q10 groups by four keys, among
them the dictionary column c_name, and keeps the top 20 tie-broken on
c_custkey. Q16 filters with NOT LIKE and an IN over the INT column
p_size, anti-joins the suppliers with complaints, and counts after a
DISTINCT on four keys (DistinctOp). Q19 filters its join with part by a
three-branch OR of ANDs with decimal literals.

At SF 0.01, capacity 2^14, each query's port result
(workload.tpch_queries -> exec.collect, device="cpu") must equal the JAX
package's streaming collect (fuse=False) column for column in values,
validity and row order, and must equal its oracles. The operator trees
must have the JAX package's shape."""

import numpy as np
import pytest
import torch

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec.operators import child_operators as jchildren
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.operators import (
    DistinctOp, HashAggOp, JoinOp, child_operators, walk_operators,
)
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_q2_q4_q15_q17 import tree_shape
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14

QUERIES = ("q5", "q10", "q16", "q19")


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


def _run(name, gens):
    jgen, tgen = gens
    want = jcollect(getattr(jq, name)(jgen, CAPACITY), fuse=False)
    with stats.query_stats() as col:
        got = tcollect(getattr(tq, name)(tgen, CAPACITY), device="cpu",
                       fuse=False)
    return want, got, col


@pytest.fixture(scope="module")
def results(gens):
    return {name: _run(name, gens) for name in QUERIES}


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax_collect(results, name):
    want, got, col = results[name]
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0
    assert "flow.restart" not in col.stages


def _rows(got, cols):
    for c in cols:
        assert got[c + "__valid"].all(), c
    return list(zip(*(got[c].tolist() for c in cols)))


def test_q5_matches_oracles(results, gens):
    _want, got, _col = results["q5"]
    rows = _rows(got, ("n_name", "revenue"))
    oracle = tq.q5_oracle(gens[1])
    assert dict(rows) == oracle == tq.q5_oracle_columnar(gens[1])
    # ORDER BY revenue DESC, n_name
    assert [r[1] for r in rows] == sorted(oracle.values(), reverse=True)


def test_q10_matches_oracles(results, gens):
    _want, got, _col = results["q10"]
    rows = _rows(got, ("c_custkey", "c_name", "c_acctbal", "n_name",
                       "revenue"))
    assert rows == tq.q10_oracle(gens[1]) == tq.q10_oracle_columnar(gens[1])
    assert len(rows) == 20


def test_q16_matches_oracle(results, gens):
    """supplier_cnt DESC, then p_brand, p_type (in name order, as ORDER
    BY orders a dictionary column) and p_size."""
    _want, got, _col = results["q16"]
    rows = _rows(got, ("p_brand", "p_type", "p_size", "supplier_cnt"))
    oracle = tq.q16_oracle(gens[1])
    brand = tq.name_rank(gens[1], "part", "p_brand")
    ptype = tq.name_rank(gens[1], "part", "p_type")
    want = sorted(((b, t, z, n) for (b, t, z), n in oracle.items()),
                  key=lambda r: (-r[3], brand[r[0]], ptype[r[1]], r[2]))
    assert rows == want and len(rows) == 294


def test_q19_matches_oracle(results, gens):
    _want, got, _col = results["q19"]
    assert _rows(got, ("revenue",)) == [(tq.q19_oracle(gens[1]),)]
    assert got["revenue"][0] > 0


@pytest.mark.parametrize("name", QUERIES)
def test_oracles_match_jax_package(gens, name):
    """The port's row oracles equal the JAX package's, and its columnar
    oracles equal its row oracles."""
    jgen, tgen = gens
    want = getattr(jq, name + "_oracle")(jgen)
    assert getattr(tq, name + "_oracle")(tgen) == want
    columnar = getattr(tq, name + "_oracle_columnar", None)
    if columnar is not None:
        assert columnar(tgen) == want


@pytest.mark.parametrize("name", QUERIES)
def test_operator_tree_matches_jax(gens, name):
    jgen, tgen = gens
    want = tree_shape(getattr(jq, name)(jgen, CAPACITY), jchildren)
    got = tree_shape(getattr(tq, name)(tgen, CAPACITY), child_operators)
    assert got == want


def test_q5_composite_join_and_dense_group_by():
    flow = tq.q5(ttpch.TPCH(sf=SF), CAPACITY)
    joins = [op for op in walk_operators(flow) if isinstance(op, JoinOp)]
    assert joins[0].probe_on == ["l_suppkey", "c_nationkey"]
    assert joins[0].build_on == ["s_suppkey", "s_nationkey"]
    agg = flow.child
    assert isinstance(agg, HashAggOp) and agg.group_by == ["n_name"]
    assert agg.dense_sizes == [26]  # 25 nations and a NULL slot


def test_q16_distinct_runs_a_keys_only_group_by():
    flow = tq.q16(ttpch.TPCH(sf=SF), CAPACITY)
    dist = [op for op in walk_operators(flow) if isinstance(op, DistinctOp)]
    assert len(dist) == 1
    assert dist[0]._agg.group_by == ["p_brand", "p_type", "p_size",
                                     "ps_suppkey"]
    assert dist[0]._agg.user_aggs == []
    assert dist[0].schema.names() == dist[0]._agg.group_by
    anti = [op for op in walk_operators(flow)
            if isinstance(op, JoinOp) and op.how == "anti"]
    assert len(anti) == 1 and anti[0].build_on == ["bad_sk"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", QUERIES)
def test_query_on_card_matches_cpu(gens, name):
    """The same flow on the card and on the CPU: equal results, row
    order included (chip_smoke.py phase 8 runs the queries at SF 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 8 runs the "
                    "queries at SF 1 there)")
    build = getattr(tq, name)
    cpu = tcollect(build(gens[1], CAPACITY), device="cpu", fuse=False)
    card = tcollect(build(gens[1], CAPACITY), device="cuda", fuse=False)
    _assert_equal_results(cpu, card)
    assert all(np.asarray(v).size for v in card.values())
