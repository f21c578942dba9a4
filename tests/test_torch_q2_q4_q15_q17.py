"""TPC-H Q2, Q4, Q15 and Q17 end to end: the port on the CPU against the
JAX package and the numpy oracles.

These are the queries of the subquery shapes. Q4 is an EXISTS Apply,
which decorrelates into a semi join. Q2 is a correlated scalar Apply: a
per-part MIN over the partsupp subtree it shares with the outer query,
joined back LEFT. Q15 is an uncorrelated scalar Apply: the MAX of the
revenue aggregate it shares with the outer side, broadcast through a
constant key. Q17 is the JAX plan's hand-decorrelated AVG: a per-part
GROUP BY of all of lineitem joined back under the exact integer filter
5 * qty * n < sum.

At SF 0.01, capacity 2^14, each query's port result
(workload.tpch_queries -> exec.collect, device="cpu") must equal the JAX
package's streaming collect (fuse=False) column for column in values,
validity and row order, and must equal its oracles. The operator trees
must have the JAX package's shape, shared operators included."""

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
    JoinOp, ShrinkOp, child_operators, walk_operators,
)
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14

QUERIES = ("q2", "q4", "q15", "q17")
# FlowRestarts at this size, the JAX package's streaming count: Q4's semi
# join builds on lineitem, whose l_orderkey repeats, so its build flags
# twice, widening unique -> unique-mat -> expand
RESTARTS = {"q4": 2}


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


def _restarts(col):
    r = col.stages.get("flow.restart")
    return r.events if r else 0


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax_collect(results, name):
    want, got, col = results[name]
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0
    assert _restarts(col) == RESTARTS.get(name, 0)


def _rows(got, cols):
    for c in cols:
        assert got[c + "__valid"].all(), c
    return list(zip(*(got[c].tolist() for c in cols)))


def test_q2_matches_oracle(results, gens):
    _want, got, _col = results["q2"]
    rows = _rows(got, ("s_acctbal", "s_name", "n_name", "p_partkey",
                       "p_mfgr", "ps_supplycost", "s_suppkey"))
    assert rows == tq.q2_oracle(gens[1])
    assert len(rows) == 6


def test_q4_matches_oracle(results, gens):
    _want, got, _col = results["q4"]
    rows = _rows(got, ("o_orderpriority", "order_count"))
    oracle = tq.q4_oracle(gens[1])
    assert rows == sorted(oracle.items()) and len(rows) == 5


def test_q15_matches_oracles(results, gens):
    _want, got, _col = results["q15"]
    rows = _rows(got, ("s_suppkey", "s_name", "total_revenue"))
    assert rows == tq.q15_oracle(gens[1]) == tq.q15_oracle_columnar(gens[1])
    assert len(rows) == 1


def test_q17_matches_oracles(results, gens):
    _want, got, _col = results["q17"]
    total = _rows(got, ("sum_price",))
    assert total == [(tq.q17_oracle(gens[1]),)]
    assert tq.q17_oracle_columnar(gens[1]) == total[0][0] > 0


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


def tree_shape(op, children):
    """An operator tree as nested (type name, first-visit index, children)
    tuples: two trees have the same shape when they have the same
    operators and share the same ones. The JAX package's invariant
    checker (CheckedOp) is looked through."""
    ids = {}

    def rec(o):
        while type(o).__name__ == "CheckedOp":
            o = o.child
        k = ids.setdefault(id(o), len(ids))
        return (type(o).__name__, k, tuple(rec(c) for c in children(o)))

    return rec(op)


@pytest.mark.parametrize("name", QUERIES)
def test_operator_tree_matches_jax(gens, name):
    jgen, tgen = gens
    want = tree_shape(getattr(jq, name)(jgen, CAPACITY), jchildren)
    got = tree_shape(getattr(tq, name)(tgen, CAPACITY), child_operators)
    assert got == want


def test_q2_shares_its_partsupp_subtree():
    """Q2's partsupp join feeds both the outer query and the subquery's
    MIN: one ShrinkOp with two consumers, which a run pulls twice (the
    LEFT join's build first, then its probe)."""
    flow = tq.q2(ttpch.TPCH(sf=SF), CAPACITY)
    joins = [op for op in walk_operators(flow) if isinstance(op, JoinOp)]
    left = [j for j in joins if j.how == "left"]
    assert len(left) == 1 and left[0].build_on == ["__apply_k0"]
    outer_ps = left[0].probe.probe
    assert isinstance(outer_ps, ShrinkOp)
    consumers = [op for op in walk_operators(flow)
                 if outer_ps in child_operators(op)]
    assert len(consumers) == 2
    assert [type(c).__name__ for c in consumers] == ["JoinOp", "MapOp"]
    shrinks = [op for op in walk_operators(flow) if isinstance(op, ShrinkOp)]
    assert [s.capacity for s in shrinks] == [1 << 14, 1 << 14, 1 << 12]


def test_q15_shares_its_revenue_aggregate():
    """Q15's revenue aggregate is the outer side of the constant-key LEFT
    join and the input of its MAX: one operator, two consumers."""
    flow = tq.q15(ttpch.TPCH(sf=SF), CAPACITY)
    left = [op for op in walk_operators(flow)
            if isinstance(op, JoinOp) and op.how == "left"][0]
    assert (left.probe_on, left.build_on) == (["__apply_c0"],
                                              ["__apply_c0_"])
    rev = left.probe.child
    assert rev.group_by == ["l_suppkey"]
    scalar = left.build.child
    assert scalar.group_by == [] and scalar.child is rev


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
