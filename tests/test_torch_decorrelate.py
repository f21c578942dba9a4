"""The port's Apply decorrelation and DISTINCT against the JAX package's.

`decorrelate` (cockroach_tpu_torch/sql/plan.py) must rewrite each form of
Apply into the JAX package's plan, helper column names and node order
included, and the built flows must give the JAX package's rows, values
and validity: EXISTS and NOT EXISTS (semi and anti joins), a correlated
scalar whose groups are empty for some outer rows (NULL through the LEFT
join's validity, which a filter above then drops), and an uncorrelated
scalar over an empty input (the scalar aggregate's one NULL row, or
count 0, broadcast through the constant key). Distinct builds a
DistinctOp with and without keys; ops/distinct.py keeps the rows the
JAX package keeps on a batch with NULLs and duplicates. Q17's ShrinkOp,
started at 64 lanes in both packages, overflows on its 71 rows at SF
0.01: the flow restarts once and gives the same rows."""

import numpy as np
import pytest

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec.operators import ShrinkOp as JShrinkOp
from cockroach_tpu.exec.operators import walk_operators as jwalk
from cockroach_tpu.ops.distinct import distinct as jdistinct
from cockroach_tpu.sql import plan as jplan
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.operators import (
    DistinctOp, ShrinkOp, walk_operators,
)
from cockroach_tpu_torch.ops.distinct import distinct as tdistinct
from cockroach_tpu_torch.sql import plan as tplan
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_expr import port_batch
from test_torch_plan_stats import signature
from test_torch_q3_q18 import _assert_equal_results, _plan_pair
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 13


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


def _exists(kind):
    def make(P, E, A, S):
        cust = P.Scan("customer", ("c_custkey", "c_nationkey"))
        big = P.Filter(P.Scan("orders", ("o_custkey", "o_totalprice")),
                       E.Cmp(">", E.Col("o_totalprice"), E.Lit(300000)))
        return P.Apply(cust, big, (("c_custkey", "o_custkey"),), kind=kind)
    return make


def _correlated_scalar(filtered):
    """Each customer's largest order of the first half of 1992: a third
    of the customers have no orders at all and most have none that
    early, so their groups are empty."""
    def make(P, E, A, S):
        cust = P.Scan("customer", ("c_custkey", "c_acctbal"))
        early = P.Filter(P.Scan("orders", ("o_custkey", "o_totalprice",
                                           "o_orderdate")),
                         E.Cmp("<", E.Col("o_orderdate"), E.Lit(8217)))
        ap = P.Apply(cust, early, (("c_custkey", "o_custkey"),),
                     kind="scalar",
                     scalar=A.AggSpec("max", "o_totalprice", "max_price"))
        if not filtered:
            return ap
        # NULL max_price compares NULL: the filter drops those rows
        return P.Filter(ap, E.Cmp("<", E.Col("max_price"),
                                  E.BinOp("*", E.Col("c_acctbal"),
                                          E.Lit(20))))
    return make


def _uncorrelated_scalar(func, col):
    """A scalar subquery over no rows, broadcast to every nation."""
    def make(P, E, A, S):
        nation = P.Scan("nation", ("n_nationkey", "n_regionkey"))
        empty = P.Filter(P.Scan("region", ("r_regionkey",)),
                         E.Cmp(">", E.Col("r_regionkey"), E.Lit(100)))
        return P.Apply(nation, empty, (), kind="scalar",
                       scalar=A.AggSpec(func, col, "s"))
    return make


PLANS = {
    "exists": _exists("exists"),
    "not_exists": _exists("not_exists"),
    "scalar_empty_groups": _correlated_scalar(False),
    "scalar_empty_groups_filtered": _correlated_scalar(True),
    "uncorrelated_max_of_nothing": _uncorrelated_scalar("max",
                                                        "r_regionkey"),
    "uncorrelated_count_of_nothing": _uncorrelated_scalar("count_star",
                                                          None),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_decorrelate_matches_jax(gens, name):
    jgen, tgen = gens
    jp, tp, _jplan, _tplan = _plan_pair(PLANS[name])
    jcat, tcat = jplan.TPCHCatalog(jgen), tplan.TPCHCatalog(tgen)
    assert (signature(tplan.decorrelate(tp, tcat))
            == signature(jplan.decorrelate(jp, jcat)))
    assert (signature(tplan.normalize(tp, tcat))
            == signature(jplan.normalize(jp, jcat)))
    assert (tplan._plan_columns(tp, tcat)
            == jplan._plan_columns(jp, jcat))
    want = jcollect(jplan.build(jp, jcat, CAPACITY), fuse=False)
    got = tcollect(tplan.build(tp, tcat, CAPACITY), device="cpu", fuse=False)
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0


def test_scalar_apply_surfaces_empty_groups_as_null(gens):
    _jgen, tgen = gens
    tp = _plan_pair(PLANS["scalar_empty_groups"])[1]
    got = tcollect(tplan.build(tp, tplan.TPCHCatalog(tgen), CAPACITY),
                   device="cpu", fuse=False)
    valid = got["max_price__valid"]
    assert 0 < valid.sum() < len(valid)
    assert list(got) == ["c_custkey", "c_custkey__valid", "c_acctbal",
                         "c_acctbal__valid", "max_price",
                         "max_price__valid"]
    tp = _plan_pair(PLANS["scalar_empty_groups_filtered"])[1]
    kept = tcollect(tplan.build(tp, tplan.TPCHCatalog(tgen), CAPACITY),
                    device="cpu", fuse=False)
    assert kept["max_price__valid"].all()
    assert 0 < len(kept["c_custkey"]) < valid.sum()


@pytest.mark.parametrize("func,want_valid", [("max", False),
                                             ("count_star", True)])
def test_uncorrelated_scalar_of_nothing(gens, func, want_valid):
    _jgen, tgen = gens
    name = ("uncorrelated_max_of_nothing" if func == "max"
            else "uncorrelated_count_of_nothing")
    tp = _plan_pair(PLANS[name])[1]
    got = tcollect(tplan.build(tp, tplan.TPCHCatalog(tgen), CAPACITY),
                   device="cpu", fuse=False)
    assert len(got["n_nationkey"]) == 25
    assert got["s__valid"].tolist() == [want_valid] * 25
    if want_valid:
        assert got["s"].tolist() == [0] * 25


def test_decorrelate_names_its_helper_columns():
    """The helper keys: __apply_k{i} for a correlated scalar's inner
    correlation columns, __apply_c0 / __apply_c0_ for the constant key;
    the final projection strips them."""
    _jp, tp, _jplan, _tplan = _plan_pair(PLANS["scalar_empty_groups"])
    cat = tplan.TPCHCatalog(ttpch.TPCH(sf=SF))
    out = tplan.decorrelate(tp, cat)
    join = out.input
    assert (join.how, join.left_on, join.right_on) == (
        "left", ("c_custkey",), ("__apply_k0",))
    assert [n for n, _ in out.outputs] == ["c_custkey", "c_acctbal",
                                           "max_price"]
    _jp, tp, _jplan, _tplan = _plan_pair(PLANS["uncorrelated_max_of_nothing"])
    join = tplan.decorrelate(tp, cat).input
    assert (join.left_on, join.right_on) == (("__apply_c0",),
                                             ("__apply_c0_",))
    _jp, tp, _jplan, _tplan = _plan_pair(PLANS["not_exists"])
    join = tplan.decorrelate(tp, cat)
    assert (join.how, join.left_on, join.right_on) == (
        "anti", ("c_custkey",), ("o_custkey",))
    bad = tplan.Apply(tp.input, tp.sub, tp.correlation, kind="scalar")
    with pytest.raises(TypeError, match="scalar AggSpec"):
        tplan.decorrelate(bad, cat)


@pytest.mark.parametrize("keys", [None, ("l_returnflag", "l_linestatus")])
def test_distinct_matches_jax(gens, keys):
    jgen, tgen = gens

    def make(P, E, A, S):
        line = P.Scan("lineitem", ("l_returnflag", "l_linestatus",
                                   "l_shipmode"))
        return P.Distinct(line, keys)

    jp, tp, _jplan, _tplan = _plan_pair(make)
    jcat, tcat = jplan.TPCHCatalog(jgen), tplan.TPCHCatalog(tgen)
    assert (signature(tplan.normalize(tp, tcat))
            == signature(jplan.normalize(jp, jcat)))
    assert tplan._plan_columns(tp, tcat) == jplan._plan_columns(jp, jcat)
    assert (tplan.estimate_cardinality(tp, tcat)
            == jplan.estimate_cardinality(jp, jcat))
    flow = tplan.build(tp, tcat, CAPACITY)
    assert isinstance(flow, DistinctOp)
    assert list(walk_operators(flow))[1] is flow._agg
    want = jcollect(jplan.build(jp, jcat, CAPACITY), fuse=False)
    got = tcollect(flow, device="cpu", fuse=False)
    _assert_equal_results(want, got)
    n = len(got["l_returnflag"])
    assert n == (4 if keys else len(set(zip(
        got["l_returnflag"], got["l_linestatus"], got["l_shipmode"]))))


def _dup_batch():
    """A batch with duplicate key tuples, NULLs in each key, NaN and -0.0
    beside 0.0, and dead lanes."""
    rng = np.random.default_rng(20261017)
    n = 1000
    a = rng.integers(0, 4, n)
    f = rng.choice(np.array([0.0, -0.0, 1.5, np.nan], np.float32), n)
    s = rng.integers(0, 3, n).astype(np.int32)
    cols = {
        "a": jbatch.Column(jnp.asarray(a), jnp.asarray(rng.random(n) > 0.2)),
        "f": jbatch.Column(jnp.asarray(f), jnp.asarray(rng.random(n) > 0.1)),
        "s": jbatch.Column(jnp.asarray(s)),
    }
    sel = rng.random(n) > 0.15
    return jbatch.Batch(cols, jnp.asarray(sel), jnp.int32(int(sel.sum())))


@pytest.mark.parametrize("keys", [("a",), ("a", "f"), ("f", "s"),
                                  ("a", "f", "s")])
def test_ops_distinct_matches_jax(keys):
    jb = _dup_batch()
    want = jdistinct(jb, keys)
    got = tdistinct(port_batch(jb), keys)
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    assert int(got.length) == int(want.length)
    assert 1 < int(got.length) < int(jb.length)


def test_q17_shrink_restarts_once_and_matches(gens):
    """Q17's ShrinkOp (above the semi join of lineitem against the
    Brand#23 MED BOX parts) started at 64 lanes in both packages: the
    71 rows at SF 0.01 overflow it once, it widens 16x, and the rows
    equal the JAX package's run under the same start capacity."""
    jgen, tgen = gens
    jflow, tflow = jq.q17(jgen, 1 << 14), tq.q17(tgen, 1 << 14)
    for op in jwalk(jflow):
        if isinstance(op, JShrinkOp):
            op.capacity = 64
    shrinks = [op for op in walk_operators(tflow) if isinstance(op, ShrinkOp)]
    assert len(shrinks) == 1
    shrinks[0].capacity = 64
    want = jcollect(jflow, fuse=False)
    with stats.query_stats() as col:
        got = tcollect(tflow, device="cpu", fuse=False)
    _assert_equal_results(want, got)
    assert col.stages["flow.restart"].events == 1
    assert shrinks[0].capacity == 64 * 16
    assert got["sum_price"].tolist() == [tq.q17_oracle(tgen)]
