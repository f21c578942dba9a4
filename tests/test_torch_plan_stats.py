"""The port's planner passes (cockroach_tpu_torch/sql/plan.py normalize,
estimate_cardinality, insert_shrinks; sql/stats.py) and its ShrinkOp
against the JAX package's.

For the fifteen TPC-H queries of the JAX package's PLANS at SF 0.01 and
SF 1, the port's normalize (Apply decorrelation included) must give the
JAX package's plan: the same node kinds, tables, columns, predicates,
join keys and join types, the same helper column names, and each Shrink
with the same start capacity. The catalogs sample only the first 4 chunks of
2^14 rows of a table, so SF 1 plans cheaply. ShrinkOp's compaction must
equal the JAX package's shrink_traceable bit for bit, overflow flag
included."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec.operators import ShrinkOp as JShrinkOp
from cockroach_tpu.ops.expr import Expr as JExpr
from cockroach_tpu.sql import plan as jplan
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.coldata.batch import ColType
from cockroach_tpu_torch.exec.operators import ShrinkOp, walk_operators
from cockroach_tpu_torch.ops.expr import Expr as TExpr
from cockroach_tpu_torch.sql import plan as tplan
from cockroach_tpu_torch.sql import stats as tstats
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_expr import port_batch
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = {f"q{n}": (lambda g, n=n: jq.PLANS[n](g),
                     lambda g, n=n: tq.PLANS[n](g))
           for n in sorted(jq.PLANS)}

# start capacities of the JAX package's plans at SF 1 (Q2's and Q15's
# shared subplans appear once under each consumer)
SF1_SHRINKS = {"q1": [], "q2": [1 << 14, 1 << 14, 1 << 12, 1 << 14,
                                1 << 14, 1 << 12],
               "q3": [1 << 18], "q4": [], "q5": [1 << 22, 1 << 14, 1 << 12],
               "q6": [], "q9": [1 << 20], "q10": [1 << 19], "q12": [],
               "q14": [], "q15": [1 << 12], "q16": [1 << 12],
               "q17": [1 << 19], "q18": [1 << 14, 1 << 12], "q19": []}


def test_port_plans_are_the_jax_packages_fifteen():
    assert sorted(tq.PLANS) == sorted(jq.PLANS)
    assert sorted(tq.QUERIES) == sorted(jq.QUERIES)


@pytest.fixture(scope="module", params=[0.01, 1])
def catalogs(request):
    sf = request.param
    jgen, tgen = jtpch.TPCH(sf=sf), ttpch.TPCH(sf=sf)
    return (sf, jgen, tgen, jplan.TPCHCatalog(jgen),
            tplan.TPCHCatalog(tgen))


def signature(node):
    """A plan or expression as nested tuples of plain values, the same
    for both packages' classes: class names, fields, column types."""
    if isinstance(node, (jplan.Plan, tplan.Plan, JExpr, TExpr)) or (
            dataclasses.is_dataclass(node) and not isinstance(node, type)
            and not isinstance(node, (jbatch.ColType, ColType))):
        return (type(node).__name__,) + tuple(
            (f.name, signature(getattr(node, f.name)))
            for f in dataclasses.fields(node))
    if isinstance(node, (jbatch.ColType, ColType)):
        return ("type", node.kind.value, node.scale)
    if isinstance(node, (tuple, list)):
        return tuple(signature(x) for x in node)
    if isinstance(node, float) and np.isnan(node):
        return "nan"
    return node


def _shrinks(p):
    out = [p.start_capacity] if type(p).__name__ == "Shrink" else []
    for k in p.inputs():
        out += _shrinks(k)
    return out


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_normalize_matches_jax(catalogs, name):
    sf, jgen, tgen, jcat, tcat = catalogs
    jmake, tmake = QUERIES[name]
    want = jplan.normalize(jmake(jgen), jcat)
    got = tplan.normalize(tmake(tgen), tcat)
    assert signature(got) == signature(want)
    if sf == 1:
        assert _shrinks(got) == SF1_SHRINKS[name]


@pytest.mark.parametrize("table", ["lineitem", "orders", "part",
                                   "partsupp", "customer", "supplier",
                                   "nation"])
def test_table_stats_match_jax(catalogs, table):
    _sf, _jgen, _tgen, jcat, tcat = catalogs
    want, got = jcat.table_stats(table), tcat.table_stats(table)
    assert got.row_count == want.row_count
    assert {n: vars(c) for n, c in got.columns.items()} == \
        {n: vars(c) for n, c in want.columns.items()}


def _subplans(p):
    yield p
    for k in p.inputs():
        yield from _subplans(k)


@pytest.mark.parametrize("name", ["q3", "q9", "q12", "q18", "q2", "q5",
                                  "q16", "q17"])
def test_estimate_cardinality_matches_jax(catalogs, name):
    """Every subplan of the decorrelated, pushed-down plan gets the JAX
    package's estimate, exactly (the same float arithmetic in the same
    order)."""
    _sf, jgen, tgen, jcat, tcat = catalogs
    jmake, tmake = QUERIES[name]
    jp = jplan.push_filters(jplan.decorrelate(jmake(jgen), jcat), jcat)
    tp = tplan.push_filters(tplan.decorrelate(tmake(tgen), tcat), tcat)
    want = [jplan.estimate_cardinality(s, jcat) for s in _subplans(jp)]
    got = [tplan.estimate_cardinality(s, tcat) for s in _subplans(tp)]
    assert got == want


def test_selectivity_and_estimate_rows_match_jax():
    from cockroach_tpu.ops import expr as jx
    from cockroach_tpu.sql import stats as jstats
    from test_torch_expr_nodes import to_port

    jgen, tgen = jtpch.TPCH(sf=0.01), ttpch.TPCH(sf=0.01)
    jst = jplan.TPCHCatalog(jgen).table_stats("lineitem")
    tst = tplan.TPCHCatalog(tgen).table_stats("lineitem")
    c, lit = jx.Col, jx.Lit
    conjs = [jx.Cmp(op, c("l_shipdate"), lit(9000)) for op in
             ("==", "!=", "<", "<=", ">", ">=")]
    conjs += [jx.Cmp("<", lit(9000), c("l_shipdate")),
              jx.Cmp("<", c("l_shipdate"), c("l_commitdate")),
              jx.InList(c("l_shipmode"), ("MAIL", "SHIP")),
              jx.Like(c("l_comment"), "%x%"),
              jx.BoolOp("or", (conjs[0], conjs[2])),
              jx.BoolOp("and", (conjs[3], conjs[4])),
              jx.Cmp(">", c("l_quantity"), lit(10 ** 9))]
    for e in conjs:
        for st_j, st_t in ((jst, tst), (None, None)):
            assert (tstats.conjunct_selectivity(to_port(e), st_t)
                    == jstats.conjunct_selectivity(e, st_j))
    assert (tstats.estimate_rows(tst, 10, [to_port(e) for e in conjs[:4]])
            == jstats.estimate_rows(jst, 10, conjs[:4]))
    assert tstats.estimate_rows(None, 10, []) == 10.0


def _shrink_batch(n, live_frac, seed):
    rng = np.random.default_rng(seed)
    F = jbatch.Field
    js = jbatch.Schema([F("k", jbatch.INT), F("d", jbatch.DECIMAL(2)),
                        F("b", jbatch.BOOL)])
    sel = rng.random(n) < live_frac
    cols = {"k": jbatch.Column(jnp.asarray(rng.integers(-9, 1 << 40, n))),
            "d": jbatch.Column(jnp.asarray(rng.integers(-500, 500, n)),
                               jnp.asarray(rng.random(n) > 0.2)),
            "b": jbatch.Column(jnp.asarray(rng.random(n) > 0.5))}
    return jbatch.Batch(cols, jnp.asarray(sel),
                        jnp.int32(int(sel.sum()))), js


class _NoChild:
    schema = None


@pytest.mark.parametrize("n,live,cap", [(4096, 0.05, 256), (4096, 0.2, 256),
                                        (1000, 0.5, 4096), (512, 0.0, 64),
                                        (4096, 1.0, 4096)])
def test_shrink_matches_jax(n, live, cap):
    """The first `cap` selected rows, in order, padding masked; the
    overflow flag when more rows are selected than fit."""
    jb, _js = _shrink_batch(n, live, seed=n + cap)
    want, jflag = JShrinkOp(_NoChild(), cap).shrink_traceable(jb)
    got, tflag = ShrinkOp(_NoChild(), cap).shrink(port_batch(jb))
    assert bool(tflag) == bool(jflag)
    assert int(got.length) == int(want.length)
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    for name, jc in want.columns.items():
        tc = got.col(name)
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values), err_msg=name)
        np.testing.assert_array_equal(tc.valid_mask().numpy(),
                                      np.asarray(jc.valid_mask()),
                                      err_msg=name)


def test_shrink_widens_sixteenfold_and_walks():
    flow = tq.q9(ttpch.TPCH(sf=0.01), 1 << 14)
    shrinks = [op for op in walk_operators(flow) if isinstance(op, ShrinkOp)]
    assert len(shrinks) == 1
    s = shrinks[0]
    assert type(s.child).__name__ == "JoinOp" and s.child.how == "semi"
    start = s.capacity
    s.widen()
    assert s.capacity == start * ShrinkOp.GROWTH == start * 16


def test_build_refuses_string_computing_projection():
    """A projection that mints strings is not a device projection: build
    sends it to the row engine (exec/rowexec.py RowMapOp), as the JAX
    package's build does; a plain column stays a MapOp."""
    from cockroach_tpu_torch.ops.expr import Case, Col, Lit, StrFunc

    gen = ttpch.TPCH(sf=0.01)
    cat = tplan.TPCHCatalog(gen)
    scan = tplan.Scan("nation", ("n_nationkey", "n_name"))
    for e in (StrFunc("upper", (Col("n_name"),)),
              Case(((Lit(True), Col("n_name")),))):
        op = tplan.build(tplan.Project(scan, (("x", e),)), cat, 1 << 12)
        assert type(op).__name__ == "RowMapOp"
    op = tplan.build(tplan.Project(scan, (("x", Col("n_name")),)), cat,
                     1 << 12)
    assert type(op).__name__ == "MapOp"
