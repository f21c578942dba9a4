"""The port's SQL text front end (cockroach_tpu_torch/sql/parser.py,
sql/bind.py, sql/plan.py run) against the JAX package's.

- The texts: the port's `workload/tpch_queries.py` SQL holds the SQL of
  tests/test_sql.py and tests/test_sql_more.py letter for letter (read
  here with `ast`, not imported).
- The parser: every statement string of tests/test_sql.py,
  tests/test_sql_more.py and tests/test_window.py, and the fifteen texts,
  parse to equal trees (node type names and fields, recursively) or
  raise the same class with the same message.
- The binder: the bound plans of the ten texts, and of every statement
  string those files bind or run, equal the JAX package's in a
  structural dump, before and after `normalize`; a statement that fails
  to bind fails with the same class and message. The five standard TPC-H
  texts the JAX binder rejects (Q2, Q4, Q15, Q17, Q19) raise its class
  and message in the port.
- Execution: Q1, Q3, Q6, Q9 and Q14 through the port's
  `run_sql(..., device="cpu")` equal the JAX package's `run_sql` bit for
  bit on every int, decimal, date and dictionary-code column and on
  validity, float columns within rtol 1e-4 (the tolerance
  tests/test_sql.py holds Q1's averages to), and each equals its oracle
  in the port's workload/tpch_queries.py. Q5, Q10, Q12, Q16 and Q18 are
  in tests/test_torch_sql_tpch.py.

SF 0.01, capacity 2^14, as the JAX SQL tests run."""

import ast
import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import parse_sql as jparse
from cockroach_tpu.sql import plan_sql as jplan_sql
from cockroach_tpu.sql import run_sql as jrun_sql
from cockroach_tpu.sql.plan import normalize as jnormalize
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.sql import parse_sql as tparse
from cockroach_tpu_torch.sql import plan_sql as tplan_sql
from cockroach_tpu_torch.sql import run_sql as trun_sql
from cockroach_tpu_torch.sql.plan import TPCHCatalog as TCatalog
from cockroach_tpu_torch.sql.plan import normalize as tnormalize
from cockroach_tpu_torch.workload import tpch_queries as TQ
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH
from torch_threads import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
CAP = 1 << 14
FLOAT_RTOL = 1e-4
Q18_THRESHOLD = 150  # tests/test_sql.py's


@pytest.fixture(scope="module")
def cats():
    return JCatalog(JTPCH(sf=0.01)), TCatalog(TTPCH(sf=0.01))


# ------------------------------------------------------------- helpers ---

def dump(x):
    """A structural dump of an AST, a plan or an expression: type names
    and fields, recursively; enums by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, dump(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return tuple(dump(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, dump(v)) for k, v in x.items()))
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    return x


def outcome(fn, *args):
    """("ok", dump of the result) or (exception class name, message)."""
    try:
        return "ok", dump(fn(*args))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)


def _consts(tree):
    return {n.targets[0].id: n.value.value for n in tree.body
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and isinstance(n.value, ast.Constant)
            and isinstance(n.value.value, str)}


def jax_test_texts():
    """(module constants of tests/test_sql.py, the `sql` strings of
    tests/test_sql_more.py by test name), read with ast."""
    with open(os.path.join(TESTS, "test_sql.py")) as f:
        consts = _consts(ast.parse(f.read()))
    with open(os.path.join(TESTS, "test_sql_more.py")) as f:
        tree = ast.parse(f.read())
    more = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for st in node.body:
                if (isinstance(st, ast.Assign)
                        and getattr(st.targets[0], "id", None) == "sql"):
                    more[node.name] = st.value.value
    return consts, more


def statement_strings(kind):
    """Every string the JAX SQL and window tests hand to parse_sql
    ("parse") or to plan_sql/run_sql ("bind"): literals, module constants
    and Q18_SQL.format(threshold=...)."""
    funcs = {"parse": {"parse_sql"}, "bind": {"plan_sql", "run_sql"}}[kind]
    out = []
    for fname in ("test_sql.py", "test_sql_more.py", "test_window.py"):
        with open(os.path.join(TESTS, fname)) as f:
            tree = ast.parse(f.read())
        consts = _consts(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in funcs and node.args):
                continue
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.append(a.value)
            elif isinstance(a, ast.Name) and a.id in consts:
                out.append(consts[a.id])
            elif (isinstance(a, ast.Call)
                  and isinstance(a.func, ast.Attribute)
                  and isinstance(a.func.value, ast.Name)
                  and a.func.value.id in consts):
                out.append(consts[a.func.value.id].format(
                    threshold=Q18_THRESHOLD))
    return list(dict.fromkeys(out))


def sql_text(q):
    text = TQ.SQL[q]
    return text.format(threshold=Q18_THRESHOLD) if q == 18 else text


def assert_same_result(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# ---------------------------------------------------------- the texts ---

def test_sql_texts_are_the_jax_tests_copies():
    consts, more = jax_test_texts()
    assert TQ.SQL[1] == consts["Q1_SQL"]
    assert TQ.SQL[3] == consts["Q3_SQL"]
    assert TQ.SQL[6] == consts["Q6_SQL"]
    assert TQ.SQL[9] == consts["Q9_SQL"]
    assert TQ.SQL[18] == consts["Q18_SQL"]
    assert TQ.SQL[5] == more["test_tpch_q5_local_supplier_volume"]
    assert TQ.SQL[10] == more["test_tpch_q10_returned_items"]
    assert TQ.SQL[12] == more["test_tpch_q12_shipmode_case_aggregates"]
    assert TQ.SQL[14] == more[
        "test_tpch_q14_promo_effect_post_agg_expression"]
    assert sorted(TQ.SQL) == [1, 3, 5, 6, 9, 10, 12, 14, 16, 18]
    assert sorted(TQ.SQL_REJECTED) == [2, 4, 15, 17, 19]


# ----------------------------------------------------------- the parser --

PARSE_STRINGS = statement_strings("parse")
BIND_STRINGS = statement_strings("bind")


@pytest.mark.parametrize(
    "sql", PARSE_STRINGS + BIND_STRINGS,
    ids=[f"s{i}" for i in range(len(PARSE_STRINGS + BIND_STRINGS))])
def test_parse_equal_trees(sql):
    want = outcome(jparse, sql)
    got = outcome(tparse, sql)
    assert got == want


@pytest.mark.parametrize("q", sorted(TQ.SQL) + sorted(TQ.SQL_REJECTED))
def test_parse_tpch_texts_equal_trees(q):
    text = (sql_text(q) if q in TQ.SQL else TQ.SQL_REJECTED[q])
    assert outcome(tparse, text) == outcome(jparse, text)


def test_parse_errors_same_messages():
    """The parse-error cases of tests/test_sql.py fail in both packages
    with the same message."""
    for sql in ("select from t", "select a from t where",
                "select a from t extra_garbage !"):
        want = outcome(jparse, sql)
        assert want[0] == "ParseError"
        assert outcome(tparse, sql) == want


# ----------------------------------------------------------- the binder --

def _bound(plan_sql, normalize, cat, sql):
    p = plan_sql(sql, cat)
    return p, normalize(p, cat)


@pytest.mark.parametrize("q", sorted(TQ.SQL))
def test_bind_tpch_texts_equal_plans(cats, q):
    jcat, tcat = cats
    want = outcome(_bound, jplan_sql, jnormalize, jcat, sql_text(q))
    got = outcome(_bound, tplan_sql, tnormalize, tcat, sql_text(q))
    assert want[0] == "ok"
    assert got == want


@pytest.mark.parametrize("sql", BIND_STRINGS,
                         ids=[f"s{i}" for i in range(len(BIND_STRINGS))])
def test_bind_test_statements_equal_plans(cats, sql):
    """Every statement the JAX SQL and window tests bind or run binds to
    the same plan, before and after normalize, or fails with the same
    class and message (the bind-error cases of tests/test_sql.py)."""
    jcat, tcat = cats
    want = outcome(_bound, jplan_sql, jnormalize, jcat, sql)
    got = outcome(_bound, tplan_sql, tnormalize, tcat, sql)
    assert got == want


def test_bind_error_cases_raise_bind_error(cats):
    jcat, tcat = cats
    for sql in ("select nope from nation",
                "select n_name from nation where bogus.n_name = 'x'",
                "select n_name from nation, region"):
        want = outcome(jplan_sql, sql, jcat)
        assert want[0] == "BindError"
        assert outcome(tplan_sql, sql, tcat) == want


@pytest.mark.parametrize("q", sorted(TQ.SQL_REJECTED))
def test_rejected_texts_fail_as_in_jax(cats, q):
    jcat, tcat = cats
    text = TQ.SQL_REJECTED[q]
    want = outcome(jrun_sql, text, jcat, CAP)
    got = outcome(lambda s, c, k: trun_sql(s, c, k, device="cpu"), text,
                  tcat, CAP)
    assert want[0] in ("ParseError", "BindError")
    assert got == want


# ------------------------------------------------------------ execution --

def check_oracle(q, got, gen):
    """The result of SQL[q] against the port's oracle for q."""
    if q == 1:
        want = TQ.q1_oracle(gen)
        assert len(got["l_returnflag"]) == len(want)
        for i in range(len(got["l_returnflag"])):
            w = want[(int(got["l_returnflag"][i]),
                      int(got["l_linestatus"][i]))]
            for j, c in enumerate(("sum_qty", "sum_base_price",
                                   "sum_disc_price", "sum_charge")):
                assert int(got[c][i]) == w[j], c
            for j, c in enumerate(("avg_qty", "avg_price", "avg_disc")):
                np.testing.assert_allclose(got[c][i], w[4 + j], rtol=1e-3)
            assert int(got["count_order"][i]) == w[7]
    elif q == 3:
        rows = [(int(a), int(b), int(c)) for a, b, c in zip(
            got["l_orderkey"], got["revenue"], got["o_orderdate"])]
        assert rows == [r[:3] for r in TQ.q3_oracle(gen)]
    elif q == 6:
        assert int(got["revenue"][0]) == TQ.q6_oracle(gen)
    elif q == 9:
        names = gen.schema("nation").dicts["n_name"]
        rows = {(str(names[int(n)]), int(y)): int(v) for n, y, v in zip(
            got["nation"], got["o_year"], got["sum_profit"])}
        assert rows == TQ.q9_oracle(gen)
    elif q == 14:
        assert (int(got["promo"][0]), int(got["total"][0])) == \
            TQ.q14_oracle(gen)
    elif q == 5:
        rows = {int(n): int(r) for n, r in zip(got["n_name"],
                                               got["revenue"])}
        assert rows == TQ.q5_oracle(gen)
        revs = got["revenue"].tolist()
        assert revs == sorted(revs, reverse=True)
    elif q == 10:
        # ORDER BY revenue DESC alone: ties may order either way, so the
        # revenues are compared in order and each customer's row exactly
        want = {r[0]: r for r in TQ.q10_oracle(gen)}
        rows = [(int(a), int(b), int(c), int(d), int(e)) for a, b, c, d, e
                in zip(got["c_custkey"], got["c_name"], got["c_acctbal"],
                       got["n_name"], got["revenue"])]
        assert [r[4] for r in rows] == [r[4] for r in TQ.q10_oracle(gen)]
        assert all(want[r[0]] == r for r in rows)
    elif q == 12:
        rows = {int(m): (int(h), int(lo)) for m, h, lo in zip(
            got["l_shipmode"], got["high_line_count"],
            got["low_line_count"])}
        assert rows == TQ.q12_oracle(gen)
    elif q == 16:
        rows = {(int(b), int(t), int(z)): int(n) for b, t, z, n in zip(
            got["p_brand"], got["p_type"], got["p_size"],
            got["supplier_cnt"])}
        assert rows == TQ.q16_oracle(gen)
        cnts = got["supplier_cnt"].tolist()
        assert cnts == sorted(cnts, reverse=True)
    elif q == 18:
        rows = [tuple(int(x) for x in r) for r in zip(
            got["c_name"], got["c_custkey"], got["o_orderkey"],
            got["o_orderdate"], got["o_totalprice"], got["sum_qty"])]
        want = TQ.q18_oracle(gen, Q18_THRESHOLD)
        assert len(want) > 0 and rows == want
    else:
        raise KeyError(q)
    for k, v in got.items():
        if k.endswith("__valid"):
            assert np.asarray(v).all(), k


@pytest.mark.parametrize("q", [1, 3, 6, 9, 14])
def test_sql_run_matches_jax_and_oracle(cats, q):
    jcat, tcat = cats
    want = jrun_sql(sql_text(q), jcat, CAP)
    got = trun_sql(sql_text(q), tcat, CAP, device="cpu")
    assert_same_result(got, want)
    check_oracle(q, got, tcat.gen)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 6, 9, 14])
def test_sql_run_on_card(cats, q):
    """The same texts on a CUDA device equal the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _jcat, tcat = cats
    want = trun_sql(sql_text(q), tcat, CAP, device="cpu")
    got = trun_sql(sql_text(q), tcat, CAP, device="cuda")
    assert_same_result(got, want)
