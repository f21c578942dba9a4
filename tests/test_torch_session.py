"""The port's read-only Session (cockroach_tpu_torch/sql/session.py), the
placement pass (sql/cost.py, sql/plan_compile.py), the row engine
(exec/rowexec.py) and the shell's helpers (cli.py) against the JAX
package's, at SF 0.01 on the CPU.

- Session over the TPC-H catalog: the ten SQL texts equal the port's
  run_sql (held to the JAX package's in tests/test_torch_sql.py) and
  their oracles; a second execute of a text is a prepared hit (no parse,
  `sql.prepared_hit`); SET and SHOW of every session variable; EXPLAIN
  lines equal the JAX package's render_plan; EXPLAIN ANALYZE runs;
  DDL/DML raise the JAX package's read-only message.
- Placement: the cost model with the JAX package's coefficients passed
  in equals the JAX package's; the tier table of compile_plan equals the
  JAX package's under a forced setting (gpu for tpu, cpu); the flow's
  estimates come from the card's coefficients (`CARD`) under every
  setting, `gpu` is `auto`'s alias, and a measured fingerprint shows its
  per-operator seconds while the flow stays on the device.
- The row engine: computed strings and exact decimal division
  (sql.tpu.exact_arithmetic on), NULLs included, equal the JAX row
  engine's bit for bit, minted dictionaries included, and the mixed tier
  (CompiledSubtreeOp under RowMapOp).
- The CLI: format_rows, split_statements and run_statement give the JAX
  CLI's lines for the same statements, apart from the `time:` line."""

import numpy as np
import pytest
import torch

from cockroach_tpu import cli as jcli
from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import cost as jcost
from cockroach_tpu.sql import plan_compile as jpc
from cockroach_tpu.sql.bind import plan_sql as jplan_sql
from cockroach_tpu.sql.explain import render_plan as jrender
from cockroach_tpu.sql.plan import normalize as jnormalize
from cockroach_tpu.sql.plan import run as jrun
from cockroach_tpu.util.settings import Settings as JSettings
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch import cli as tcli
from cockroach_tpu_torch.exec import stats as tstats
from cockroach_tpu_torch.exec.rowexec import RowMapOp
from cockroach_tpu_torch.sql import cost as tcost
from cockroach_tpu_torch.sql import parser as tparser
from cockroach_tpu_torch.sql import plan_compile as tpc
from cockroach_tpu_torch.sql.bind import BindError
from cockroach_tpu_torch.sql.bind import plan_sql as tplan_sql
from cockroach_tpu_torch.sql.bind import run_sql as trun_sql
from cockroach_tpu_torch.sql.plan import TPCHCatalog as TCatalog
from cockroach_tpu_torch.sql.plan import run as trun
from cockroach_tpu_torch.sql.session import Session
from cockroach_tpu_torch.sql.sqlstats import default_sqlstats, fingerprint
from cockroach_tpu_torch.util.settings import Settings as TSettings
from cockroach_tpu_torch.workload import tpch_queries as TQ
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH

from test_torch_sql import CAP, assert_same_result, check_oracle, sql_text
from torch_threads import one_torch_thread  # noqa: F401

READ_ONLY = ("this catalog is read-only (DDL/DML need a storage-backed "
             "session)")
# the JAX package's cost coefficients, for comparing the two models
JAX_COEFFS = tcost.Coefficients(jcost.DISPATCH_FLOOR_S,
                                jcost.TPU_ROWS_PER_S, jcost.HOST_ROWS_PER_S)


@pytest.fixture(scope="module")
def cats():
    return JCatalog(JTPCH(sf=0.01)), TCatalog(TTPCH(sf=0.01))


@pytest.fixture()
def session(cats):
    return Session(cats[1], capacity=CAP, device="cpu")


class _restore_settings:
    """Put back the values of the named settings in both packages."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = [(s, n, s().get(n)) for n in self.names
                      for s in (JSettings, TSettings)
                      if n in s._registry]
        return self

    def __exit__(self, *exc):
        for s, n, v in self.saved:
            s().set(n, v)


# ------------------------------------------------------------- session --

@pytest.mark.parametrize("q", sorted(TQ.SQL))
def test_session_select_and_prepared_hit(cats, session, q, monkeypatch):
    _jcat, tcat = cats
    kind, got, schema = session.execute(sql_text(q))
    assert kind == "rows" and schema is not None
    assert_same_result(got, trun_sql(sql_text(q), tcat, CAP, device="cpu"))
    check_oracle(q, got, tcat.gen)
    parses = []
    real_parse = tparser.parse
    monkeypatch.setattr(tparser, "parse",
                        lambda s: parses.append(s) or real_parse(s))
    st = tstats.enable()
    try:
        kind, again, _ = session.execute(sql_text(q))
    finally:
        tstats.disable()
    assert parses == []
    assert st.stages["sql.prepared_hit"].events == 1
    assert kind == "rows"
    assert_same_result(again, got)


def test_prepared_entry_revalidates_on_key_change(cats, session):
    sql = "select count(*) as n from nation"
    session.execute(sql)
    assert sql in session._prepared
    session._prepared[sql].vkeys["nation"] = ("stale",)
    st = tstats.enable()
    try:
        session.execute(sql)
    finally:
        tstats.disable()
    assert "sql.prepared_hit" not in st.stages
    assert session._prepared[sql].vkeys["nation"] != ("stale",)


def test_session_set_and_show_every_var(session):
    names = ("sql.tpu.exact_arithmetic", "sql.gpu.kernels",
             "sql.distsql.temp_storage.workmem")
    with _restore_settings(*names):
        for var, text, want in (("exact_arithmetic", "on", "True"),
                                ("exact_arithmetic", "off", "False"),
                                ("pallas", "'off'", "off"),
                                ("pallas", "'auto'", "auto"),
                                ("workmem", "1048576", "1048576"),
                                ("vectorize", "cpu", "cpu"),
                                ("vectorize", "gpu", "gpu"),
                                ("vectorize", "auto", "auto")):
            assert session.execute(f"set {var} = {text}") == (
                "ok", f"SET {var}", None)
            kind, payload, _ = session.execute(f"show {var}")
            assert kind == "rows" and payload[var].tolist() == [want]
    with pytest.raises(BindError, match="unknown session variable"):
        session.execute("set nope = 1")
    with pytest.raises(BindError, match="unknown session variable"):
        session.execute("show nope")
    with pytest.raises(BindError, match="vectorize must be one of"):
        session.execute("set vectorize = tpu")


def test_session_vectorize_cpu_places_the_flow_on_the_host(session):
    sql = "select count(*) as n from nation"
    session.execute("set vectorize = cpu")
    st = tstats.enable()
    try:
        _kind, res, _ = session.execute(sql)
    finally:
        tstats.disable()
    assert int(res["n"][0]) == 25
    assert st.stages["route.cpu"].events == 1
    kind, lines, _ = session.execute("explain " + sql)
    assert all("tier=host" in ln for ln in lines if "[tier=" in ln)
    assert lines[-1].startswith("engine: cpu")


@pytest.mark.parametrize("q", sorted(TQ.SQL))
def test_session_explain_lines_equal_render_plan(cats, session, q):
    jcat, _tcat = cats
    kind, lines, _ = session.execute("explain " + sql_text(q))
    assert kind == "explain"
    assert lines[-1].startswith("engine: gpu (")
    plan_lines = [ln.split("  [tier=")[0] for ln in lines[:-1]]
    want = jrender(jnormalize(jplan_sql(sql_text(q), jcat), jcat), jcat)
    assert plan_lines == want
    assert all("[tier=" in ln for ln in lines[:-1])


def test_session_explain_analyze(session):
    kind, lines, _ = session.execute("explain analyze " + sql_text(3))
    assert kind == "explain"
    text = "\n".join(lines)
    assert "execution:" in text and "10 result rows" in text
    assert "operators:" in text
    assert "tier=fused" in text


@pytest.mark.parametrize("stmt", [
    "create table t (a int primary key, b int)",
    "drop table t",
    "create index i on nation (n_regionkey)",
    "insert into nation values (1, 2)",
    "update nation set n_regionkey = 1 where n_nationkey = 0",
    "delete from nation where n_nationkey = 0",
    "analyze nation",
])
def test_session_rejects_ddl_and_dml(session, stmt):
    with pytest.raises(BindError) as e:
        session.execute(stmt)
    assert str(e.value) == READ_ONLY


def test_session_records_sqlstats(session):
    sql = "select n_name from nation where n_regionkey = 3"
    session.execute(sql)
    session.execute(sql)
    st = default_sqlstats().get(sql)
    assert st["fingerprint"] == fingerprint(sql)
    assert st["count"] >= 2 and st["rows_returned"] >= 10
    with pytest.raises(BindError):
        session.execute("select nope from nation")
    assert default_sqlstats().get("select nope from nation")["errors"] >= 1


def test_sqlstats_lru_cap_matches_jax():
    """The fingerprint map keeps the most recently recorded
    `sql.metrics.max_stmt_fingerprints` entries, in both packages; the
    port counts the evictions in exec/stats."""
    from cockroach_tpu.sql.sqlstats import SQLStats as JSQLStats
    from cockroach_tpu_torch.sql.sqlstats import SQLStats as TSQLStats

    sqls = ["select a from t", "select b from t where x = 1",
            "select a from t", "select c from u", "select d from v"]
    with _restore_settings("sql.metrics.max_stmt_fingerprints"):
        JSettings().set("sql.metrics.max_stmt_fingerprints", 2)
        TSettings().set("sql.metrics.max_stmt_fingerprints", 2)
        j, t = JSQLStats(), TSQLStats()
        st = tstats.enable()
        try:
            for i, sql in enumerate(sqls):
                j.record(sql, 0.001 * i, rows=i)
                t.record(sql, 0.001 * i, rows=i)
        finally:
            tstats.disable()
    assert t.top() == j.top()
    assert [s["fingerprint"] for s in t.top()] == \
        [fingerprint("select d from v"), fingerprint("select c from u")]
    assert st.stages["sqlstats.fingerprints_evicted"].rows == 2


def test_crdb_internal_names_wait_for_the_virtual_tables(session, cats):
    """crdb_internal names bind over the virtual tables (sql/vtable.py),
    as in the JAX package: `*` is the binder's own error in both, and
    named columns read back."""
    from cockroach_tpu.sql.explain import execute_with_plan as jexec

    for run in (session.execute,
                lambda sql: jexec(sql, cats[0], CAP)):
        with pytest.raises(Exception, match=r"unknown column '\*'"):
            run("select * from crdb_internal.statement_statistics")
    kind, res, _ = session.execute(
        "select fingerprint, exec_count from "
        "crdb_internal.statement_statistics")
    assert kind == "rows"
    assert [k for k in res if not k.endswith("__valid")] == \
        ["fingerprint", "exec_count"]


# ----------------------------------------------------------- placement --

def test_crossover_matches_jax_with_its_coefficients():
    assert tcost.crossover_rows(JAX_COEFFS) == jcost.crossover_rows()
    assert tcost.est_device_seconds(12345, JAX_COEFFS) == \
        jcost.est_tpu_seconds(12345)
    assert tcost.est_host_seconds(12345, JAX_COEFFS) == \
        jcost.est_host_seconds(12345)


def test_measured_fingerprint_shows_its_operator_seconds(cats):
    """A fingerprint sqlstats has measured shows its operators' measured
    seconds in the tier table; the flow stays on the caller's device and
    the whole tree stays fused, as under a cold fingerprint (the port
    has no CPU placement)."""
    _jcat, tcat = cats
    sql = "SELECT tier_migration_probe FROM lineitem"
    default_sqlstats().reset()
    try:
        cold = tpc.compile_plan(TQ.q6_plan(), tcat, CAP, sql=sql)
        assert {oc.source for oc in cold.placement.ops} == {"static"}
        for _ in range(3):
            default_sqlstats().record(sql, 0.5, device_s=0.3,
                                      op_device={"agg": 0.3})
        warm = tpc.compile_plan(TQ.q6_plan(), tcat, CAP, sql=sql)
        assert warm.backend == cold.backend == "gpu"
        assert {oc.tier for oc in warm.placement.ops} == {"fused"}
        agg = [oc for oc in warm.placement.ops if oc.name == "aggregate"]
        assert agg and all(oc.source == "measured" for oc in agg)
        assert agg[0].device_s == pytest.approx(0.3)
        assert (warm.placement.est_device_s, warm.placement.est_host_s) == \
            (cold.placement.est_device_s, cold.placement.est_host_s)
    finally:
        default_sqlstats().reset()


TIER_SQL = [
    "select s_suppkey, upper(s_name) as u from supplier "
    "where s_suppkey > 10",
    "select n_name, max(n_name) over (partition by n_regionkey) as m "
    "from nation",
]


@pytest.mark.parametrize("sql", [sql_text(q) for q in sorted(TQ.SQL)]
                         + TIER_SQL,
                         ids=[f"q{q}" for q in sorted(TQ.SQL)]
                         + ["rowmap", "window"])
@pytest.mark.parametrize("setting", ["tpu", "cpu"])
def test_compile_plan_tiers_match_jax(cats, sql, setting):
    jcat, tcat = cats
    want = jpc.compile_plan(jplan_sql(sql, jcat), jcat, CAP,
                            setting=setting, record=False)
    got = tpc.compile_plan(tplan_sql(sql, tcat), tcat, CAP,
                           setting={"tpu": "gpu"}.get(setting, setting))
    assert [(o.name, o.detail, o.tier) for o in got.placement.ops] == \
        [(o.name, o.detail, o.tier) for o in want.placement.ops]
    assert [int(o.est_rows) for o in got.placement.ops] == \
        [int(o.est_rows) for o in want.placement.ops]


@pytest.mark.parametrize("sql", [sql_text(q) for q in sorted(TQ.SQL)]
                         + TIER_SQL,
                         ids=[f"q{q}" for q in sorted(TQ.SQL)]
                         + ["rowmap", "window"])
def test_flow_estimates_come_from_the_card(cats, sql):
    """Under every setting the flow's estimates are the card's
    coefficients applied to the scan rows the JAX package prices; `gpu`
    compiles as `auto` does; only `cpu` moves the flow."""
    jcat, tcat = cats
    want = jpc.compile_plan(jplan_sql(sql, jcat), jcat, CAP,
                            setting="tpu", record=False)
    tiers = {}
    for setting, backend, source in (("auto", "gpu", "device"),
                                      ("gpu", "gpu", "forced"),
                                      ("cpu", "cpu", "forced")):
        got = tpc.compile_plan(tplan_sql(sql, tcat), tcat, CAP,
                               setting=setting)
        pl = got.placement
        assert (got.backend, pl.backend, pl.source) == \
            (backend, backend, source)
        assert pl.est_scan_rows == want.placement.est_scan_rows
        assert pl.est_device_s == tcost.est_device_seconds(pl.est_scan_rows)
        assert pl.est_host_s == tcost.est_host_seconds(pl.est_scan_rows)
        tiers[setting] = [(o.name, o.tier) for o in pl.ops]
    assert tiers["gpu"] == tiers["auto"]
    assert {t for _n, t in tiers["cpu"]} == {"host"}


# ----------------------------------------------------------- row engine --

ROW_SQL = [
    # computed strings, a NULL-producing CASE over one
    "select n_nationkey, upper(n_name) as u, lower(n_name) as lo, "
    "substring(n_name, 2, 3) as sb, n_name || 'x' as cc, "
    "case when n_regionkey = 1 then upper(n_name) end as cu "
    "from nation where n_nationkey > 2",
    # exact decimal division: by a literal, and by a column (a zero
    # divisor is NULL)
    "select s_suppkey, s_acctbal / 3 as third, "
    "s_acctbal / s_nationkey as per from supplier where s_suppkey < 200",
]


@pytest.mark.parametrize("sql", ROW_SQL, ids=["strings", "decimals"])
def test_row_engine_matches_jax(cats, sql):
    jcat, tcat = cats
    with _restore_settings("sql.tpu.exact_arithmetic"):
        JSettings().set("sql.tpu.exact_arithmetic", True)
        TSettings().set("sql.tpu.exact_arithmetic", True)
        want, jschema = jrun(jplan_sql(sql, jcat), jcat, CAP,
                             with_schema=True)
        got, tschema = trun(tplan_sql(sql, tcat), tcat, CAP,
                            with_schema=True, device="cpu")
    assert_same_result(got, want)
    assert [(f.name, repr(f.type)) for f in tschema] == \
        [(f.name, repr(f.type)) for f in jschema]
    for f in jschema:
        if f.name not in ("n_nationkey", "s_suppkey"):
            jd, td = jschema.dictionary(f.name), tschema.dictionary(f.name)
            assert (jd is None) == (td is None), f.name
            if jd is not None:
                assert td.tolist() == jd.tolist(), f.name
    assert any(not np.asarray(v).all() for k, v in got.items()
               if k.endswith("__valid")), "no NULL exercised"


def test_mixed_tier_row_engine_over_a_fused_subtree(cats):
    _jcat, tcat = cats
    sql = TIER_SQL[0]
    compiled = tpc.compile_plan(tplan_sql(sql, tcat), tcat, CAP)
    root = compiled.op
    assert isinstance(root, RowMapOp)
    assert isinstance(root.child, tpc.CompiledSubtreeOp)
    assert [o.tier for o in compiled.placement.ops] == \
        ["host", "fused", "fused"]
    from cockroach_tpu_torch.exec import collect

    st = tstats.enable()
    try:
        got = collect(root, device="cpu")
    finally:
        tstats.disable()
    assert st.stages["fused.exec"].events == 1
    assert st.stages["host.rowmap"].rows == len(got["s_suppkey"])
    gen = tcat.gen
    s = gen.table("supplier")
    names = gen.schema("supplier").dicts["s_name"]
    keep = s["s_suppkey"] > 10
    minted = root.schema.dictionary("u")
    assert [str(minted[c]) for c in got["u"]] == \
        [str(names[c]).upper() for c in s["s_name"][keep]]


# ------------------------------------------------------------------ cli --

CLI_STATEMENTS = [
    "select n_name, n_regionkey from nation where n_regionkey = 0 "
    "order by n_name",
    "select count(*) as n, max(n_nationkey) as mx from nation",
    "select nope from nation",
    "selec broken",
    "select sum() over () from nation",
    "select min(n_name) over () as m from nation",
    sql_text(1),
    sql_text(14),
]


@pytest.mark.parametrize("sql", CLI_STATEMENTS,
                         ids=[f"s{i}" for i in range(len(CLI_STATEMENTS))])
def test_run_statement_lines_match_jax(cats, session, sql):
    jcat, tcat = cats
    want = [ln for ln in jcli.run_statement(sql, jcat, CAP)
            if not ln.startswith("time:")]
    got = [ln for ln in tcli.run_statement(sql, tcat, CAP, session)
           if not ln.startswith("time:")]
    assert got == want


def test_format_rows_and_split_statements_match_jax(cats):
    jcat, tcat = cats
    for schema_of in (jcat.gen.schema, tcat.gen.schema):
        assert schema_of("nation").dicts["n_name"].tolist() == \
            jcat.gen.schema("nation").dicts["n_name"].tolist()
    res = {"n_name": np.array([0, 1]),
           "n_name__valid": np.array([True, False]),
           "n_nationkey": np.array([0, 1]),
           "n_nationkey__valid": np.array([True, True]),
           "bal": np.array([-123456, 5]),
           "bal__valid": np.array([True, True]),
           "f": np.array([1.5, 2.25], np.float32),
           "f__valid": np.array([True, True])}
    for limit in (25, 1):
        assert tcli.format_rows(res, tcat.gen.schema("nation"), limit) == \
            jcli.format_rows(res, jcat.gen.schema("nation"), limit)
    assert tcli.decimal_text(-123456, 2) == jcli.decimal_text(-123456, 2)
    for buf in ("select 1; select 'a;b'; sel", "select ''';' from t;",
                ";;", "select 1"):
        assert tcli.split_statements(buf) == jcli.split_statements(buf)


def test_shell_runs_statements(cats, capsys):
    _jcat, tcat = cats
    tcli.shell(tcat, CAP, ["select count(*) as n from nation"],
               session=Session(tcat, CAP, device="cpu"))
    out = capsys.readouterr().out
    assert "25" in out and "(1 row)" in out


def test_sql_command_without_cuda_or_device_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcli.main(["sql", "--sf", "0.01", "-e", "select 1 from region"])
    out = capsys.readouterr().out
    assert "error: RuntimeError" in out and "CUDA" in out
