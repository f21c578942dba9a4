"""The port's session lifecycle seams and EXPLAIN ANALYZE's trace against
the JAX package's, on the CPU (sql/session.py, sql/explain.py,
sql/vtable.py, server/registry.py, server/debugzip.py, util/admission.py,
sql/insights.py).

The cases of tests/test_concurrency.py (statement_timeout through an
armed `fused.exec`, its cluster default, a cancel from another thread,
the 53300 shed with the control heads exempt, the priority variable)
and the session cases of tests/test_observability.py (the slow-query
log, crdb_internal WHERE and LIMIT, SHOW and CANCEL of an unknown id,
the operator breakdown, sqlstats device time, insights, EXPLAIN
ANALYZE's span tree and digest, the statement bundle's members), each
over the 128-row table of tests/test_concurrency.py in both packages,
with the outcomes compared. The `cuda` twins run the cancel cases on a
card, where the warm statement is a CUDA graph replay."""

import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from cockroach_tpu.sql import session as jsession
from cockroach_tpu.sql import vtable as jvtable
from cockroach_tpu.storage.engine import PyEngine as JPyEngine
from cockroach_tpu.storage.mvcc import MVCCStore as JMVCCStore
from cockroach_tpu.util import fault as jfault
from cockroach_tpu.util.hlc import HLC as JHLC, ManualClock as JClock
from cockroach_tpu_torch.server.registry import default_query_registry
from cockroach_tpu_torch.sql import session as tsession
from cockroach_tpu_torch.sql import vtable as tvtable
from cockroach_tpu_torch.sql.insights import default_insights
from cockroach_tpu_torch.sql.sqlstats import default_sqlstats, fingerprint
from cockroach_tpu_torch.storage.engine import PyEngine as TPyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore as TMVCCStore
from cockroach_tpu_torch.util import admission as tadm
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util import fault as tfault
from cockroach_tpu_torch.util import log as tlog
from cockroach_tpu_torch.util import retry as tretry
from cockroach_tpu_torch.util.hlc import HLC as THLC, ManualClock as TClock
from cockroach_tpu_torch.util.metric import default_registry
from cockroach_tpu_torch.util.settings import Settings as TSettings
from torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 128
WARM_Q = "select pk, v from t where pk >= 0 and pk < 40 order by pk"


@pytest.fixture(autouse=True)
def _hygiene():
    s = TSettings()
    prev = s.get(tretry.RESILIENCE_INITIAL_BACKOFF)
    s.set(tretry.RESILIENCE_INITIAL_BACKOFF, 0.0)
    yield
    s.set(tretry.RESILIENCE_INITIAL_BACKOFF, prev)
    tfault.registry().disarm()
    tcircuit.reset_all()


def _port_session(device="cpu", rows=N_ROWS, capacity=256):
    store = TMVCCStore(engine=TPyEngine(), clock=THLC(TClock(1000)),
                       device=device)
    cat = tsession.SessionCatalog(store)
    s = tsession.Session(cat, capacity=capacity, device=device)
    s.execute("create table t (pk int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        "(%d, %d)" % (pk, 37 * pk % 1009) for pk in range(rows)))
    return s


def _jax_session(rows=N_ROWS, capacity=256):
    store = JMVCCStore(engine=JPyEngine(), clock=JHLC(JClock(1000)))
    s = jsession.Session(jsession.SessionCatalog(store), capacity=capacity)
    s.execute("create table t (pk int primary key, v int)")
    s.execute("insert into t values " + ", ".join(
        "(%d, %d)" % (pk, 37 * pk % 1009) for pk in range(rows)))
    return s


def _slow_retryable(delay=0.2):
    """A blocking retryable fault: each fire stalls the statement's
    thread, then classifies RETRYABLE, so the statement crosses a cancel
    checkpoint before every retry sleep."""

    def make():
        time.sleep(delay)
        return ConnectionError("transfer failed")

    return make


def _rows(payload):
    return [tuple(int(x) for x in r)
            for r in zip(payload["pk"], payload["v"])]


# ------------------------------------------------ deadlines + cancel --

def test_statement_timeout_57014_equal_jax():
    """The JAX session and the port's give 57014 for the same armed
    statement, and the same rows after it."""
    out = {}
    for name, make, reg in (("port", _port_session, tfault.registry()),
                            ("jax", _jax_session, jfault.registry())):
        sess = make()
        want = _rows(sess.execute(WARM_Q)[1])
        reg.arm("fused.exec", probability=1.0, make=_slow_retryable())
        try:
            sess.execute("set statement_timeout = 0.15")
            with pytest.raises(Exception) as ei:
                sess.execute(WARM_Q)
        finally:
            reg.disarm()
        sess.execute("set statement_timeout = 0")
        got = _rows(sess.execute(WARM_Q)[1])
        assert got == want
        out[name] = (ei.value.pgcode, got)
    assert out["port"] == out["jax"]
    assert out["port"][0] == "57014" and len(out["port"][1]) == 40


def test_statement_timeout_cluster_default_applies():
    s = TSettings()
    prev = s.get(tsession.STATEMENT_TIMEOUT)
    sess = _port_session()
    sess.execute(WARM_Q)
    tfault.registry().arm("fused.exec", probability=1.0,
                          make=_slow_retryable())
    try:
        s.set(tsession.STATEMENT_TIMEOUT, 0.15)
        _, payload, _ = sess.execute("show statement_timeout")
        assert payload["statement_timeout"][0] == "0.15"
        with pytest.raises(tsession.SQLError) as ei:
            sess.execute(WARM_Q)
        assert ei.value.pgcode == "57014"
    finally:
        tfault.registry().disarm()
        s.set(tsession.STATEMENT_TIMEOUT, prev)
    assert tsession.STATEMENT_TIMEOUT == jsession.STATEMENT_TIMEOUT


def _cancel_from_thread(sess, via_sql):
    errs = []
    started = threading.Event()

    def run():
        started.set()
        try:
            sess.execute(WARM_Q)
            errs.append(None)
        except tsession.SQLError as e:
            errs.append(e.pgcode)

    t = threading.Thread(target=run)
    t.start()
    assert started.wait(10)
    other = tsession.Session(sess.catalog, capacity=256,
                             device=sess.device)
    deadline = time.monotonic() + 10
    done = False
    while time.monotonic() < deadline and not done:
        if via_sql:
            _, q, _ = other.execute("show queries")
            ids = [int(i) for i, s, ph in zip(q["query_id"], q["sql"],
                                              q["phase"])
                   if s == WARM_Q and ph == "executing"]
            if ids:
                other.execute(f"cancel query {ids[0]}")
                done = True
        else:
            done = sess.cancel_query("test cancel")
        if not done:
            time.sleep(0.02)
    t.join(20)
    assert not t.is_alive()
    return errs


@pytest.mark.parametrize("via_sql", [False, True],
                         ids=["cancel_query", "CANCEL_QUERY"])
def test_cancel_from_other_thread(via_sql):
    sess = _port_session()
    want = _rows(sess.execute(WARM_Q)[1])
    degr = default_registry().counter("sql_resilience_degradations_total")
    before = degr.value()
    tfault.registry().arm("fused.exec", probability=1.0,
                          make=_slow_retryable())
    try:
        errs = _cancel_from_thread(sess, via_sql)
    finally:
        tfault.registry().disarm()
    assert errs == ["57014"]
    assert default_query_registry().query_count() == 0
    # a cancelled statement trips no breaker and steps no rung
    assert tcircuit.breaker("flow.fused")._failures == 0
    assert degr.value() == before
    assert _rows(sess.execute(WARM_Q)[1]) == want


def test_cancel_lands_in_prefetch_poll():
    """A cancel reaches a streaming flow whose consumer waits on a
    stalled prefetch producer: the consumer's 0.1 s poll checkpoints,
    the producer thread is stopped and joined, and nothing leaks."""
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.exec.spill import host_spill_monitor

    sess = _port_session()
    q = "select v, count(*) as n from t group by v order by v"
    want = sess.execute(q)[1]["n"].tolist()
    sess.execute("set statement_timeout = 0.2")
    # a cached image would skip the transfer, and with it the producer
    scan_image_cache().clear()
    # one stalled transfer: the deadline passes while the consumer waits
    tfault.registry().arm("scan.transfer", after=0,
                          make=_slow_retryable(0.5))
    base_threads = {t.ident for t in threading.enumerate()}
    try:
        with pytest.raises(tsession.SQLError) as ei:
            sess.execute(q + " limit 1000")
    finally:
        tfault.registry().disarm()
    assert ei.value.pgcode == "57014"
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and any(
            t.ident not in base_threads and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t.ident not in base_threads and t.is_alive()]
    assert host_spill_monitor().used == 0
    sess.execute("set statement_timeout = 0")
    assert sess.execute(q)[1]["n"].tolist() == want


# ------------------------------------------------- session admission --

def test_admission_shed_53300_and_control_statements_exempt():
    s = TSettings()
    prev = (s.get(tadm.SESSION_SLOTS), s.get(tadm.SESSION_QUEUE_TIMEOUT))
    s.set(tadm.SESSION_SLOTS, 1)
    s.set(tadm.SESSION_QUEUE_TIMEOUT, 0.05)
    default_insights().reset()
    try:
        sess = _port_session()
        q = tadm.session_queue()
        assert q is not None
        q.acquire()
        try:
            sess.execute("set statement_timeout = 0")
            sess.execute("show statement_timeout")
            sess.execute("show queries")
            with pytest.raises(tsession.SQLError) as ei:
                sess.execute(WARM_Q)
            assert ei.value.pgcode == "53300"
        finally:
            q.release()
        assert q.used.value() == 0 and q.waiting.value() == 0
        assert len(sess.execute(WARM_Q)[1]["pk"]) == 40
    finally:
        s.set(tadm.SESSION_SLOTS, prev[0])
        s.set(tadm.SESSION_QUEUE_TIMEOUT, prev[1])
    hits = [i for i in default_insights().insights()
            if i["fingerprint"] == fingerprint(WARM_Q)]
    assert hits and "shed" in hits[0]["kinds"]


def test_admission_priority_and_slots_vars():
    sess = _port_session(rows=4)
    jsess = _jax_session(rows=4)
    for value in ("low", "high", "normal"):
        for x in (sess, jsess):
            x.execute(f"set admission_priority = '{value}'")
        assert sess._admission_priority() == jsess._admission_priority()
    assert sess._admission_priority() == tadm.NORMAL
    s = TSettings()
    prev = s.get(tadm.ADMISSION_SLOTS)
    try:
        sess.execute("set admission_slots = 2")
        assert sess.execute("show admission_slots")[1][
            "admission_slots"][0] == "2"
        assert tadm.flow_queue().slots == 2
        assert len(sess.execute("select pk from t")[1]["pk"]) == 4
        assert tadm.flow_queue().used.value() == 0
    finally:
        s.set(tadm.ADMISSION_SLOTS, prev)
    assert set(tsession.Session._VARS) == set(jsession.Session._VARS)


# ------------------------------------------------ observability cases --

def test_slow_query_log_fires_above_threshold_only():
    sess = _port_session(rows=2)
    lg = tlog.get_logger()
    mem = tlog.MemorySink()
    lg.add_sink(tlog.Channel.SQL_EXEC, mem)
    s = TSettings()
    try:
        sess.execute("select pk from t")
        assert not [e for e in mem.entries
                    if e.get("event") == "slow_query"]
        s.set(tsession.SLOW_QUERY_LATENCY, 1e-9)
        sess.execute("select v from t")
    finally:
        s.set(tsession.SLOW_QUERY_LATENCY, 0.0)
        lg._sinks[tlog.Channel.SQL_EXEC].remove(mem)
    slow = [e for e in mem.entries if e.get("event") == "slow_query"]
    assert len(slow) == 1
    assert "select v from t" in slow[0]["sql"]
    assert "select v from t" not in tlog.redact(slow[0]["msg"])
    assert set(slow[0]) == {"ts", "channel", "severity", "event", "msg",
                            "sql", "latency_s", "rows", "error",
                            "session"}


def test_vtable_columns_equal_jax():
    assert list(tvtable.TABLES) == list(jvtable.TABLES)
    for name, (cols, _) in jvtable.TABLES.items():
        tcols = tvtable.TABLES[name][0]
        assert [(c, t.kind.name, n) for c, t, n in tcols] == \
            [(c, t.kind.name, n) for c, t, n in cols], name


def test_vtable_node_metrics_where_limit_and_count():
    sess = _port_session(rows=2)
    default_registry().counter("obs_vtable_probe_total",
                               "vtable test probe").inc(3)
    kind, res, schema = sess.execute(
        "select name, value from crdb_internal.node_metrics "
        "where name = 'obs_vtable_probe_total'")
    d = schema.dicts[schema.field("name").dict_ref]
    assert [str(d[int(c)]) for c in res["name"]] == [
        "obs_vtable_probe_total"]
    assert float(res["value"][0]) == 3.0
    _, res2, _ = sess.execute(
        "select name from crdb_internal.node_metrics limit 3")
    assert len(res2["name"]) == 3
    _, res3, _ = sess.execute(
        "select count(*) as n from crdb_internal.node_metrics")
    assert int(res3["n"][0]) >= 3
    # a virtual table is never prepared
    with sess._prepared_mu:
        assert not [k for k in sess._prepared if "crdb_internal" in k]
    with pytest.raises(Exception, match="item 8d"):
        sess.execute("select * from crdb_internal.serving_batches")
    _, rr, _ = sess.execute("select range_id from crdb_internal.ranges")
    assert len(rr["range_id"]) == 0


def test_vtable_cluster_queries_shows_self_and_registry_drains():
    sess = _port_session(rows=2)
    kind, res, schema = sess.execute(
        "select query_id, phase, sql from crdb_internal.cluster_queries")
    d = schema.dicts[schema.field("sql").dict_ref]
    texts = [str(d[int(c)]) for c in res["sql"]]
    assert any("cluster_queries" in t for t in texts)
    assert default_query_registry().query_count() == 0


def test_show_queries_sessions_jobs_and_cancel_unknown_id():
    sess = _port_session(rows=8)
    jsess = _jax_session(rows=8)
    for x in (sess, jsess):
        x.execute("create index t_v on t (v)")
    for stmt in ("show queries", "show sessions", "show jobs"):
        _, tp, _ = sess.execute(stmt)
        _, jp, _ = jsess.execute(stmt)
        assert list(tp) == list(jp), stmt
    _, tp, _ = sess.execute("show queries")
    assert list(tp["sql"]) == ["show queries"]
    assert list(tp["phase"]) == ["executing"]
    _, tp, _ = sess.execute("show sessions")
    assert sess.session_id in list(tp["session_id"])
    _, tp, _ = sess.execute("show jobs")
    _, jp, _ = jsess.execute("show jobs")
    assert list(tp["kind"]) == list(jp["kind"]) == ["index_backfill"]
    assert list(tp["state"]) == list(jp["state"]) == ["succeeded"]
    for x, err in ((sess, tsession.SQLError), (jsess, jsession.SQLError)):
        with pytest.raises(err) as ei:
            x.execute("cancel query 123456789")
        assert ei.value.pgcode == "42704"


def test_explain_analyze_operator_breakdown_and_sqlstats():
    sess = _port_session(rows=3)
    kind, lines, _ = sess.execute(
        "explain analyze select v from t where v > 1")
    text = "\n".join(lines)
    assert kind == "explain" and "operators:" in text
    op_lines = [ln for ln in lines if "device-ms" in ln]
    assert any(ln.strip().startswith("scan") for ln in op_lines)
    q = "select v from t where v >= 1"
    default_sqlstats().reset()
    sess.execute(q)
    hit = [s for s in default_sqlstats().top(1000)
           if s["fingerprint"] == fingerprint(q)]
    assert hit and hit[0]["device_seconds"] >= 0.0
    assert "bytes_scanned" in hit[0]
    _, st, _ = sess.execute(
        "select exec_count from crdb_internal.statement_statistics")
    assert int(np.sum(st["exec_count"])) >= 1


def test_insight_fires_on_injected_slow_execution():
    sess = _port_session(rows=2)
    q = "select v from t where v >= 1"
    sess.execute(q)
    ins = default_insights()
    ins.reset()
    for _ in range(6):
        ins.observe(q, 0.001)
    tfault.registry().arm("fused.exec", after=0,
                          make=_slow_retryable(0.25))
    try:
        sess.execute(q)  # one stalled fire, then the retry succeeds
    finally:
        tfault.registry().disarm()
    hits = [i for i in ins.insights()
            if i["fingerprint"] == fingerprint(q)]
    assert hits and "slow" in hits[-1]["kinds"]
    assert hits[-1]["elapsed_s"] >= 0.25
    _, rows, schema = sess.execute(
        "select kinds, elapsed_s from "
        "crdb_internal.cluster_execution_insights")
    d = schema.dicts[schema.field("kinds").dict_ref]
    assert "slow" in {str(d[int(c)]) for c in rows["kinds"]}


# -------------------------------------------------------- EXPLAIN trace --

Q3 = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as "
      "revenue, o_orderdate, o_shippriority from customer, orders, "
      "lineitem where c_mktsegment = 'BUILDING' and c_custkey = "
      "o_custkey and l_orderkey = o_orderkey and o_orderdate < date "
      "'1995-03-15' and l_shipdate > date '1995-03-15' group by "
      "l_orderkey, o_orderdate, o_shippriority order by revenue desc, "
      "o_orderdate limit 10")


@pytest.fixture(scope="module")
def tpch_cat():
    from cockroach_tpu_torch.sql.plan import TPCHCatalog
    from cockroach_tpu_torch.workload.tpch import TPCH

    return TPCHCatalog(TPCH(sf=0.01))


def test_explain_analyze_q3_span_tree_and_digest(tpch_cat):
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.sql.explain import execute

    scan_image_cache().clear()
    kind, lines = execute("explain analyze " + Q3, tpch_cat,
                          capacity=1 << 12, device="cpu")
    text = "\n".join(lines)
    assert kind == "explain"
    for part in ("query:", "flow.fused", "fused.prime", "scan.stack",
                 "fused.compile", "fused.exec", "scan.prefetch",
                 "resilience: tier=fused retries=0 degradations=0 "
                 "restarts="):
        assert part in text, part


def test_explain_analyze_trace_shows_retry_on_armed_fault(tpch_cat):
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
    from cockroach_tpu_torch.sql.explain import execute

    scan_image_cache().clear()
    tfault.registry().arm("scan.transfer", after=0)
    try:
        kind, lines = execute(
            "explain analyze select count(*) as n from lineitem",
            tpch_cat, capacity=1 << 12, device="cpu")
    finally:
        fired = tfault.registry().fires("scan.transfer")
        tfault.registry().disarm()
    assert fired == 1
    text = "\n".join(lines)
    assert "retry name=scan.transfer" in text
    assert "resilience: tier=fused retries=1 " in text


def test_statement_bundle_members_equal_jax():
    sess = _port_session(rows=4)
    jsess = _jax_session(rows=4)
    names = []
    for x in (sess, jsess):
        _, lines, _ = x.execute(
            "explain analyze (debug) select v from t where v > 1")
        assert lines[-1].startswith("statement bundle: ")
        path = lines[-1].split(": ", 1)[1]
        with zipfile.ZipFile(path) as zf:
            names.append(sorted(zf.namelist()))
            if x is sess:
                assert zf.read("stmt.sql").decode().startswith(
                    "explain analyze (debug)")
                assert b"resilience: tier=" in zf.read("plan.txt")
    assert names[0] == names[1] == sorted(
        ["stmt.sql", "plan.txt", "trace.json", "trace.txt",
         "operators.json", "digest.json"])
    assert default_registry().counter(
        "stmt_bundles_written_total").value() >= 1


# ------------------------------------------------------------ cuda twins --

@pytest.mark.cuda
@pytest.mark.parametrize("via_sql", [False, True],
                         ids=["cancel_query", "CANCEL_QUERY"])
def test_cancel_from_other_thread_on_card(via_sql):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the warm statement replays a "
                    "CUDA graph there)")
    sess = _port_session(device=None)
    want = _rows(sess.execute(WARM_Q)[1])
    _rows(sess.execute(WARM_Q)[1])  # a replay
    tfault.registry().arm("fused.exec", probability=1.0,
                          make=_slow_retryable())
    try:
        errs = _cancel_from_thread(sess, via_sql)
    finally:
        tfault.registry().disarm()
    assert errs == ["57014"]
    assert default_query_registry().query_count() == 0
    assert _rows(sess.execute(WARM_Q)[1]) == want


@pytest.mark.cuda
def test_statement_timeout_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the warm statement replays a "
                    "CUDA graph there)")
    sess = _port_session(device=None)
    want = _rows(sess.execute(WARM_Q)[1])
    tfault.registry().arm("fused.exec", probability=1.0,
                          make=_slow_retryable())
    try:
        sess.execute("set statement_timeout = 0.15")
        with pytest.raises(tsession.SQLError) as ei:
            sess.execute(WARM_Q)
    finally:
        tfault.registry().disarm()
    assert ei.value.pgcode == "57014"
    sess.execute("set statement_timeout = 0")
    assert _rows(sess.execute(WARM_Q)[1]) == want
