"""The port's lifecycle utility modules against the JAX package's, on the
CPU: util/metric.py, util/log.py, util/tracing.py, util/cancel.py,
util/admission.py, server/registry.py, sql/insights.py, the retry
classifier's cancellation verdict, the breakers' gauges and the
sqlstats eviction counter.

Each case drives both packages' objects through the same operations,
drawn from a seeded numpy generator, and compares what they expose:
Prometheus text, log JSON lines (timestamps aside), span trees (times
and ids aside), digests, queue grant orders, registry snapshots and
insight kinds."""

import json
import re
import threading
import time

import numpy as np
import pytest

from cockroach_tpu.server import registry as jreg
from cockroach_tpu.sql import insights as jins
from cockroach_tpu.util import admission as jadm
from cockroach_tpu.util import cancel as jcancel
from cockroach_tpu.util import log as jlog
from cockroach_tpu.util import metric as jmetric
from cockroach_tpu.util import tracing as jtr
from cockroach_tpu_torch.server import registry as treg
from cockroach_tpu_torch.sql import insights as tins
from cockroach_tpu_torch.util import admission as tadm
from cockroach_tpu_torch.util import cancel as tcancel
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util import fault as tfault
from cockroach_tpu_torch.util import log as tlog
from cockroach_tpu_torch.util import metric as tmetric
from cockroach_tpu_torch.util import retry as tretry
from cockroach_tpu_torch.util import tracing as ttr
from cockroach_tpu_torch.util.settings import Settings as TSettings
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    tfault.registry().disarm()
    tcircuit.reset_all()


# ------------------------------------------------------------- metrics --

def _drive_registry(mod, seed):
    rng = np.random.default_rng(seed)
    r = mod.Registry()
    c = r.counter("queries_total", "queries executed")
    g = r.gauge("hbm_resident_bytes", "resident bytes")
    h = r.histogram("query_seconds", "query wall time",
                    buckets=[0.001, 0.01, 0.1, 1.0])
    hd = r.histogram("default_buckets", "default buckets")
    fg = r.function_gauge("cache_entries", lambda: 7, "entries")
    for _ in range(200):
        op = int(rng.integers(0, 5))
        v = float(rng.choice([0.0005, 0.005, 0.05, 0.5, 5.0]))
        if op == 0:
            c.inc(int(rng.integers(1, 4)))
        elif op == 1:
            g.set(v)
        elif op == 2:
            g.inc(v)
        elif op == 3:
            h.observe(v)
        else:
            hd.observe(v)
    assert r.counter("queries_total") is c
    with pytest.raises(TypeError):
        r.gauge("queries_total")
    return r, h, fg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_equals_jax(seed):
    tr, th, tfg = _drive_registry(tmetric, seed)
    jr, jh, jfg = _drive_registry(jmetric, seed)
    assert tr.export_prometheus() == jr.export_prometheus()
    assert th.snapshot() == jh.snapshot()
    assert [n for n, _ in tr.metrics()] == [n for n, _ in jr.metrics()]
    assert tfg.value() == jfg.value() == 7.0


def test_histogram_snapshot_cumulative_buckets():
    for mod in (tmetric, jmetric):
        h = mod.Histogram("h_snap", "snap help", buckets=[1.0, 2.0])
        for v in (0.5, 1.5, 5.0):
            h.observe(v)
        assert h.snapshot() == {"count": 3, "sum": 7.0,
                                "mean": 7.0 / 3,
                                "buckets": {"1.0": 1, "2.0": 2,
                                            "+Inf": 3}}


# ----------------------------------------------------------------- log --

def _drive_log(mod):
    lg = mod.Logger()
    lg.set_severity("INFO")
    mem = mod.MemorySink()
    lg.add_sink(mod.Channel.SQL_EXEC, mem)
    lg.info(mod.Channel.SQL_EXEC, "ran query {} in {}ms",
            mod.Redactable("SELECT secret"), 42)
    lg.info(mod.Channel.OPS, "node started")     # another channel
    lg.dev("debug detail")                        # below the severity
    lg.warning(mod.Channel.SQL_EXEC, "marker {}",
               mod.Redactable("a" + chr(0x203A) + "b"))
    lg.structured(mod.Channel.SQL_EXEC, "WARNING", "slow_query",
                  sql=mod.Redactable("select 1"), latency_s=0.5, rows=3)
    return lg, mem


def _no_ts(lines: str):
    out = []
    for ln in lines.splitlines():
        d = json.loads(ln)
        d.pop("ts")
        out.append(d)
    return out


def test_log_channels_and_redaction_equal_jax():
    tl, tm = _drive_log(tlog)
    jl, jm = _drive_log(jlog)
    assert len(tm.entries) == 3
    for redacted in (False, True):
        assert _no_ts(tm.json_lines(redacted)) == \
            _no_ts(jm.json_lines(redacted))
    red = tlog.redact(tm.entries[0]["msg"])
    assert "SELECT secret" not in red and "42" in red
    assert "a" not in tlog.redact(tm.entries[1]["msg"]).split("marker")[1]
    assert [{k: v for k, v in e.items() if k != "ts"}
            for e in tl.recent()] == \
        [{k: v for k, v in e.items() if k != "ts"} for e in jl.recent()]


# ------------------------------------------------------------- tracing --

def _shape(d):
    """A span dict without its times and ids."""
    out = {"name": d["name"], "finished": d["finished"],
           "tags": d.get("tags", {}),
           "events": [(e["msg"], e.get("tags", {}))
                      for e in d.get("events", [])],
           "dropped": d.get("dropped_events", 0)}
    out["children"] = [_shape(c) for c in d.get("children", [])]
    return out


def _drive_trace(mod):
    tr = mod.Tracer()
    with tr.span("query", sql="select 1") as root:
        with tr.span("flow.fused"):
            tr.current().record("retry", name="scan.transfer",
                                backoff_s=0.01)
            tr.current().record("degrade", from_tier="fused",
                                to_tier="streaming")
        with tr.span("flow.streaming") as st:
            st.record("flow.restart", n=1)
            carrier = tr.carrier()
            assert carrier == {"trace_id": root.trace_id,
                               "span_id": st.span_id}
            box = []

            def remote():
                with tr.from_carrier(carrier, "scan.prefetch") as r:
                    r.record("chunk", rows=4)
                    box.append(r)

            t = threading.Thread(target=remote)
            t.start()
            t.join()
            assert box[0].trace_id == root.trace_id
            assert box[0].parent_id == st.span_id
            with tr.span("busy") as busy:
                for i in range(mod.MAX_EVENTS_PER_SPAN + 37):
                    busy.record("tick", i=i)
        root.tags["tier"] = "streaming"
        assert root.span_id in tr.inflight
    assert root.span_id not in tr.inflight
    return root


def test_span_tree_render_and_summarize_equal_jax():
    troot, jroot = _drive_trace(ttr), _drive_trace(jtr)
    assert _shape(troot.as_dict()) == _shape(jroot.as_dict())
    strip = re.compile(r"\d+\.\d+ms")
    assert strip.sub("T", troot.render()) == strip.sub("T", jroot.render())
    assert "(+37 events dropped)" in troot.render()
    ts, js = ttr.summarize(troot), jtr.summarize(jroot)
    for d in (ts, js):
        d.pop("duration_ms")
        d["stages"] = sorted(d["stages"])
    assert ts == js
    assert ts["tier"] == "streaming" and ts["retries"] == 1
    assert ts["degradations"] == 1 and ts["restarts"] == 1
    assert ts["dropped_events"] == 37
    assert ttr.summarize(None) is None


def test_child_span_noop_and_query_span_setting():
    with ttr.child_span("orphan") as s:
        assert s is None
    ttr.record("nobody listens")
    st = TSettings()
    prev = st.get(ttr.TRACE_ENABLED)
    try:
        st.set(ttr.TRACE_ENABLED, False)
        with ttr.query_span("q") as s:
            assert s is None
        st.set(ttr.TRACE_ENABLED, True)
        with ttr.query_span("q") as root:
            with ttr.child_span("kid", rows=3) as kid:
                assert kid is not None
            ttr.tag_root(tier="fused")
        assert [c.name for c in root.children] == ["kid"]
        assert root.children[0].tags == {"rows": 3}
        assert root.tags["tier"] == "fused"
        assert ttr.TRACE_ENABLED == jtr.TRACE_ENABLED
    finally:
        st.set(ttr.TRACE_ENABLED, prev)


# -------------------------------------------------------------- cancel --

@pytest.mark.parametrize("mod", [tcancel, jcancel], ids=["port", "jax"])
def test_cancel_context_and_active_nesting(mod):
    ctx = mod.CancelContext()
    assert not ctx.cancelled() and ctx.deadline is None
    ctx.checkpoint()
    ctx.cancel("first")
    ctx.cancel("second")  # idempotent: the first reason stays
    with pytest.raises(mod.QueryCancelled, match="first"):
        ctx.checkpoint()
    dl = mod.CancelContext(timeout=0.01)
    time.sleep(0.03)
    with pytest.raises(mod.QueryCancelled,
                       match="statement timeout reached"):
        dl.checkpoint()
    assert mod.QueryCancelled.pgcode == "57014"
    outer, inner = mod.CancelContext(), mod.CancelContext()
    mod.checkpoint()  # nothing active: a no-op
    with mod.active(outer):
        with mod.active(inner):
            assert mod.current() is inner
            inner.cancel()
            with pytest.raises(mod.QueryCancelled):
                mod.checkpoint()
        assert mod.current() is outer
        mod.checkpoint()
    assert mod.current() is None
    # another thread sees no active context
    seen = []
    with mod.active(inner):
        t = threading.Thread(target=lambda: seen.append(mod.current()))
        t.start()
        t.join()
    assert seen == [None]


def test_query_cancelled_is_terminal_before_tokens():
    e = tcancel.QueryCancelled("statement timeout reached")
    assert tretry.classify(e) == tretry.TERMINAL
    # the message alone would read as transient
    assert tretry.classify(RuntimeError("DEADLINE_EXCEEDED")) == \
        tretry.RETRYABLE
    # with_retry polls the cancel context before each backoff sleep
    ctx = tcancel.CancelContext()
    calls = []

    def fn():
        calls.append(1)
        ctx.cancel()
        raise ConnectionError("transfer failed")

    with tcancel.active(ctx):
        with pytest.raises(tcancel.QueryCancelled):
            tretry.with_retry(fn, tretry.Options(sleep=lambda s: None))
    assert len(calls) == 1


def test_retry_counters_and_breaker_gauges():
    reg = tmetric.default_registry()
    ctr = reg.counter("sql_resilience_retries_total")
    before = ctr.value()
    n = []

    def flaky():
        n.append(1)
        if len(n) < 3:
            raise ConnectionError("transfer failed")
        return 5

    assert tretry.with_retry(flaky, tretry.Options(
        sleep=lambda s: None)) == 5
    assert ctr.value() - before == 2
    clock = [0.0]
    br = tcircuit.CircuitBreaker("flow.probe", threshold=2,
                                 cooldown_s=5.0, clock=lambda: clock[0])
    gauge = reg.gauge("sql_resilience_breaker_state_flow_probe")
    trips = reg.counter("sql_resilience_breaker_trips_total")
    t0 = trips.value()
    assert gauge.value() == 0
    br.failure()
    br.failure()
    assert br.state() == tcircuit.OPEN and gauge.value() == 2
    assert trips.value() - t0 == 1
    clock[0] = 6.0
    assert br.state() == tcircuit.HALF_OPEN and gauge.value() == 1
    assert br.allow() and not br.allow()
    br.success()
    assert gauge.value() == 0


# ----------------------------------------------------------- admission --

def _grant_order(mod, prios):
    q = mod.WorkQueue(1, name=f"order_{mod.__name__.split('.')[0]}")
    order = []
    started = []
    with q.admit():
        def worker(i, prio):
            with q.admit(priority=prio, timeout=30):
                order.append(i)

        for i, p in enumerate(prios):
            t = threading.Thread(target=worker, args=(i, p))
            t.start()
            started.append(t)
            deadline = time.monotonic() + 10
            while q.waiting.value() < i + 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.002)
    for t in started:
        t.join(30)
    assert q.used.value() == 0 and q.waiting.value() == 0
    return order


def test_workqueue_priority_order_equals_jax():
    prios = [int(p) for p in np.random.default_rng(7).integers(0, 3, 7)]
    assert _grant_order(tadm, prios) == _grant_order(jadm, prios)


@pytest.mark.parametrize("mod", [tadm, jadm], ids=["port", "jax"])
def test_workqueue_timeout_sheds_and_counts(mod):
    reg = (tmetric if mod is tadm else jmetric).default_registry()
    q = mod.WorkQueue(1, name="shed_probe")
    cnt = reg.counter("admission.timeouts_total")
    before = cnt.value()
    with q.admit():
        with pytest.raises(TimeoutError):
            with q.admit(timeout=0.01):
                pass
    assert cnt.value() - before == 1
    assert q.used.value() == 0 and q.waiting.value() == 0
    assert "admission.timeouts_total" in reg.export_prometheus()


def test_workqueue_cancel_while_queued():
    q = tadm.WorkQueue(1, name="cancel_probe")
    ctx = tcancel.CancelContext(timeout=0.05)
    with q.admit():
        with tcancel.active(ctx):
            with pytest.raises(tcancel.QueryCancelled):
                q.acquire(timeout=10)
    assert q.waiting.value() == 0 and q.used.value() == 0


def test_flow_queue_swap_retires_and_reuses_gauges():
    s = TSettings()
    prev = s.get(tadm.ADMISSION_SLOTS)
    try:
        s.set(tadm.ADMISSION_SLOTS, 0)
        assert tadm.flow_queue() is None
        s.set(tadm.ADMISSION_SLOTS, 2)
        q1 = tadm.flow_queue()
        s.set(tadm.ADMISSION_SLOTS, 3)
        q2 = tadm.flow_queue()
        assert q1 is not q2
        assert q1.used is q2.used and q1.waiting is q2.waiting
        reg = tmetric.default_registry()
        q2.acquire()
        q1.release()  # a retired queue's release does not publish
        assert reg.gauge("flow.slots_used").value() == 1
        q2.release()
        assert reg.gauge("flow.slots_used").value() == 0
    finally:
        s.set(tadm.ADMISSION_SLOTS, prev)
    assert tadm.ADMISSION_SLOTS == jadm.ADMISSION_SLOTS
    assert tadm.SESSION_SLOTS == jadm.SESSION_SLOTS
    assert TSettings().get(tadm.SESSION_SLOTS) == 0


@pytest.mark.parametrize("kind", ["py", "native"])
def test_io_load_listener_over_port_engine(kind):
    """The listener reads the port's engine's run count as the JAX one
    reads a stats() dict: the same grants at the same run counts."""
    from cockroach_tpu_torch.storage.engine import NativeEngine, PyEngine
    from cockroach_tpu_torch.util.hlc import Timestamp

    eng = PyEngine() if kind == "py" else NativeEngine()
    for i in range(64):
        eng.put(b"k%03d" % i, Timestamp(100 + i, 0), b"v")
    runs = int(eng.stats()["runs"])

    class Fake:
        def __init__(self, n):
            self.n = n

        def stats(self):
            return {"runs": self.n}

    tl, jl = tadm.IOLoadListener(eng), jadm.IOLoadListener(Fake(runs))
    assert tl.tick() == jl.tick()
    base = int(TSettings().get(tadm.IO_TOKENS_PER_TICK))
    for n, want in ((8, base / 4), (30, base / 64), (0, base)):
        tf, jf = tadm.IOLoadListener(Fake(n)), jadm.IOLoadListener(Fake(n))
        assert tf.tick() == jf.tick() == want
    for _ in range(3 * base):
        tl.acquire(1)
    assert not tl.acquire(10 * base)
    tl.tick()
    assert tl.acquire(1)


# ---------------------------------------------------- registry/insights --

class _S:
    def __init__(self, sid):
        self.session_id = sid


def _drive_qreg(mod):
    reg = mod.QueryRegistry(node_id=3)
    a, b = _S(1), _S(2)
    reg.register_session(a)
    reg.register_session(b)
    e1 = reg.register(a, "select 1", phase=mod.PHASE_QUEUED, track=True)
    reg.set_phase_current(mod.PHASE_COMPILING)
    e2 = reg.register(b, "select * from t where x = 5", timeout=30.0)
    e2.phase = mod.PHASE_EXECUTING
    assert reg.current_query_id() == e1.query_id
    assert e1.query_id == (3 << 32) | 1
    assert reg.cancel(e2.query_id, reason="CANCEL QUERY")
    assert not reg.cancel(12345)
    exc = (tcancel if mod is treg else jcancel).QueryCancelled
    with pytest.raises(exc, match="CANCEL QUERY"):
        e2.checkpoint()
    q = [{k: v for k, v in r.items() if k not in ("start_unix",
                                                  "elapsed_s")}
         for r in reg.queries()]
    sess = [{k: v for k, v in r.items() if k != "start_unix"}
            for r in reg.sessions()]
    reg.deregister(b, e2)
    reg.deregister(a, e1, track=True)
    return q, sess, reg.query_count(), reg.current_query_id()


def test_query_registry_equals_jax():
    tq, ts, tn, tcur = _drive_qreg(treg)
    jq, js, jn, jcur = _drive_qreg(jreg)
    assert tq == jq and ts == js and (tn, tcur) == (jn, jcur) == (0, None)
    assert [r["phase"] for r in tq] == ["compiling", "executing"]
    assert tq[1]["fingerprint"] == "select * from t where x = _"


def test_insights_kinds_equal_jax():
    rng = np.random.default_rng(3)
    t, j = tins.InsightsRegistry(), jins.InsightsRegistry()
    fps = ["select a from t where b = 1", "select z from w",
           "select count(*) from t"]
    kinds_t, kinds_j = [], []
    for _ in range(120):
        sql = fps[int(rng.integers(0, 3))]
        x = float(rng.choice([0.001, 0.02, 0.02, 0.02, 1.0]))
        kw = dict(shed=bool(rng.random() < 0.05),
                  degraded=bool(rng.random() < 0.05))
        kw["error"] = kw["shed"]
        a, b = t.observe(sql, x, **kw), j.observe(sql, x, **kw)
        kinds_t.append(None if a is None else a.kinds)
        kinds_j.append(None if b is None else b.kinds)
    assert kinds_t == kinds_j
    assert any(k and "slow" in k for k in kinds_t)
    strip = [{k: v for k, v in r.items() if k != "at_unix"}
             for r in t.insights()]
    assert strip == [{k: v for k, v in r.items() if k != "at_unix"}
                     for r in j.insights()]
    b = t.baseline(fps[0])
    jb = j.baseline(fps[0])
    assert (b.count, b.mean, b.var) == (jb.count, jb.mean, jb.var)


def test_insights_ring_caps_and_errors_skip_baseline():
    reg = tins.InsightsRegistry()
    s = TSettings()
    prev = s.get(tins.INSIGHTS_CAPACITY)
    s.set(tins.INSIGHTS_CAPACITY, 4)
    try:
        for i in range(10):
            ins = reg.observe("q%d" % i, 0.0, shed=True, error=True)
            assert ins is not None and ins.kinds == ("shed",)
        assert len(reg.insights()) == 4
        b = reg.baseline("q0")
        assert b is not None and b.count == 0
    finally:
        s.set(tins.INSIGHTS_CAPACITY, prev)


def test_sqlstats_eviction_counter():
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.sql.sqlstats import (
        MAX_STMT_FINGERPRINTS, SQLStats, fingerprint,
    )

    st = SQLStats()
    ctr = tmetric.default_registry().counter(
        "sqlstats_fingerprints_evicted_total")
    before = ctr.value()
    s = TSettings()
    prev = s.get(MAX_STMT_FINGERPRINTS)
    s.set(MAX_STMT_FINGERPRINTS, 3)
    try:
        with stats.query_stats() as col:
            for i in range(6):
                st.record("select c%d from tbl%d" % (i, i), 0.001)
        assert len(st.top(100)) == 3
        assert ctr.value() - before == 3
        assert col.stages["sqlstats.fingerprints_evicted"].rows == 3
        fps = {t["fingerprint"] for t in st.top(100)}
        assert fingerprint("select c0 from tbl0") not in fps
    finally:
        s.set(MAX_STMT_FINGERPRINTS, prev)
