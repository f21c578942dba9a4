"""The port's changefeeds and materialized views against the JAX
package's.

Each case is one of tests/test_changefeed.py's, written once as a
scenario over a package namespace and run on both packages, one after
the other, under the same ManualClock schedule (HLC(ManualClock(1000))
per store): the envelope lines, resolved messages, job states and
checkpoints, view reads and fold/re-scan counters the scenario records
must be equal, not merely equivalent. Each scenario also makes the JAX
test's own assertions on each package. The port's sessions run on the
CPU (device="cpu"); their views' group states live there.

Not here: `test_pgwire_experimental_changefeed` (the pgwire server is
ROADMAP.md queue 1, item 8d) and `test_status_jobs_matview_block` (the
status server is item 8e). The metamorphic schedule builds its engines
directly (PyEngine, and the native engine where it builds) where the
JAX test goes through util/crash_harness.make_engine (item 8e). Two
cases hold the port alone to its departure: a poll or a refresh that
starts while a transaction applies its versions waits for the commit
(storage/mvcc.py `write_window`)."""

import json
import os
import random
import threading
import types

import numpy as np
import pytest

import cockroach_tpu.kv.rangefeed as j_rangefeed
import cockroach_tpu.server.jobs as j_jobs
import cockroach_tpu.sql.bind as j_bind
import cockroach_tpu.sql.changefeed as j_cf
import cockroach_tpu.sql.session as j_session
import cockroach_tpu.storage.engine as j_engine
import cockroach_tpu.storage.mvcc as j_mvcc
import cockroach_tpu.util.fault as j_fault
import cockroach_tpu.util.hlc as j_hlc
import cockroach_tpu.util.retry as j_retry
import cockroach_tpu.util.settings as j_settings
import cockroach_tpu_torch.kv.rangefeed as t_rangefeed
import cockroach_tpu_torch.server.jobs as t_jobs
import cockroach_tpu_torch.sql.bind as t_bind
import cockroach_tpu_torch.sql.changefeed as t_cf
import cockroach_tpu_torch.sql.session as t_session
import cockroach_tpu_torch.storage.engine as t_engine
import cockroach_tpu_torch.storage.mvcc as t_mvcc
import cockroach_tpu_torch.util.fault as t_fault
import cockroach_tpu_torch.util.hlc as t_hlc
import cockroach_tpu_torch.util.retry as t_retry
import cockroach_tpu_torch.util.settings as t_settings
from torch_threads import one_torch_thread  # noqa: F401


def _ns(name, rangefeed, jobs, bind, cf, session, engine, mvcc, fault,
        hlc, retry, settings, sess_kw):
    return types.SimpleNamespace(
        name=name, metrics=rangefeed._metrics, Registry=jobs.Registry,
        StaleLease=jobs.StaleLease, States=jobs.States,
        BindError=bind.BindError, cf=cf, Session=session.Session,
        SessionCatalog=session.SessionCatalog, PyEngine=engine.PyEngine,
        NativeEngine=engine.NativeEngine, native=engine._load,
        MVCCStore=mvcc.MVCCStore, fault=fault, HLC=hlc.HLC,
        ManualClock=hlc.ManualClock, Timestamp=hlc.Timestamp,
        backoff=retry.RESILIENCE_INITIAL_BACKOFF,
        Settings=settings.Settings, sess_kw=sess_kw)


JAX = _ns("jax", j_rangefeed, j_jobs, j_bind, j_cf, j_session, j_engine,
          j_mvcc, j_fault, j_hlc, j_retry, j_settings, {})
PORT = _ns("port", t_rangefeed, t_jobs, t_bind, t_cf, t_session, t_engine,
           t_mvcc, t_fault, t_hlc, t_retry, t_settings, {"device": "cpu"})

VIEW_SQL = ("select grp, count(*) as n, sum(v) as s, avg(v) as a "
            "from t group by grp")
T_DDL = "create table t (k int primary key, grp int not null, v int)"


def make_sess(pk, engine=None):
    store = pk.MVCCStore(engine=engine or pk.PyEngine(),
                         clock=pk.HLC(pk.ManualClock(1000)))
    cat = pk.SessionCatalog(store)
    return store, cat, pk.Session(cat, capacity=256, **pk.sess_kw)


def _cols(payload):
    return {c: np.asarray(v) for c, v in payload.items()}


def view_read(sess, view="mv"):
    _k, got, _s = sess.execute(f"select * from {view}")
    return _cols(got)


def view_matches_oracle(sess, view="mv", oracle_sql=VIEW_SQL):
    got = view_read(sess, view)
    _k, want, _s = sess.execute(oracle_sql + " order by grp")
    want = _cols(want)
    return all(np.array_equal(got[c], want[c]) for c in got)


def both(scenario, *args):
    """Run `scenario(pk, *args)` on the JAX package, then on the port,
    and hold the records each returns equal."""
    rec = {}
    for pk in (JAX, PORT):
        rec[pk.name] = scenario(pk, *args)
    _assert_equal(rec["jax"], rec["port"])
    return rec["port"]


def _assert_equal(a, b, path="record"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8) if a.dtype.kind == "f"
                              else a, b.view(np.uint8)
                              if b.dtype.kind == "f" else b), path
    else:
        assert a == b, (path, a, b)


def _zero_backoff(pk):
    pk.Settings().set(pk.backoff, 0.0)


# ------------------------------------------------------------ envelopes --

def _envelopes_and_resolved(pk):
    store, cat, sess = make_sess(pk)
    sess.execute("create table t (k int primary key, grp int not null, "
                 "v int, tag string)")
    sess.execute("insert into t values (1, 0, 10, 'a'), "
                 "(2, 1, 20, null)")
    sess.execute("delete from t where k = 1")
    emitted0 = pk.metrics.emitted.value()
    sink = pk.cf.MemorySink()
    stream = pk.cf.ChangefeedStream(store, cat.desc("t"), sink,
                                    options={"resolved": True})
    first = stream.poll()
    evs = sink.events()
    by_key = {}
    for e in evs:
        assert e["table"] == "t"
        by_key.setdefault(e["key"], []).append(e)
    assert [e["op"] for e in by_key[1]] == ["upsert", "delete"]
    assert by_key[1][0]["after"] == {"grp": 0, "v": 10, "tag": "a"}
    assert by_key[1][1]["after"] is None
    assert by_key[2][0]["after"] == {"grp": 1, "v": 20, "tag": None}
    assert by_key[1][0]["ts"] < by_key[1][1]["ts"]
    assert pk.metrics.emitted.value() - emitted0 == len(evs)
    assert sink.resolved()
    idle = stream.poll()
    assert idle == 0
    return {"lines": list(sink.lines), "first": first, "idle": idle,
            "frontier": [stream.frontier.wall, stream.frontier.logical]}


def test_envelopes_and_resolved():
    both(_envelopes_and_resolved)


def _sql_create_changefeed_memory_sink(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute("insert into t values (1, 0, 10), (2, 1, 20)")
    kind, payload, _s = sess.execute(
        "create changefeed for table t with sink = 'tcf-a', resolved, "
        "max_polls = 2")
    job_id = int(payload["job_id"][0])
    reg = sess._jobs_registry()
    rec = reg.get(job_id)
    assert rec.state == pk.States.SUCCEEDED
    lines = pk.cf.memory_sink("tcf-a").lines
    assert sorted(e["key"] for e in pk.cf.memory_sink("tcf-a").events()) \
        == [1, 2]
    prog = rec.progress
    assert pk.Timestamp(*prog["frontier"]) > pk.Timestamp()
    assert prog["emitted"] >= 2
    _k, rows, _s = sess.execute("show jobs")
    return {"kind": kind, "job_id": job_id, "state": rec.state,
            "lines": list(lines), "progress": dict(prog),
            "show_jobs_kinds": [str(x) for x in rows["kind"]]}


def test_sql_create_changefeed_memory_sink():
    both(_sql_create_changefeed_memory_sink)


# ------------------------------------------------- resume + exactly-once --

def _job_resume(pk, base):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute("insert into t values (1, 0, 10), (2, 1, 20)")
    feed_dir = os.path.join(base, pk.name, "feed")
    reg = pk.Registry(store)
    pk.cf.register(reg, cat)
    job_id = reg.create(pk.cf.CHANGEFEED_JOB, {
        "table": "t", "sink": {"kind": "file", "path": feed_dir},
        "options": {"resolved": True}, "once": True})
    reg.adopt_and_run()
    first = pk.cf.FileSink.read_lines(feed_dir)
    assert sorted(e["key"] for e in pk.cf.FileSink.read_events(feed_dir)) \
        == [1, 2]
    frontier1 = pk.Timestamp(*reg.get(job_id).progress["frontier"])
    # a crash: the record back to RUNNING with an expired lease
    sess.execute("upsert into t values (2, 1, 25)")
    sess.execute("insert into t values (3, 0, 30)")
    rec = reg.get(job_id)
    rec.state = pk.States.RUNNING
    rec.lease_exp = 0
    reg._save(rec)
    reg.adopt_and_run()
    assert reg.get(job_id).state == pk.States.SUCCEEDED
    events = pk.cf.FileSink.read_events(feed_dir)
    seen = set()
    for e in events:
        k = (e["key"], tuple(e["ts"]))
        assert k not in seen, f"duplicate emission {k}"
        seen.add(k)
    fresh = [e for e in events if pk.Timestamp(*e["ts"]) > frontier1]
    assert sorted(e["key"] for e in fresh) == [2, 3]
    final = pk.Timestamp(*reg.get(job_id).progress["frontier"])
    assert final > frontier1
    return {"first": first, "all": pk.cf.FileSink.read_lines(feed_dir),
            "segments": sorted(os.listdir(feed_dir)),
            "frontier1": [frontier1.wall, frontier1.logical],
            "final": [final.wall, final.logical]}


def test_job_resume_from_checkpoint_exactly_once(tmp_path):
    both(_job_resume, str(tmp_path))


def _cancel_fenced(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    reg = pk.Registry(store)
    job_id = reg.create(pk.cf.CHANGEFEED_JOB, {"table": "t"})
    rec = reg.get(job_id)
    sink = pk.cf.MemorySink()
    stream = pk.cf.ChangefeedStream(store, cat.desc("t"), sink,
                                    registry=reg, job_id=job_id,
                                    epoch=rec.lease_epoch)
    sess.execute("insert into t values (1, 0, 10)")
    stream.poll()
    sess.execute("cancel job %d" % job_id)
    assert reg.get(job_id).state == pk.States.CANCELLED
    sess.execute("insert into t values (2, 1, 20)")
    with pytest.raises(pk.StaleLease):
        stream.poll()
    return {"lines": list(sink.lines),
            "state": reg.get(job_id).state,
            "epoch": reg.get(job_id).lease_epoch}


def test_cancel_fenced_by_lease_epoch():
    both(_cancel_fenced)


def _pause_resume(pk):
    """PAUSE JOB and RESUME JOB through SQL (the job-control statements
    of both packages), then the job runs to its end."""
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute("insert into t values (1, 0, 10)")
    _k, payload, _s = sess.execute(
        "create changefeed for table t with sink = 'tcf-pr', once, "
        "run = false")
    job_id = int(payload["job_id"][0])
    reg = sess._jobs_registry()
    states = [reg.get(job_id).state]
    kinds = [sess.execute("pause job %d" % job_id)[1]]
    states.append(reg.get(job_id).state)
    reg.adopt_and_run()  # a paused job is not adopted
    states.append(reg.get(job_id).state)
    kinds.append(sess.execute("resume job %d" % job_id)[1])
    states.append(reg.get(job_id).state)
    reg.adopt_and_run()
    states.append(reg.get(job_id).state)
    assert states[-1] == pk.States.SUCCEEDED
    return {"states": states, "tags": kinds,
            "lines": list(pk.cf.memory_sink("tcf-pr").lines)}


def test_pause_resume_job():
    both(_pause_resume)


def _poll_write_race(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute("insert into t values (1, 0, 10)")
    sink = pk.cf.MemorySink()
    stream = pk.cf.ChangefeedStream(store, cat.desc("t"), sink)
    stream.poll()
    orig_sync = store.sync

    def racy_sync():
        orig_sync()
        store.sync = orig_sync  # fire once
        sess.execute("insert into t values (2, 1, 20)")

    store.sync = racy_sync
    stream.poll()
    stream.poll()
    assert sorted(e["key"] for e in sink.events()) == [1, 2]
    return {"lines": list(sink.lines)}


def test_poll_write_racing_sync_is_not_lost():
    both(_poll_write_race)


def _with_run(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    with pytest.raises(pk.BindError) as err:
        sess.execute(
            "create changefeed for table t with sink = 'tcf-run', run")
    _k, payload, _s = sess.execute(
        "create changefeed for table t with sink = 'tcf-run', run, once")
    reg = sess._jobs_registry()
    state = reg.get(int(payload["job_id"][0])).state
    assert state == pk.States.SUCCEEDED
    with pytest.raises(pk.BindError) as unknown:
        sess.execute("create changefeed for table t with bogus = 1")
    return {"err": str(err.value), "state": state,
            "unknown": str(unknown.value)}


def test_with_run_needs_stop_condition():
    both(_with_run)


# ----------------------------------------------------------------- sinks --

def _file_sink_orphans(pk, base):
    path = os.path.join(base, pk.name, "feed")
    T = pk.Timestamp
    sink = pk.cf.FileSink(path)
    sink.emit('{"key": 1}')
    sink.flush_segment(T(), T(10, 0))
    sink.emit('{"key": 2}')
    sink.flush_segment(T(10, 0), T(20, 0))
    before = pk.cf.FileSink.read_lines(path)
    assert [json.loads(ln)["key"] for ln in before] == [1, 2]
    sink.emit('{"key": 3}')
    sink.flush_segment(T(20, 0), T(30, 0))
    with open(os.path.join(path, "junk.tmp"), "w") as f:
        f.write("torn")
    pk.cf.FileSink(path, resume_frontier=T(10, 0))
    after = pk.cf.FileSink.read_lines(path)
    assert [json.loads(ln)["key"] for ln in after] == [1]
    assert not any(n.endswith(".tmp") for n in os.listdir(path))
    return {"before": before, "after": after,
            "files": sorted(os.listdir(path))}


def test_file_sink_orphan_cleanup(tmp_path):
    both(_file_sink_orphans, str(tmp_path))


# ---------------------------------------------------- prune_seen bound --

def _prune_seen(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    stream = pk.cf.ChangefeedStream(store, cat.desc("t"),
                                    pk.cf.MemorySink())
    emitted, per_poll = 0, []
    burst = 20
    for i in range(15):
        for j in range(burst):
            sess.execute("upsert into t values (%d, 0, %d)"
                         % (j, i * burst + j))
        n = stream.poll()
        per_poll.append(n)
        emitted += n
    assert emitted == 15 * burst
    assert stream.feed.seen_size() == 0
    return {"per_poll": per_poll, "seen": stream.feed.seen_size(),
            "lines": list(stream.sink.lines),
            "frontier": [stream.frontier.wall, stream.frontier.logical]}


def test_prune_seen_memory_bounded():
    both(_prune_seen)


# ------------------------------------------------------------- matviews --

def _fold_counters(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute(f"create materialized view mv as {VIEW_SQL}")
    mgr = sess._matviews()
    reads, reps = [], []
    sess.execute("insert into t values (1, 0, 10), (2, 1, 20), "
                 "(3, 0, 30)")
    sess.execute("refresh materialized view mv")
    r0 = mgr.report()["mv"]["rescans"]
    assert view_matches_oracle(sess)
    reads.append(view_read(sess))
    reps.append(mgr.report())
    sess.execute("insert into t values (4, 2, 40), (5, 1, 50)")
    sess.execute("refresh materialized view mv")
    rep = mgr.report()["mv"]
    assert rep["folds"] >= 1 and rep["rescans"] == r0
    assert view_matches_oracle(sess)
    reads.append(view_read(sess))
    reps.append(mgr.report())
    sess.execute("upsert into t values (1, 2, 11)")
    sess.execute("delete from t where k = 2")
    sess.execute("refresh materialized view mv")
    assert view_matches_oracle(sess)
    reads.append(view_read(sess))
    reps.append(mgr.report())
    _k, jobs, _s = sess.execute(
        "select kind, folds, rescans from crdb_internal.jobs")
    return {"reads": reads, "reports": reps, "jobs": _cols(jobs)}


def test_matview_fold_bit_exact_counters():
    both(_fold_counters)


def _minmax_rescan(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sql = ("select grp, min(v) as lo, max(v) as hi from t group by grp")
    sess.execute(f"create materialized view mv as {sql}")
    sess.execute("insert into t values (1, 0, 10), (2, 0, 99)")
    sess.execute("refresh materialized view mv")
    mgr = sess._matviews()
    r0 = mgr.report()["mv"]["rescans"]
    first = view_read(sess)
    sess.execute("delete from t where k = 2")
    sess.execute("refresh materialized view mv")
    assert mgr.report()["mv"]["rescans"] > r0
    assert view_matches_oracle(sess, oracle_sql=sql)
    return {"reads": [first, view_read(sess)], "report": mgr.report()}


def test_matview_minmax_retraction_rescans():
    both(_minmax_rescan)


def _racing_refresh(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute(f"create materialized view mv as {VIEW_SQL}")
    sess.execute("insert into t values (1, 0, 10), (2, 1, 20)")
    sess.execute("refresh materialized view mv")
    orig_sync = store.sync

    def racy_sync():
        orig_sync()
        store.sync = orig_sync  # fire once
        sess.execute("upsert into t values (9, 3, 90)")

    store.sync = racy_sync
    sess.execute("refresh materialized view mv")
    sess.execute("refresh materialized view mv")
    assert view_matches_oracle(sess)
    mid = view_read(sess)
    sess.execute("upsert into t values (9, 3, 91)")
    sess.execute("refresh materialized view mv")
    assert view_matches_oracle(sess)
    return {"reads": [mid, view_read(sess)],
            "report": sess._matviews().report()}


def test_matview_write_racing_refresh_converges():
    both(_racing_refresh)


def _fractional_literal(pk):
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    with pytest.raises(pk.BindError) as err:
        sess.execute("create materialized view bad as select grp, "
                     "count(*) as n from t where v = 1.5 group by grp")
    sess.execute("create materialized view ok as select grp, "
                 "count(*) as n from t where v = 1.0 group by grp")
    sess.execute("insert into t values (1, 0, 1), (2, 0, 2)")
    sess.execute("refresh materialized view ok")
    assert view_matches_oracle(
        sess, view="ok", oracle_sql="select grp, count(*) as n from t "
        "where v = 1 group by grp")
    return {"err": str(err.value), "read": view_read(sess, "ok")}


def test_matview_where_fractional_int_literal_rejected():
    both(_fractional_literal)


def _restart(pk):
    eng = pk.PyEngine()
    store, cat, sess = make_sess(pk, eng)
    sess.execute(T_DDL)
    sess.execute(f"create materialized view mv as {VIEW_SQL}")
    sess.execute("insert into t values (1, 0, 10)")
    store.sync()
    store2 = pk.MVCCStore(engine=eng, clock=pk.HLC(pk.ManualClock(2000)))
    sess2 = pk.Session(pk.SessionCatalog(store2), capacity=256,
                       **pk.sess_kw)
    assert view_matches_oracle(sess2)
    sess2.execute("drop materialized view mv")
    with pytest.raises(pk.BindError):
        sess2.execute("refresh materialized view mv")
    return {"read": view_read(sess), "report": sess._matviews().report()}


def test_matview_survives_restart():
    both(_restart)


# ------------------------------------------------------------ seam chaos --

def _seam_faults(pk):
    _zero_backoff(pk)
    store, cat, sess = make_sess(pk)
    sess.execute(T_DDL)
    sess.execute(f"create materialized view mv as {VIEW_SQL}")
    sink = pk.cf.MemorySink()
    stream = pk.cf.ChangefeedStream(store, cat.desc("t"), sink)
    reg = pk.fault.registry()
    reg.set_seed(7)
    reg.arm("changefeed.emit", probability=0.4)
    reg.arm("view.fold", probability=0.4)
    try:
        for i in range(6):
            sess.execute("insert into t values (%d, %d, %d)"
                         % (i, i % 3, i * 10))
            stream.poll()
            sess.execute("refresh materialized view mv")
        fires = (reg.fires("changefeed.emit"), reg.fires("view.fold"))
    finally:
        reg.disarm("changefeed.emit")
        reg.disarm("view.fold")
    assert sorted(e["key"] for e in sink.events()) == list(range(6))
    assert view_matches_oracle(sess)
    return {"lines": list(sink.lines), "read": view_read(sess),
            "report": sess._matviews().report(), "fires": fires}


def test_seam_faults_still_exact():
    both(_seam_faults)


# ---------------------------------------------------- metamorphic schedule --

def _make_engine(pk, kind, path):
    os.makedirs(path, exist_ok=True)
    if kind == "native":
        return pk.NativeEngine(path=path)
    return pk.PyEngine(path=path)


def _metamorphic(pk, kind, base):
    _zero_backoff(pk)
    eng = _make_engine(pk, kind, os.path.join(base, pk.name, "eng"))
    reads = []
    try:
        store = pk.MVCCStore(engine=eng, clock=pk.HLC(pk.ManualClock(1000)))
        cat = pk.SessionCatalog(store)
        sess = pk.Session(cat, capacity=256, **pk.sess_kw)
        sess.execute(T_DDL)
        sess.execute(f"create materialized view mv as {VIEW_SQL}")
        sink = pk.cf.MemorySink()
        stream = pk.cf.ChangefeedStream(store, cat.desc("t"), sink)
        rng = random.Random(20260805 if kind == "py" else 20260806)
        reg = pk.fault.registry()
        reg.set_seed(11)
        reg.arm("changefeed.emit", probability=0.2)
        reg.arm("view.fold", probability=0.2)
        try:
            for horizon in range(8):
                for _ in range(15):
                    key = rng.randrange(30)
                    r = rng.random()
                    if r < 0.2:
                        sess.execute("delete from t where k = %d" % key)
                    elif r < 0.5:
                        sess.execute(
                            "upsert into t values (%d, %d, %d)"
                            % (key, rng.randrange(4), rng.randrange(100)))
                    else:
                        sess.execute(
                            "upsert into t values (%d, %d, %d)"
                            % (key + 100, rng.randrange(4),
                               rng.randrange(100)))
                stream.poll()
                sess.execute("refresh materialized view mv")
                assert view_matches_oracle(sess), \
                    f"horizon {horizon} diverged from the oracle"
                reads.append(view_read(sess))
        finally:
            reg.disarm("changefeed.emit")
            reg.disarm("view.fold")
        stream.poll()
        seen, state = set(), {}
        for e in sorted(sink.events(), key=lambda e: tuple(e["ts"])):
            k = (e["key"], tuple(e["ts"]))
            assert k not in seen, f"duplicate emission {k}"
            seen.add(k)
            if e["op"] == "delete":
                state.pop(e["key"], None)
            else:
                state[e["key"]] = (e["after"]["grp"], e["after"]["v"])
        _k, rows, _s = sess.execute("select k, grp, v from t")
        table = {int(k): (int(g), int(v)) for k, g, v in zip(
            np.asarray(rows["k"]), np.asarray(rows["grp"]),
            np.asarray(rows["v"]))}
        assert state == table
        return {"reads": reads, "lines": list(sink.lines),
                "report": sess._matviews().report()}
    finally:
        eng.close()


ENGINES = ["py"] + (["native"] if j_engine._load() is not None
                    and t_engine._load() is not None else [])


@pytest.mark.parametrize("engine", ENGINES)
def test_metamorphic_schedule_view_bit_exact(engine, tmp_path):
    both(_metamorphic, engine, str(tmp_path))


# ------------------------------------- the port's write window (departure) --

def _commit_with_a_racing_reader(store, read):
    """Run `read` on another thread right after the first version of a
    three-row INSERT reaches the engine, while the commit still holds
    the store's write window; return the reader's thread."""
    eng = store.engine
    orig_put = eng.put
    started = []

    def put(key, ts, value):
        orig_put(key, ts, value)
        if not started:
            go = threading.Event()

            def run():
                go.set()
                read()

            th = threading.Thread(target=run)
            started.append(th)
            th.start()
            go.wait(10)
            # a reader that does not wait for the commit is done by now
            th.join(timeout=0.5)

    eng.put = put
    return started, orig_put


def test_poll_waits_for_a_commit_in_flight():
    """A poll that starts while a transaction applies its versions waits
    for it (storage/mvcc.py write_window), so no version of the commit
    falls below a closed horizon; the JAX store has no such window and a
    poll there can close over the versions not yet written."""
    store, cat, sess = make_sess(PORT)
    sess.execute(T_DDL)
    sink = t_cf.MemorySink()
    stream = t_cf.ChangefeedStream(store, cat.desc("t"), sink)
    stream.poll()
    started, orig_put = _commit_with_a_racing_reader(store, stream.poll)
    try:
        sess.execute("insert into t values (1, 0, 10), (2, 1, 20), "
                     "(3, 2, 30)")
    finally:
        store.engine.put = orig_put
    started[0].join(timeout=10)
    assert not started[0].is_alive()
    stream.poll()
    assert sorted(e["key"] for e in sink.events()) == [1, 2, 3]


def test_refresh_waits_for_a_commit_in_flight():
    store, cat, sess = make_sess(PORT)
    sess.execute(T_DDL)
    sess.execute(f"create materialized view mv as {VIEW_SQL}")
    mv = sess._matviews().get("mv")
    started, orig_put = _commit_with_a_racing_reader(store, mv.refresh)
    try:
        sess.execute("insert into t values (1, 0, 10), (2, 1, 20), "
                     "(3, 2, 30)")
    finally:
        store.engine.put = orig_put
    started[0].join(timeout=10)
    assert not started[0].is_alive()
    assert view_matches_oracle(sess)
    assert view_read(sess)["n"].tolist() == [1, 1, 1]
