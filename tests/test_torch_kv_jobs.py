"""The port's host-only pieces under the storage-backed session, against
the JAX package's:

- kv/txn.py `DB`/`Txn`/`TxnRetryError`: the cases of tests/test_kv.py
  (:24-83) run the same operations on both packages (PyEngine and the
  native engine) and give the same values, timestamps' equalities,
  conflicts and final store; the kvnemesis check (:97) runs on the port
  at a small op count (its threads interleave differently each run, so
  it is held to the serial replay, not to a JAX run);
- server/jobs.py `Registry`: the cases of tests/test_services.py
  (:34-96) on both packages: ran ids, states, errors, checkpoints,
  resumption after a failure, lease fencing, pause and cancel;
- kv/streamer.py: tests/test_streamer.py :30 on both packages, and the
  port's batched lookup equal to the JAX one;
- coldata/carry.py `carry_session_store`: a JAX session's tables
  (written by JAX DDL and DML: strings, decimals, NULLs, an index, an
  added and a dropped column, deletes, a dropped table) read back equal
  through a port SessionCatalog over the carried store, index scans
  included."""

import threading

import numpy as np
import pytest

from cockroach_tpu.kv import DB as JDB
from cockroach_tpu.kv import TxnRetryError as JTxnRetryError
from cockroach_tpu.kv.streamer import Streamer as JStreamer
from cockroach_tpu.server.jobs import Registry as JRegistry
from cockroach_tpu.server.jobs import StaleLease as JStaleLease
from cockroach_tpu.storage import MVCCStore as JMVCCStore
from cockroach_tpu.storage import PyEngine as JPyEngine
from cockroach_tpu.storage.engine import NativeEngine as JNativeEngine
from cockroach_tpu.util.hlc import HLC as JHLC
from cockroach_tpu.util.hlc import ManualClock as JManualClock
from cockroach_tpu_torch.coldata.carry import carry_session_store
from cockroach_tpu_torch.kv import DB as TDB
from cockroach_tpu_torch.kv import TxnRetryError as TTxnRetryError
from cockroach_tpu_torch.kv.streamer import Streamer as TStreamer
from cockroach_tpu_torch.server import Registry as TRegistry
from cockroach_tpu_torch.server import States
from cockroach_tpu_torch.server.jobs import StaleLease as TStaleLease
from cockroach_tpu_torch.storage import MVCCStore as TMVCCStore
from cockroach_tpu_torch.storage import NativeEngine as TNativeEngine
from cockroach_tpu_torch.storage import PyEngine as TPyEngine
from cockroach_tpu_torch.util.hlc import HLC as THLC
from cockroach_tpu_torch.util.hlc import ManualClock as TManualClock
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": dict(DB=JDB, Retry=JTxnRetryError, Store=JMVCCStore,
                Py=JPyEngine, Native=JNativeEngine, HLC=JHLC,
                Clock=JManualClock, Registry=JRegistry, Stale=JStaleLease,
                Streamer=JStreamer),
    "port": dict(DB=TDB, Retry=TTxnRetryError, Store=TMVCCStore,
                 Py=TPyEngine, Native=TNativeEngine, HLC=THLC,
                 Clock=TManualClock, Registry=TRegistry, Stale=TStaleLease,
                 Streamer=TStreamer),
}


def _store(p, native=False, start=100):
    eng = p["Native"]() if native else p["Py"]()
    return p["Store"](engine=eng, clock=p["HLC"](p["Clock"](start)))


def _both(fn, **kw):
    """fn(package namespace) on both packages; equal. -> the port's."""
    want = fn(PKGS["jax"], **kw)
    got = fn(PKGS["port"], **kw)
    assert got == want
    return got


def _caught(fn, exc):
    try:
        return ("ok", fn())
    except exc:
        return ("retry",)


ENGINES = pytest.mark.parametrize("native", [False, True],
                                  ids=["py", "native"])


# --------------------------------------------------------- tests/test_kv.py

@ENGINES
def test_txn_read_your_writes_and_atomic_commit(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        t = db.txn()
        t.put(1, 1, [10])
        t.put(1, 2, [20])
        out = [t.get(1, 1), db.store.get(1, 1)]
        t.commit()
        (r1, ts1), (r2, ts2) = db.store.get(1, 1), db.store.get(1, 2)
        return out + [r1, r2, ts1 == ts2]

    assert _both(case, native=native) == [[10], None, [10], [20], True]


@ENGINES
def test_txn_snapshot_isolation(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        t0 = db.txn()
        t0.put(1, 1, [1])
        t0.commit()
        reader = db.txn()
        first = reader.get(1, 1)
        writer = db.txn()
        writer.put(1, 1, [2])
        writer.commit()
        return [first, reader.get(1, 1), db.store.get(1, 1)[0]]

    assert _both(case, native=native) == [[1], [1], [2]]


@ENGINES
def test_txn_write_write_conflict_aborts(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        a, b = db.txn(), db.txn()
        a.put(1, 5, [1])
        b.put(1, 5, [2])
        a.commit()
        return [_caught(b.commit, p["Retry"]), db.store.get(1, 5)[0]]

    assert _both(case, native=native) == [("retry",), [1]]


@ENGINES
def test_txn_read_write_conflict_aborts(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        db.run(lambda t: t.put(1, 7, [1]))
        a = db.txn()
        seen = a.get(1, 7)
        db.run(lambda t: t.put(1, 7, [2]))
        a.put(1, 8, [100])
        return [seen, _caught(a.commit, p["Retry"]), db.store.get(1, 8)]

    assert _both(case, native=native) == [[1], ("retry",), None]


@ENGINES
def test_txn_phantom_protection(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        db.run(lambda t: t.put(1, 1, [1]))
        a = db.txn()
        seen = a.scan_pks(1)
        db.run(lambda t: t.put(1, 2, [2]))
        a.put(2, 0, [len(a.scan_pks(1))])
        return [seen, _caught(a.commit, p["Retry"])]

    assert _both(case, native=native) == [[1], ("retry",)]


@ENGINES
def test_db_run_retries_to_success(native):
    def case(p, native):
        db = p["DB"](_store(p, native))
        db.run(lambda t: t.put(1, 1, [0]))

        def incr(t):
            v = t.get(1, 1)
            t.put(1, 1, [v[0] + 1])

        for _ in range(10):
            db.run(incr)
        return db.store.get(1, 1)[0]

    assert _both(case, native=native) == [10]


@ENGINES
def test_kvnemesis_randomized_serializability(native):
    """tests/test_kv.py's check on the port, 4 threads x 10 transactions:
    the committed history equals its serial replay in commit-timestamp
    order."""
    p = PKGS["port"]
    db = p["DB"](_store(p, native))
    n_keys = 8
    for k in range(n_keys):
        db.run(lambda t, k=k: t.put(1, k, [0]))
    committed = []
    mu = threading.Lock()

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(10):
            txn = db.txn()
            try:
                a, b = int(r.integers(0, n_keys)), int(r.integers(0, n_keys))
                add = int(r.integers(1, 10))
                txn.put(1, b, [txn.get(1, a)[0] + add])
                ts = txn.commit()
            except p["Retry"]:
                continue
            with mu:
                committed.append((ts, a, b, add))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    state = {k: 0 for k in range(n_keys)}
    for _ts, a, b, add in sorted(committed):
        state[b] = state[a] + add
    assert {k: db.store.get(1, k)[0][0] for k in range(n_keys)} == state
    assert committed


# --------------------------------------------------- tests/test_services.py

def test_job_create_checkpoint_succeed():
    def case(p):
        reg = p["Registry"](_store(p, start=1000), node_id=1)
        seen = {}

        def resumer(registry, rec):
            for i in range(rec.progress.get("i", 0), 5):
                registry.checkpoint(rec.id, rec.lease_epoch, {"i": i + 1})
            seen["done"] = True

        reg.register_resumer("noop", resumer)
        jid = reg.create("noop", {"x": 1})
        ran = reg.adopt_and_run()
        rec = reg.get(jid)
        return [ran == [jid], seen, rec.state, rec.progress, rec.payload]

    assert _both(case) == [True, {"done": True}, States.SUCCEEDED,
                           {"i": 5}, {"x": 1}]


def test_job_failure_recorded_and_adoption_resumes():
    def case(p):
        store = _store(p, start=1000)
        reg = p["Registry"](store, node_id=1, lease_ttl=5)
        attempts = []

        def flaky(registry, rec):
            start = rec.progress.get("i", 0)
            attempts.append(start)
            for i in range(start, 6):
                registry.checkpoint(rec.id, rec.lease_epoch, {"i": i + 1})
                if len(attempts) == 1 and i == 2:
                    raise RuntimeError("boom")

        reg.register_resumer("flaky", flaky)
        jid = reg.create("flaky", {})
        reg.adopt_and_run()
        failed = (reg.get(jid).state, "boom" in reg.get(jid).error)
        rec = reg.get(jid)
        rec.state = States.RUNNING
        reg._save(rec)
        reg2 = p["Registry"](store, node_id=2, lease_ttl=5)
        reg2.register_resumer("flaky", flaky)
        reg2.adopt_and_run()
        return [failed, reg2.get(jid).state, attempts]

    assert _both(case) == [(States.FAILED, True), States.SUCCEEDED, [0, 3]]


def test_job_lease_fencing():
    def case(p):
        reg = p["Registry"](_store(p, start=1000), node_id=1)
        jid = reg.create("k", {})
        rec = reg.get(jid)
        rec.lease_epoch += 1  # another registry claimed it
        reg._save(rec)
        try:
            reg.checkpoint(jid, rec.lease_epoch - 1, {"i": 1})
        except p["Stale"]:
            return "fenced"
        return "accepted"

    assert _both(case) == "fenced"


def test_job_pause_cancel():
    def case(p):
        reg = p["Registry"](_store(p, start=1000), node_id=1)
        reg.register_resumer("k", lambda r, rec: None)
        jid = reg.create("k", {})
        reg.pause(jid)
        paused = reg.adopt_and_run()
        reg.resume(jid)
        resumed = reg.adopt_and_run() == [jid]
        jid2 = reg.create("k", {})
        reg.cancel(jid2)
        return [paused, resumed, reg.get(jid2).state]

    assert _both(case) == [[], True, States.CANCELLED]


# --------------------------------------------------- tests/test_streamer.py

@ENGINES
def test_multi_get_matches_sequential_and_jax(native):
    def case(p, native):
        st = _store(p, native, start=1000)
        n = 5000
        st.ingest_table(7, np.arange(n),
                        {"a": np.arange(n) * 3, "b": np.arange(n) + 7})
        ids = np.unique(np.random.default_rng(5).integers(0, n * 2, 800))
        got = p["Streamer"](st, gap_limit=64).multi_get(7, ids, 2)
        for rid in ids:
            hit = st.get(7, int(rid))
            if hit is None:
                assert int(rid) not in got
            else:
                assert got[int(rid)][:2].tolist() == hit[0][:2]
        return {k: v.tolist() for k, v in got.items()}

    assert len(_both(case, native=native)) > 0


# ---------------------------------------------------- carry_session_store

JAX_WRITES = [
    "create table users (id int primary key, name text, "
    "balance decimal(2), joined date, score int)",
    "insert into users values (1, 'ada', 10.50, date '2020-01-02', 7), "
    "(2, 'grace', 7.25, date '2021-03-04', null), "
    "(3, 'linus', -1.00, date '1969-12-31', 9), "
    "(4, 'ken', 0.01, date '2000-02-29', 7)",
    "create index us on users (score)",
    "update users set balance = balance + 1 where score = 7",
    "delete from users where id = 3",
    "alter table users add column tag text",
    "insert into users values (5, 'barbara', 3.00, date '2022-05-05', 9, "
    "'x')",
    "alter table users drop column joined",
    "create table events (a int, b text)",
    "insert into events values (1, 'p'), (2, null), (1, 'q')",
    "create table gone (z int)",
    "insert into gone values (1)",
    "drop table gone",
    "analyze users",
]
READS = [
    "select id, name, balance, score, tag from users order by id",
    "select id from users where score = 7 order by id",
    "select a, b from events order by a, b",
    "select count(*) as n from events",
]


def test_carried_session_reads_equal_jax():
    from cockroach_tpu.cli import decode_column as jdecode
    from cockroach_tpu.sql.session import Session as JSession
    from cockroach_tpu.sql.session import SessionCatalog as JCatalog
    from cockroach_tpu_torch.cli import decode_column as tdecode
    from cockroach_tpu_torch.sql.session import Session as TSession
    from cockroach_tpu_torch.sql.session import SessionCatalog as TCatalog

    from test_torch_session_parity import _outcome

    jstore = JMVCCStore(engine=JPyEngine(), clock=JHLC(JManualClock(1000)))
    jsess = JSession(JCatalog(jstore), capacity=256)
    for sql in JAX_WRITES:
        jsess.execute(sql)
    tcat = TCatalog(carry_session_store(jstore, device="cpu"))
    tsess = TSession(tcat, capacity=256, device="cpu")
    jcat = jsess.catalog
    assert sorted(tcat._descs) == sorted(jcat._descs) == ["events", "users"]
    for name in ("users", "events"):
        assert tcat.desc(name).encode() == jcat.desc(name).encode()
        ts, js = tcat.table_stats(name), jcat.table_stats(name)
        assert (ts and ts.encode()) == (js and js.encode())
        assert (ts is None) == (name == "events")  # analyzed: users
        j = list(jcat.table_chunks(name, 2)())
        t = list(tcat.table_chunks(name, 2)())
        assert len(j) == len(t)
        for jc, tc in zip(j, t):
            assert list(jc) == list(tc)
            for c in jc:
                np.testing.assert_array_equal(np.asarray(tc[c]),
                                              np.asarray(jc[c]), err_msg=c)
    for sql in READS:
        assert _outcome(tsess, sql, tdecode) == _outcome(jsess, sql, jdecode)
    # the carried index serves the port's index scan
    _k, lines, _s = tsess.execute(READS[1].replace("select", "explain "
                                                   "select", 1))
    assert any("index scan users@score [7, 7]" in ln for ln in lines)


def test_session_tables_on_the_resident_tier_read_as_jax():
    """With `storage.resident_scan` on, a port session's reads go through
    the resident tier (attached, folded after writes, attached again
    after ALTER TABLE ADD COLUMN widens the rows, when the versions'
    widths alternate); every read equals the JAX session's host walk."""
    from cockroach_tpu.cli import decode_column as jdecode
    from cockroach_tpu.sql.session import Session as JSession
    from cockroach_tpu.sql.session import SessionCatalog as JCatalog
    from cockroach_tpu_torch.cli import decode_column as tdecode
    from cockroach_tpu_torch.sql.session import Session as TSession
    from cockroach_tpu_torch.sql.session import SessionCatalog as TCatalog
    from cockroach_tpu_torch.storage import resident
    from cockroach_tpu_torch.util.settings import Settings

    from test_torch_session_parity import _outcome

    jsess = JSession(JCatalog(JMVCCStore(engine=JPyEngine(),
                                         clock=JHLC(JManualClock(1000)))),
                     capacity=64)
    store = TMVCCStore(engine=TNativeEngine(),
                       clock=THLC(TManualClock(1000)), device="cpu")
    tsess = TSession(TCatalog(store), capacity=64, device="cpu")
    read = "select id, v, tag from t order by id"
    rows = ", ".join(f"({i}, {i * 7 % 100}, 't{i % 3}')" for i in range(300))
    steps = ["create table t (id int primary key, v int, tag text)",
             f"insert into t values {rows}", read,
             "update t set v = v + 1 where v < 30", read,
             "delete from t where v >= 90", read,
             "alter table t add column w int", read.replace("tag", "w"),
             "update t set w = id where id < 100",
             "select id, w from t where w is not null order by id"]
    from cockroach_tpu_torch.exec import stats

    settings = Settings()
    prev = settings.get(resident.RESIDENT_SCAN)
    settings.set(resident.RESIDENT_SCAN, True)
    resident.reset()
    col = stats.enable()
    try:
        for sql in steps:
            got = _outcome(tsess, sql, tdecode)
            assert got[0] != "error" and got == _outcome(jsess, sql,
                                                         jdecode), sql
        tid = tsess.catalog.desc("t").table_id
        assert resident.lookup(store, tid) is not None
    finally:
        stats.disable()
        settings.set(resident.RESIDENT_SCAN, prev)
        resident.reset()
    assert col.stages["scan.resident_attach"].events == 2
    assert col.stages["scan.resident"].events == 5
    assert "sql.prepared_hit" not in col.stages
    assert "scan.resident_fold" in col.stages
    assert "scan.resident_fallback" not in col.stages
