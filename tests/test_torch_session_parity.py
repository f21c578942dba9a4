"""The storage-backed session on both packages: the cases of
tests/test_session.py (:28-274), tests/test_index.py (:39-100),
tests/test_alter.py (:27-108) and tests/test_prepared.py (:46, :66, :86,
:98, :114) run statement for statement on a JAX
`Session(SessionCatalog(MVCCStore(PyEngine, HLC(ManualClock))))` and on
the port's counterpart (device="cpu"), and each statement's outcome is
equal: its kind and tag, its rows (column names, rendered with each
package's cli.py `decode_column`, sorted where the statement has no
ORDER BY), or its error class and SQLSTATE. EXPLAIN compares the index
scan's line. Besides the statements, the same probes read both sides:
the catalog's row estimates, the descriptors' column states and the
jobs registry's records (the backfill's checkpoints). The JAX tests'
own assertions are kept on the port's outcomes; the prepared cases read
the port's stats events where the JAX tests read the JAX package's (the
port has no `fused.compile`: a CUDA graph is captured, not compiled)."""

import numpy as np
import pytest

import cockroach_tpu.exec.rowexec  # noqa: F401 — registers its settings
from cockroach_tpu.cli import decode_column as jdecode
from cockroach_tpu.server.jobs import Registry as JRegistry
from cockroach_tpu.sql.session import Session as JSession
from cockroach_tpu.sql.session import SessionCatalog as JSessionCatalog
from cockroach_tpu.storage.engine import PyEngine as JPyEngine
from cockroach_tpu.storage.mvcc import MVCCStore as JMVCCStore
from cockroach_tpu.util import fault as jfault
from cockroach_tpu.util.hlc import HLC as JHLC
from cockroach_tpu.util.hlc import ManualClock as JManualClock
from cockroach_tpu.util.settings import Settings as JSettings
from cockroach_tpu_torch.cli import decode_column as tdecode
from cockroach_tpu_torch.server.jobs import Registry as TRegistry
from cockroach_tpu_torch.sql.session import Session as TSession
from cockroach_tpu_torch.sql.session import SessionCatalog as TSessionCatalog
from cockroach_tpu_torch.storage.engine import PyEngine as TPyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore as TMVCCStore
from cockroach_tpu_torch.util import fault as tfault
from cockroach_tpu_torch.util.hlc import HLC as THLC
from cockroach_tpu_torch.util.hlc import ManualClock as TManualClock
from cockroach_tpu_torch.util.settings import Settings as TSettings
from torch_threads import one_torch_thread  # noqa: F401


def _render(payload, schema, decode):
    names = [n for n in payload if not n.endswith("__valid")]
    cols = []
    for n in names:
        ty = d = None
        if schema is not None:
            try:
                ty = schema.field(n).type
                d = schema.dictionary(n)
            except KeyError:
                pass
        cols.append(decode(payload[n], payload.get(n + "__valid"), ty, d))
    return names, [tuple(c[r] for c in cols)
                   for r in range(len(cols[0]) if cols else 0)]


def _outcome(sess, sql, decode):
    try:
        kind, payload, schema = sess.execute(sql)
    except Exception as e:  # noqa: BLE001 — the outcome records it
        return ("error", type(e).__name__, getattr(e, "pgcode", None))
    if kind == "rows":
        names, rows = _render(payload, schema, decode)
        if "order by" not in sql.lower():
            rows = sorted(rows, key=repr)
        return ("rows", names, rows)
    if kind == "explain":
        lines = payload if not isinstance(payload, str) else \
            payload.splitlines()
        return ("explain", [ln.split("->")[-1].strip().split("  [")[0]
                            for ln in lines if "index scan" in ln])
    return (kind, payload)


class Side:
    """One package's session over a fresh store, with its probes."""

    def __init__(self, session_cls, catalog_cls, store, registry_cls,
                 fault, decode, **kw):
        self.session_cls, self.kw = session_cls, kw
        self.store = store
        self.sess = session_cls(catalog_cls(store), capacity=256, **kw)
        self.registry_cls, self.fault, self.decode = (registry_cls, fault,
                                                      decode)

    def run(self, sql, sess=None):
        return _outcome(sess or self.sess, sql, self.decode)

    def other(self):
        """A second session over the same catalog and DB."""
        return self.session_cls(self.sess.catalog, capacity=256,
                                db=self.sess.db, **self.kw)

    def jobs(self, kind):
        return [(r.kind, r.state, int(r.progress.get("start_pk", 0)))
                for r in self.registry_cls(self.store).list_jobs()
                if r.kind == kind]


class Pair:
    def __init__(self):
        self.j = Side(JSession, JSessionCatalog,
                      JMVCCStore(engine=JPyEngine(),
                                 clock=JHLC(JManualClock(1000))),
                      JRegistry, jfault, jdecode)
        self.t = Side(TSession, TSessionCatalog,
                      TMVCCStore(engine=TPyEngine(),
                                 clock=THLC(TManualClock(1000)),
                                 device="cpu"),
                      TRegistry, tfault, tdecode, device="cpu")
        self._others = None

    def run(self, sql, other=False):
        """The statement on both sides; their outcomes must be equal.
        -> the port's outcome."""
        if other:
            if self._others is None:
                self._others = (self.j.other(), self.t.other())
            want = self.j.run(sql, self._others[0])
            got = self.t.run(sql, self._others[1])
        else:
            want, got = self.j.run(sql), self.t.run(sql)
        assert got == want, sql
        return got

    def probe(self, fn):
        """fn(side) on both sides; equal. -> the port's value."""
        want, got = fn(self.j), fn(self.t)
        assert got == want
        return got


@pytest.fixture
def pair():
    return Pair()


@pytest.fixture(autouse=True)
def _restore_settings():
    keys = ("sql.tpu.exact_arithmetic", "sql.distsql.temp_storage.workmem")
    saved = [(JSettings().get(k), TSettings().get(k)) for k in keys]
    yield
    for k, (jv, tv) in zip(keys, saved):
        JSettings().set(k, jv)
        TSettings().set(k, tv)
    jfault.registry().disarm()
    tfault.registry().disarm()


def _col(out, name):
    names, rows = out[1], out[2]
    i = names.index(name)
    return [r[i] for r in rows]


# --------------------------------------------------- tests/test_session.py

def test_create_insert_select_roundtrip(pair):
    assert pair.run("create table users (id int primary key, name text, "
                    "balance decimal(2), joined date)")[0] == "ok"
    assert pair.run("insert into users values "
                    "(1, 'ada', 10.50, date '2020-01-02'), "
                    "(2, 'grace', 7.25, date '2021-03-04')") == \
        ("ok", "INSERT 2")
    got = pair.run("select id, name, balance, joined from users "
                   "order by id")
    assert got[2] == [("1", "ada", "10.50", "2020-01-02"),
                      ("2", "grace", "7.25", "2021-03-04")]


def test_insert_column_subset_and_hidden_rowid(pair):
    pair.run("create table t (a int, b int)")
    pair.run("insert into t (b, a) values (2, 1), (4, 3)")
    assert pair.run("select a, b from t order by b")[2] == \
        [("1", "2"), ("3", "4")]
    pair.run("insert into t (b) values (9)")
    assert pair.run("select a, b from t where a is null")[2] == \
        [(None, "9")]
    pair.run("create table nn (a int, b int not null)")
    assert pair.run("insert into nn (a) values (1)")[:2] == \
        ("error", "BindError")
    assert pair.run("insert into nn values (1, null)")[:2] == \
        ("error", "BindError")


def test_drop_does_not_resurrect_rows(pair):
    pair.run("create table t (a int)")
    pair.run("insert into t values (1), (2), (3)")
    pair.run("drop table t")
    pair.run("create table u (b int)")
    assert pair.run("select b from u")[2] == []


def test_table_rows_estimate_tracks_mutations(pair):
    pair.run("create table t (id int primary key, v int)")
    for i in range(10):
        pair.run(f"insert into t values ({i}, {i})")
    assert pair.probe(lambda s: s.sess.catalog.table_rows("t")) == 10
    pair.run("delete from t where v < 4")
    assert pair.probe(lambda s: s.sess.catalog.table_rows("t")) == 6


def test_update_with_where_and_expressions(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 10), (2, 20), (3, 30)")
    assert pair.run("update t set v = v + 5 where v >= 20") == \
        ("ok", "UPDATE 2")
    assert _col(pair.run("select id, v from t order by id"), "v") == \
        ["10", "25", "35"]


def test_delete_with_where(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 1), (2, 2), (3, 3)")
    assert pair.run("delete from t where v = 2") == ("ok", "DELETE 1")
    assert _col(pair.run("select id from t order by id"), "id") == \
        ["1", "3"]


def test_update_string_predicate(pair):
    pair.run("create table t (id int primary key, tag text)")
    pair.run("insert into t values (1, 'keep'), (2, 'drop')")
    pair.run("delete from t where tag = 'drop'")
    assert pair.run("select id, tag from t")[2] == [("1", "keep")]


def test_aggregate_over_mutated_table(pair):
    pair.run("create table m (id int primary key, grp int, "
             "amt decimal(2))")
    for i in range(20):
        pair.run(f"insert into m values ({i}, {i % 3}, {i}.25)")
    pair.run("update m set amt = amt + 100 where grp = 0")
    got = pair.run("select grp, sum(amt) as s, count(*) as n "
                   "from m group by grp order by grp")
    assert _col(got, "n") == ["7", "7", "6"]


def test_drop_and_if_exists(pair):
    pair.run("create table t (a int)")
    pair.run("drop table t")
    assert pair.run("select a from t")[:2] == ("error", "BindError")
    assert pair.run("drop table if exists t") == ("ok", "DROP TABLE")
    assert pair.run("drop table t")[:2] == ("error", "BindError")
    pair.run("create table if not exists t2 (a int)")
    assert pair.run("create table if not exists t2 (a int)") == \
        ("ok", "CREATE TABLE")


def test_descriptors_survive_catalog_reload(pair):
    pair.run("create table p (id int primary key, name text)")
    pair.run("insert into p values (7, 'x')")

    def reload(side):
        cat2 = type(side.sess.catalog)(side.store)
        s2 = side.session_cls(cat2, capacity=64, **side.kw)
        return _outcome(s2, "select id, name from p", side.decode)

    assert pair.probe(reload)[2] == [("7", "x")]


def test_insert_pk_conflict_raises_and_upsert_overwrites(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 10)")
    assert pair.run("insert into t values (1, 99)")[:2] == \
        ("error", "BindError")
    pair.run("upsert into t values (1, 99)")
    assert pair.run("select v from t")[2] == [("99",)]


def test_set_show_session_vars(pair):
    assert pair.run("set exact_arithmetic = on")[0] == "ok"
    assert pair.run("show exact_arithmetic")[2] == [("True",)]
    pair.run("set exact_arithmetic = off")
    assert pair.run("set nonsense = 1")[:2] == ("error", "BindError")


def test_interactive_transaction_commit_and_rollback(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 10)")
    pair.run("begin")
    pair.run("insert into t values (2, 20)")
    pair.run("update t set v = 99 where id = 1")
    assert pair.run("rollback") == ("ok", "ROLLBACK")
    assert pair.run("select id, v from t order by id")[2] == [("1", "10")]
    pair.run("begin transaction")
    pair.run("insert into t values (2, 20)")
    pair.run("update t set v = 99 where id = 1")
    assert pair.run("commit") == ("ok", "COMMIT")
    assert _col(pair.run("select id, v from t order by id"), "v") == \
        ["99", "20"]
    assert pair.run("commit")[:2] == ("error", "BindError")
    pair.run("begin")
    assert pair.run("begin")[:2] == ("error", "BindError")
    pair.run("abort")


def test_transaction_conflict_surfaces_at_commit(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 1)")
    pair.run("begin")
    pair.run("update t set v = 2 where id = 1")
    pair.run("update t set v = 5 where id = 1", other=True)
    assert pair.run("commit")[:2] == ("error", "BindError")
    assert pair.run("select v from t")[2] == [("5",)]


def test_txn_statement_error_aborts_transaction(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("begin")
    pair.run("insert into t values (1, 1)")
    assert pair.run("insert into t values (2)")[0] == "error"
    assert pair.run("insert into t values (3, 3)")[:2] == \
        ("error", "BindError")
    assert pair.run("commit") == ("ok", "ROLLBACK")
    assert pair.run("select id from t")[2] == []


def test_txn_read_your_writes_in_update(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("begin")
    pair.run("insert into t values (7, 70)")
    assert pair.run("update t set v = 71 where id = 7") == \
        ("ok", "UPDATE 1")
    pair.run("commit work")
    assert pair.run("select v from t")[2] == [("71",)]


def test_txn_rollback_does_not_drift_stats(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 1)")
    rows = lambda s: s.sess.catalog.table_rows("t")  # noqa: E731
    assert pair.probe(rows) == 1
    pair.run("begin")
    pair.run("insert into t values (2, 2), (3, 3)")
    pair.run("rollback transaction")
    assert pair.probe(rows) == 1
    pair.run("begin")
    pair.run("insert into t values (2, 2)")
    pair.run("commit")
    assert pair.probe(rows) == 2


def test_txn_rejects_ddl_and_redundant_begin_is_benign(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("begin")
    assert pair.run("create table u (a int)")[:2] == ("error", "BindError")
    pair.run("rollback")
    pair.run("begin")
    pair.run("insert into t values (1, 1)")
    assert pair.run("begin")[:2] == ("error", "BindError")
    assert pair.run("commit") == ("ok", "COMMIT")
    assert pair.run("select id from t")[2] == [("1",)]


def test_upsert_does_not_drift_stats(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 1)")
    pair.run("upsert into t values (1, 2)")
    assert pair.probe(lambda s: s.sess.catalog.table_rows("t")) == 1


def test_select_inside_transaction_reads_its_writes(pair):
    """A SELECT inside an open transaction reads the transaction's
    buffered rows of the tables it wrote (_TxnReadCatalog), and the
    committed rows of the others."""
    pair.run("create table t (id int primary key, v int)")
    pair.run("create table u (id int primary key, w int)")
    pair.run("insert into u values (1, 100)")
    pair.run("begin")
    pair.run("insert into t values (1, 10), (2, 20)")
    assert pair.run("select id, v from t order by id")[2] == \
        [("1", "10"), ("2", "20")]
    assert pair.run("select id, v from t order by id", other=True)[2] == []
    assert pair.run("select w from u")[2] == [("100",)]
    pair.run("commit")
    assert pair.run("select id, v from t order by id", other=True)[2] == \
        [("1", "10"), ("2", "20")]


# ----------------------------------------------------- tests/test_index.py

def _setup(pair, n=200):
    pair.run("create table t (id int primary key, v int, w int)")
    vals = np.random.default_rng(9).integers(0, 50, n)
    stmts = ", ".join(f"({i}, {int(vals[i])}, {i * 3})" for i in range(n))
    pair.run(f"insert into t values {stmts}")
    return vals


def _ids(out):
    return sorted(int(x) for x in _col(out, "id"))


def test_create_index_and_point_lookup(pair):
    vals = _setup(pair)
    pair.run("create index iv on t (v)")
    got = pair.run("select id, v from t where v = 7")
    assert _ids(got) == sorted(int(i) for i in np.nonzero(vals == 7)[0])
    assert set(_col(got, "v")) == {"7"}


def test_explain_shows_index_scan(pair):
    _setup(pair)
    pair.run("create index iv on t (v)")
    assert pair.run("explain select id from t where v = 7") == \
        ("explain", ["index scan t@v [7, 7]"])


def test_range_lookup_through_index(pair):
    vals = _setup(pair)
    pair.run("create index iv on t (v)")
    got = pair.run("select id from t where v >= 10 and v < 13")
    assert _ids(got) == sorted(
        int(i) for i in np.nonzero((vals >= 10) & (vals < 13))[0])


def test_index_maintained_by_dml(pair):
    vals = _setup(pair)
    pair.run("create index iv on t (v)")
    pair.run("insert into t values (1000, 7, 0)")
    pair.run("update t set v = 7 where id = 0")
    pair.run("delete from t where id = 1")
    want = (set(int(i) for i in np.nonzero(vals == 7)[0]) | {1000, 0}) - {1}
    assert _ids(pair.run("select id from t where v = 7")) == sorted(want)


def test_index_backfill_is_a_checkpointed_job(pair):
    _setup(pair, n=1200)  # > one 512-row backfill chunk
    pair.run("create index iv on t (v)")
    jobs = pair.probe(lambda s: s.jobs("index_backfill"))
    assert len(jobs) == 1 and jobs[0][1] == "succeeded"
    assert jobs[0][2] >= 1200


def test_index_errors(pair):
    _setup(pair)
    pair.run("create index iv on t (v)")
    for sql in ("create index iv2 on t (v)", "create index ii on t (id)",
                "create index ix on t (nope)"):
        assert pair.run(sql)[:2] == ("error", "BindError")


def test_results_match_full_scan(pair):
    vals = _setup(pair)
    no_index = pair.run("select id, w from t where v = 21 or v = 3")
    pair.run("create index iv on t (v)")
    assert pair.run("select id, w from t where v = 21 or v = 3") == no_index
    got = pair.run("select id, w from t where v = 21 and w >= 0")
    assert _ids(got) == sorted(int(i) for i in np.nonzero(vals == 21)[0])


# ----------------------------------------------------- tests/test_alter.py

def test_add_column_backfills_nulls_then_accepts_writes(pair):
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values (1, 10), (2, 20)")
    pair.run("alter table t add column w int")
    assert _col(pair.run("select id, w from t order by id"), "w") == \
        [None, None]
    pair.run("insert into t values (3, 30, 333)")
    pair.run("update t set w = 111 where id = 1")
    assert _col(pair.run("select id, w from t order by id"), "w") == \
        ["111", None, "333"]
    assert pair.run("select count(w), count(*) from t")[2] == [("2", "3")]


def test_drop_column_hides_and_scrubs(pair):
    pair.run("create table t (id int primary key, a int, b int)")
    pair.run("insert into t values (1, 10, 100), (2, 20, 200)")
    pair.run("alter table t drop column a")
    assert pair.run("select a from t")[0] == "error"
    assert _col(pair.run("select id, b from t order by id"), "b") == \
        ["100", "200"]
    pair.run("insert into t values (3, 300)")
    assert _col(pair.run("select id, b from t order by id"), "b") == \
        ["100", "200", "300"]
    assert pair.run("alter table t add column a int")[:2] == \
        ("error", "BindError")


def test_add_column_crash_mid_backfill_then_resume(pair):
    """The planted `alter.backfill_chunk` fault after the first chunk:
    the job fails past its first checkpoint and the column stays
    hidden; the same ALTER resumes the backfill."""
    pair.run("create table t (id int primary key, v int)")
    pair.run("insert into t values " + ", ".join(
        f"({i}, {i})" for i in range(600)))  # > 2 backfill chunks (256)
    for side in (pair.j, pair.t):
        side.fault.registry().arm("alter.backfill_chunk", after=1)
    try:
        assert pair.run("alter table t add column w int")[:2] == \
            ("error", "BindError")
    finally:
        for side in (pair.j, pair.t):
            side.fault.registry().disarm()
    assert pair.probe(lambda s: s.sess.catalog.desc("t").backfilling) == "w"
    crashed = pair.probe(lambda s: s.jobs("add_column"))
    assert crashed and crashed[0][1] == "failed" and crashed[0][2] > 0
    assert pair.run("select w from t")[0] == "error"
    pair.run("alter table t add column w int")
    assert pair.run("select count(w), count(*) from t")[2] == [("0", "600")]
    pair.run("update t set w = 7 where id = 599")
    assert pair.run("select count(w) from t")[2] == [("1",)]


# -------------------------------------------------- tests/test_prepared.py

PREPARED_Q = "select a, sum(b) as sb from t group by a order by a"


def _prepared_pair(n_rows=500):
    from cockroach_tpu.exec.scan_cache import scan_image_cache as jcache
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    jcache().clear()
    scan_image_cache().clear()
    p = Pair()
    p.run("create table t (a int, b int)")
    p.run("insert into t values " + ", ".join(
        f"({i % 7}, {i})" for i in range(n_rows)))
    return p


def _events(fn):
    """fn() under the port's stats collection -> its stage events."""
    from cockroach_tpu_torch.exec import stats

    col = stats.enable()
    try:
        fn()
    finally:
        stats.disable()
    return {n: st.events for n, st in col.stages.items()}


def _sb(a, b):
    return [str(b[a == g].sum()) for g in sorted(set(a.tolist()))]


def test_warm_reexecution_is_single_dispatch():
    p = _prepared_pair()
    first = p.run(PREPARED_Q)
    ev = _events(lambda: p.run(PREPARED_Q))
    assert "scan.stack" not in ev and "fused.prime" not in ev, ev
    assert ev["fused.exec"] == 1 and ev["prime.skipped"] >= 1, ev
    assert ev["sql.prepared_hit"] == 1, ev
    assert p.run(PREPARED_Q) == first
    assert _col(first, "sb") == _sb(np.arange(500) % 7, np.arange(500))


def test_write_invalidates_prepared_entry():
    p = _prepared_pair()
    p.run(PREPARED_Q)
    p.run(PREPARED_Q)
    p.run("insert into t values (3, 100000)")
    out = []
    ev = _events(lambda: out.append(p.run(PREPARED_Q)))
    assert "sql.prepared_hit" not in ev and ev["fused.prime"] >= 1, ev
    a = np.concatenate([np.arange(500) % 7, [3]])
    b = np.concatenate([np.arange(500), [100000]])
    assert _col(out[0], "sb") == _sb(a, b)


def test_prepared_cache_cleared_on_ddl_and_set():
    p = _prepared_pair(100)
    p.run(PREPARED_Q)
    assert p.probe(lambda s: PREPARED_Q in s.sess._prepared)
    p.run("set workmem = 1073741824")
    assert not p.probe(lambda s: bool(s.sess._prepared))
    p.run(PREPARED_Q)
    assert p.probe(lambda s: PREPARED_Q in s.sess._prepared)
    p.run("alter table t add column c int")
    assert not p.probe(lambda s: bool(s.sess._prepared))


def test_prepared_skipped_inside_transaction():
    p = _prepared_pair(100)
    p.run(PREPARED_Q)
    p.run("begin")
    try:
        out = []
        ev = _events(lambda: out.append(p.run(PREPARED_Q)))
        assert "sql.prepared_hit" not in ev, ev
        assert _col(out[0], "sb") == _sb(np.arange(100) % 7,
                                         np.arange(100))
    finally:
        p.run("rollback")


def test_prepared_cache_is_shared_by_the_catalogs_sessions():
    p = _prepared_pair(100)
    first = p.run(PREPARED_Q)
    ev = _events(lambda: p.run(PREPARED_Q, other=True))
    assert ev.get("sql.prepared_hit") == 1, ev
    assert p.run(PREPARED_Q, other=True) == first


def test_exec_cache_respects_snapshot_and_version_keys():
    """A direct flow over the store, no session: re-collecting the same
    op reads its pinned snapshot; an op built after a write sees it."""
    from cockroach_tpu_torch.coldata.batch import INT, Field, Schema
    from cockroach_tpu_torch.exec import collect
    from cockroach_tpu_torch.exec.operators import HashAggOp
    from cockroach_tpu_torch.ops.agg import AggSpec

    store = TMVCCStore(engine=TPyEngine(), clock=THLC(TManualClock(1000)),
                       device="cpu")
    tid = 7
    store.ingest_table(tid, list(range(50)),
                       {"v": np.arange(50, dtype=np.int64)})
    schema = Schema([Field("v", INT)])

    def flow():
        return HashAggOp(store.scan_op(tid, schema, 32), [],
                         [AggSpec("sum", "v", "s")])

    op = flow()
    r1 = collect(op, device="cpu")
    r2 = collect(op, device="cpu")
    assert r1["s"][0] == r2["s"][0] == np.arange(50).sum()
    store.put(tid, 50, [1000])
    assert collect(op, device="cpu")["s"][0] == np.arange(50).sum()
    assert collect(flow(), device="cpu")["s"][0] == \
        np.arange(50).sum() + 1000


# ------------------------------------------------ the logic corpus reader

def test_corpus_reader_matches_test_logic():
    """chip_smoke.py's `parse_corpus`, which the port's corpus tests and
    phase 13 read the files with, gives tests/test_logic.py's blocks."""
    import chip_smoke
    from test_logic import parse_blocks

    for path in chip_smoke.corpus_files():
        with open(path) as f:
            text = f.read()
        assert chip_smoke.parse_corpus(text) == parse_blocks(text), path
