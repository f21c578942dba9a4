"""The cross-session serving queue (sql/serving.py) and its batched
runners (exec/fused.py) against the JAX package's, on the CPU.

- The runners: each runner class of both packages over the same numpy
  arrays, bit for bit (NULLs, ASC and DESC, contiguous and sparse keys,
  an empty table, B = 0, 1, 3 and a padded bucket, avg), and the
  resident runner over both packages' resident tiers.
- The matchers: each matcher of both packages on the same text over
  equal catalogs (the port's carried from the JAX one with
  coldata/carry.py `carry_session_store`), with equal BatchSpec fields.
- The cases of tests/test_serving.py and the serving cases of
  tests/test_resident.py (:301-388) on the port, each answer equal to
  the JAX package's serial answer over the equal catalog, and each
  SQLSTATE the JAX test's. Coalescing is made deterministic: the leader
  holds a long window open (the queue's in-flight count is held above
  one), `sql.serving.max_batch` equals the number of members, and the
  members start at a barrier, so a batch flushes because it is full,
  never by timing.
"""

import threading
import time

import numpy as np
import pytest

from cockroach_tpu.exec import fused as jfused
from cockroach_tpu.sql import parser as JP
from cockroach_tpu.sql import serving as jserving
from cockroach_tpu.sql.session import Session as JSession
from cockroach_tpu.sql.session import SessionCatalog as JSessionCatalog
from cockroach_tpu.storage import resident as jresident
from cockroach_tpu.storage.engine import PyEngine as JPyEngine
from cockroach_tpu.storage.mvcc import MVCCStore as JMVCCStore
from cockroach_tpu.util.hlc import HLC as JHLC, ManualClock as JClock
from cockroach_tpu.util.settings import Settings as JSettings
from cockroach_tpu_torch.coldata.carry import carry_session_store
from cockroach_tpu_torch.exec import fused as tfused
from cockroach_tpu_torch.exec import stats as tstats
from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
from cockroach_tpu_torch.sql import parser as TP
from cockroach_tpu_torch.sql import serving
from cockroach_tpu_torch.sql.session import Session, SessionCatalog, SQLError
from cockroach_tpu_torch.storage import resident as tresident
from cockroach_tpu_torch.storage.engine import PyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util import fault as tfault
from cockroach_tpu_torch.util.admission import SESSION_SLOTS, session_queue
from cockroach_tpu_torch.util.hlc import HLC, ManualClock
from cockroach_tpu_torch.util.retry import RESILIENCE_INITIAL_BACKOFF
from cockroach_tpu_torch.util.settings import Settings
from torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 256
WARM_Q = "select pk, v from t where pk >= 16 and pk < 56 order by pk"
AGG_Q = ("select count(*) as c, sum(v) as s from t "
         "where pk >= 16 and pk < 56")


# ------------------------------------------------------------ catalogs --

def _fill(sess, n_rows=N_ROWS, nulls=False):
    sess.execute("create table t (pk int primary key, v int)")
    sess.execute("insert into t values " + ", ".join(
        "(%d, %d)" % (pk, 37 * pk % 1009) for pk in range(n_rows)))
    if not nulls:
        return
    sess.execute("create table n (pk int primary key, v int, w int)")
    sess.execute("insert into n values " + ", ".join(
        "(%d, %s, %d)" % (pk, "null" if pk % 5 == 0
                          else str(13 * pk % 97), (pk * 7) % 41)
        for pk in range(n_rows)))
    sess.execute("create table e (id int primary key, v vector(4))")
    sess.execute("insert into e values " + ", ".join(
        "(%d, %s)" % (i, "null" if i % 9 == 4 else
                      "'[%d,%d,%d,%d]'" % ((i % 7) - 3, (i % 5) - 2,
                                           i % 3, (i % 11) - 5))
        for i in range(48)))


class Pair:
    """Equal catalogs in both packages: the JAX SessionCatalog written
    by its session, the port's carried from its store."""

    def __init__(self, nulls=False):
        self.jstore = JMVCCStore(engine=JPyEngine(),
                                 clock=JHLC(JClock(1000)))
        self.jcat = JSessionCatalog(self.jstore)
        _fill(JSession(self.jcat, capacity=256), nulls=nulls)
        self.cat = SessionCatalog(carry_session_store(self.jstore,
                                                      device="cpu"))
        self._jsess = None

    def session(self):
        return Session(self.cat, capacity=256, device="cpu")

    def jax_rows(self, sql):
        """The JAX package's serial answer (its serving off)."""
        js = JSettings()
        prev = js.get(jserving.SERVING_ENABLED)
        js.set(jserving.SERVING_ENABLED, False)
        try:
            if self._jsess is None:
                self._jsess = JSession(self.jcat, capacity=256)
            _k, payload, _s = self._jsess.execute(sql)
        finally:
            js.set(jserving.SERVING_ENABLED, prev)
        return _lists(payload)


def _lists(payload):
    return {k: np.asarray(a).tolist() for k, a in payload.items()}


_PAIRS = {}


def _pair(nulls=False) -> Pair:
    """One Pair a module (the tests never write to it)."""
    if nulls not in _PAIRS:
        _PAIRS[nulls] = Pair(nulls)
    return _PAIRS[nulls]


@pytest.fixture(autouse=True)
def _serving_hygiene():
    s = Settings()
    keys = (serving.SERVING_ENABLED, serving.COALESCE_WINDOW_MS,
            serving.MAX_BATCH, SESSION_SLOTS, RESILIENCE_INITIAL_BACKOFF)
    prev = {k: s.get(k) for k in keys}
    s.set(serving.SERVING_ENABLED, True)
    s.set(RESILIENCE_INITIAL_BACKOFF, 0.0)
    q = serving.serving_queue()
    with q._runners_mu:
        q._runners.clear()
    yield
    for k, v in prev.items():
        s.set(k, v)
    tfault.registry().disarm()
    tcircuit.reset_all()


def _deltas(before, after):
    return {k: after[k] - before[k]
            for k in ("batched_dispatch_total", "coalesced_statements",
                      "fallbacks", "dispatches")}


def _warm(sess, sql):
    sess.execute(sql)
    return sess.execute(sql)


def _hold_window_open():
    q = serving.serving_queue()
    with q._mu:
        q._inflight += 1

    def release():
        with q._mu:
            q._inflight -= 1

    return q, release


def _wait_for_members(q, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with q._mu:
            if sum(len(g) for g in q._groups.values()) >= n:
                return
        time.sleep(0.002)
    raise AssertionError("window never reached %d members" % n)


def _coalesce(sessions, queries, max_batch=None, window_ms=5000.0):
    """Each session executes its query once, all in ONE batch per
    compatibility group: the members start together, the leader's window
    is long, and max_batch is the size of every group (by default, all
    members are one group), so each group flushes because it is full.
    -> [(kind, payload-lists or pgcode)]."""
    s = Settings()
    s.set(serving.COALESCE_WINDOW_MS, window_ms)
    s.set(serving.MAX_BATCH, max_batch or len(sessions))
    out = [None] * len(sessions)
    gate = threading.Barrier(len(sessions))

    def worker(i):
        gate.wait(30)
        try:
            _k, payload, _s = sessions[i].execute(queries[i])
            out[i] = ("rows", _lists(payload))
        except SQLError as e:
            out[i] = ("err", e.pgcode)

    q, release = _hold_window_open()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(sessions))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        release()
    assert not any(t.is_alive() for t in threads)
    return out


# --------------------------------------------------------------- runners --

def _table(rng, n, sparse):
    pks = (np.sort(rng.choice(8 * max(n, 1), n, replace=False)) if sparse
           else np.arange(5, 5 + n))
    cols = {"a": rng.integers(-40, 40, n),
            "b": rng.integers(-2**62, 2**62, n)}
    valids = {"a": rng.random(n) > 0.2, "b": np.ones(n, bool)}
    return pks.astype(np.int64), cols, valids


def _lanes(rng, pks, b):
    top = int(pks[-1]) if len(pks) else 10
    los = rng.integers(-3, top + 3, b)
    his = los + rng.integers(0, 200, b)
    his[:1] = los[:1]           # an empty range
    lims = rng.choice([128, 3, 0, 1, 7], b)
    return los, his, lims


def _rows_equal(want, got):
    assert len(want) == len(got) == 3
    for x, y in zip(want, got):
        assert x.shape == y.shape and x.dtype == y.dtype
    for i in range(len(want[2])):
        c = int(want[2][i])
        assert int(got[2][i]) == c
        assert np.array_equal(want[0][i][:, :c], got[0][i][:, :c])
        assert np.array_equal(want[1][i][:, :c], got[1][i][:, :c])


CASES = [(n, sparse, b) for n in (0, 1, 300) for sparse in (False, True)
         for b in (0, 1, 3, 5)]


@pytest.mark.parametrize("n,sparse,b", CASES)
def test_scan_and_topk_runners_equal_jax(n, sparse, b):
    rng = np.random.default_rng(n * 10 + b + int(sparse))
    pks, cols, valids = _table(rng, n, sparse)
    los, his, lims = _lanes(rng, pks, b)
    _rows_equal(jfused.ServingScanRunner(pks, cols, valids, 128)
                .run(los, his, lims),
                tfused.ServingScanRunner(pks, cols, valids, 128,
                                         device="cpu").run(los, his, lims))
    for desc in (False, True):
        for oc in ("a", "b"):
            args = (pks, cols, valids, cols[oc], valids[oc], desc, 256)
            _rows_equal(jfused.ServingTopKRunner(*args).run(los, his, lims),
                        tfused.ServingTopKRunner(*args, device="cpu")
                        .run(los, his, lims))


@pytest.mark.parametrize("n,sparse,b", CASES)
def test_agg_runner_equal_jax(n, sparse, b):
    rng = np.random.default_rng(n * 10 + b + int(sparse) + 1)
    pks, cols, valids = _table(rng, n, sparse)
    los, his, _l = _lanes(rng, pks, b)
    aggs = (("count_star", None), ("count", "a"), ("sum", "b"),
            ("sum", "a"), ("avg", "a"), ("avg", "b"), ("min", "a"),
            ("max", "a"), ("min", "b"), ("max", "b"))
    names = tuple(f"x{i}" for i in range(len(aggs)))
    want = jfused.ServingAggRunner(pks, cols, valids, aggs, names,
                                   256).run(los, his)
    got = tfused.ServingAggRunner(pks, cols, valids, aggs, names, 256,
                                  device="cpu").run(los, his)
    for x, y in zip(want[0] + want[1], got[0] + got[1]):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))
    # only-count(*) aggregates carry no column
    only = (("count_star", None),)
    assert np.array_equal(
        np.asarray(jfused.ServingAggRunner(pks, cols, valids, only, ("c",),
                                           256).run(los, his)[0][0]),
        tfused.ServingAggRunner(pks, cols, valids, only, ("c",), 256,
                                device="cpu").run(los, his)[0][0])


@pytest.mark.parametrize("metric", ["l2", "cos"])
@pytest.mark.parametrize("n,b", [(0, 3), (5, 3), (48, 1), (300, 5),
                                 (300, 0)])
def test_vector_runner_equal_jax(metric, n, b):
    rng = np.random.default_rng(n + b)
    pks, cols, valids = _table(rng, n, False)
    # integer lanes: every distance is exact in float32 in both packages
    vecs = rng.integers(-5, 6, (n, 4)).astype(np.float32)
    vvalid = rng.random(n) > 0.15
    qs = rng.integers(-3, 4, (b, 4)).astype(np.float32)
    for k in (1, 7):
        want = jfused.ServingVectorRunner(pks, cols, valids, vecs, vvalid,
                                          metric, k).run(qs)
        got = tfused.ServingVectorRunner(pks, cols, valids, vecs, vvalid,
                                         metric, k, device="cpu").run(qs)
        for x, y in zip(want, got):
            x = np.asarray(x)
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_bucket_records_count_shapes_as_jax():
    rng = np.random.default_rng(2)
    pks, cols, valids = _table(rng, 100, False)
    j = jfused.ServingScanRunner(pks, cols, valids, 128)
    t = tfused.ServingScanRunner(pks, cols, valids, 128, device="cpu")
    for r in (j, t):
        for b in (1, 2, 3, 5, 8, 1):
            r.prewarm_batch(b)
    assert t._batched._cache_size() == j._batched._cache_size() == 4
    assert t.compile_bucket(9) and j.compile_bucket(9)
    assert t._batched._cache_size() == j._batched._cache_size() == 5
    empty = tfused.ServingScanRunner(pks[:0], {c: v[:0] for c, v in
                                               cols.items()},
                                     {c: v[:0] for c, v in valids.items()},
                                     128, device="cpu")
    assert empty.compile_bucket(4) is False and empty._batched is None


# -------------------------------------------------------------- matchers --

MATCH_TEXTS = [
    WARM_Q, AGG_Q,
    "select v from t where pk >= 3 and pk < 90 limit 7",
    "select pk from t where pk = 5 order by pk asc",
    "select pk from t where 5 <= pk and pk <= 9",
    "select pk from t where pk > 5 and pk < 6",
    "select pk, v from t where pk >= 16 and pk < 80 order by v limit 5",
    "select pk from t where pk >= 0 and pk < 40 order by v desc limit 3",
    "select pk from t where pk >= 0 and pk < 40 order by v",
    "select count(*), count(v) from t where pk >= 16 and pk < 56",
    "select count(*) as c from t",
    "select count(*) as c from t where pk >= 0 and pk < 9 limit 2",
    "select sum(v + 1) as s from t where pk >= 0 and pk < 9",
    "select pk, count(*) as c from t where pk >= 0 and pk < 9",
    "select pk, sum(v) as s from t where pk < 9 group by pk",
    "select pk, v from t",
    "select pk, v from t where v >= 3 and v < 9",
    "select pk, v from t where pk >= 3 and pk < 9 order by pk desc",
    "select pk, v as alias from t where pk >= 3 and pk < 9",
    "select pk, pk from t where pk >= 3 and pk < 9",
    "select distinct pk from t where pk >= 3 and pk < 9",
    "select pk from t where pk >= 3 and pk < 9 offset 2",
    "select pk from t where pk >= 0 and pk < 100000",
    "select pk from t where pk >= 3.5 and pk < 9",
    "select count(*) as c, count(v) as cv, sum(v) as s, min(v) as mn, "
    "max(v) as mx, avg(v) as a from n where pk >= 10 and pk < 90",
    "select pk, v from n where pk >= 30 and pk < 170 order by w desc "
    "limit 9",
    "select id from e order by v <-> '[0,1,0,2]' limit 4",
    "select id from e order by v <=> '[1,0,0,0]' limit 2",
    "select id from e order by v <-> '[1,0]' limit 4",
    "select id from e where id >= 0 and id < 9 "
    "order by v <-> '[0,1,0,2]' limit 4",
    "select id from e order by v <-> '[0,1,0,2]'",
    "select id from nope where id = 1",
]
FIELDS = ("kind", "table", "cols", "lo", "hi", "limit", "window",
          "order_col", "descending", "aggs", "names", "vcol", "metric",
          "shape_key")


@pytest.mark.parametrize("ann", [False, True])
def test_matchers_equal_jax(ann):
    from cockroach_tpu.util.settings import VECTOR_ANN as JVECTOR_ANN
    from cockroach_tpu_torch.util.settings import VECTOR_ANN

    pair = _pair(nulls=True)
    js, ts = JSettings(), Settings()
    prev = (js.get(JVECTOR_ANN), ts.get(VECTOR_ANN))
    js.set(JVECTOR_ANN, ann)
    ts.set(VECTOR_ANN, ann)
    try:
        matched = 0
        for sql in MATCH_TEXTS:
            want = jserving.match_batchable(JP.parse(sql), pair.jcat, 256)
            got = serving.match_batchable(TP.parse(sql), pair.cat, 256)
            assert (want is None) == (got is None), sql
            if want is None:
                continue
            matched += 1
            for f in FIELDS:
                assert getattr(got, f) == getattr(want, f), (sql, f)
            if want.qvec is None:
                assert got.qvec is None
            else:
                assert got.qvec.dtype == want.qvec.dtype
                assert np.array_equal(got.qvec, want.qvec)
        assert matched == (10 if ann else 12)
    finally:
        js.set(JVECTOR_ANN, prev[0])
        ts.set(VECTOR_ANN, prev[1])


def test_pk_bounds_range_window_and_schema_equal_jax():
    pk_texts = ["pk >= 3 and pk < 9", "pk > 3 and pk <= 9", "pk = 4",
                "3 < pk and 9 >= pk", "pk >= 3 and pk >= 5 and pk < 4",
                "pk >= 3", "pk < 3 or pk > 5", "v >= 3 and pk < 5"]
    for w in pk_texts:
        sql = f"select pk from t where {w}"
        assert serving._pk_bounds(TP.parse(sql).where, "pk") == \
            jserving._pk_bounds(JP.parse(sql).where, "pk"), w
    for span, eff in ((0, 0), (1, 1), (2, 2), (40, 7), (200, 200),
                      (1024, 1024), (1025, 10)):
        assert serving._range_window(span, eff) == \
            jserving._range_window(span, eff)
    pair = _pair(nulls=True)
    for sql in (MATCH_TEXTS[1], MATCH_TEXTS[24], WARM_Q):
        want = jserving.spec_schema(jserving.match_batchable(
            JP.parse(sql), pair.jcat, 256))
        got = serving.spec_schema(serving.match_batchable(
            TP.parse(sql), pair.cat, 256))
        assert [(f.name, f.type.kind.name) for f in got] == \
            [(f.name, f.type.kind.name) for f in want]


def test_match_bound_sql_and_probe():
    pair = _pair()
    sess = pair.session()
    spec = serving.match_bound_sql(sess, "  " + WARM_Q)
    assert spec is not None and spec.kind == "scan"
    assert serving.match_bound_sql(sess, "insert into t values (1, 2)") \
        is None
    assert serving.match_bound_sql(sess, "select broken from") is None
    assert not serving.probe(sess, WARM_Q + " ")
    Settings().set(serving.SERVING_ENABLED, False)
    assert serving.match_bound_sql(sess, WARM_Q) is None


# ------------------------------------------------- the test_serving cases --

def test_prepared_cache_is_shared_across_sessions():
    pair = _pair()
    a = pair.session()
    _, ref, _ = _warm(a, WARM_Q)
    b = pair.session()
    # B never ran the statement, yet A's warmth makes it serving-bound
    assert serving.probe(b, WARM_Q)
    st = tstats.enable()
    try:
        _, got, _ = b.execute(WARM_Q)
    finally:
        tstats.disable()
    d = st.as_dict()
    assert d["sql.prepared_hit"]["events"] == 1, d
    assert _lists(got) == _lists(ref) == pair.jax_rows(WARM_Q)


def test_lone_client_skips_coalesce_window():
    Settings().set(serving.COALESCE_WINDOW_MS, 500.0)
    pair = _pair()
    sess = pair.session()
    _warm(sess, WARM_Q)
    before = serving.serving_queue().snapshot()
    t0 = time.monotonic()
    _, payload, _ = sess.execute(WARM_Q)
    elapsed = time.monotonic() - t0
    d = _deltas(before, serving.serving_queue().snapshot())
    assert elapsed < 0.25, elapsed
    assert d["batched_dispatch_total"] == 1 and d["fallbacks"] == 0, d
    assert _lists(payload) == pair.jax_rows(WARM_Q)


def test_batched_bit_identical_under_faults():
    """Six sessions in one batch per round, three rounds, with a p=0.2
    retryable fault armed on the dispatch: every answer equals the JAX
    package's serial one, and each round is ONE six-member dispatch."""
    pair = _pair()
    queries = ["select pk, v from t where pk >= %d and pk < %d "
               "order by pk" % (lo, lo + 11 + 3 * i)
               for i, lo in enumerate(range(0, 120, 20))]
    ref = {q: pair.jax_rows(q) for q in queries}
    sessions = [pair.session() for _ in queries]
    for s, q in zip(sessions, queries):
        _warm(s, q)
    tfault.registry().arm("fused.exec", probability=0.2,
                          make=lambda: ConnectionError("transfer failed"))
    try:
        for r in range(3):
            # the prepared cache is the catalog's: any session is warm
            rot = queries[r:] + queries[:r]
            before = serving.serving_queue().snapshot()
            out = _coalesce(sessions, rot)
            d = _deltas(before, serving.serving_queue().snapshot())
            assert [o[1] for o in out] == [ref[q] for q in rot]
            # one dispatch of all six, or (a fault outlasting its retries)
            # none and six members served serially
            assert d["batched_dispatch_total"] <= 1, d
            assert d["coalesced_statements"] + d["fallbacks"] == 6, d
    finally:
        tfault.registry().disarm()


def test_cancelled_member_leaves_batch_unharmed():
    """A cancel against ONE member mid-window (scan, then aggregate
    batches): that statement gets its 57014, every other member of the
    batch its rows."""
    pair = _pair()
    Settings().set(serving.COALESCE_WINDOW_MS, 2000.0)
    for sql in (WARM_Q, AGG_Q):
        sessions = [pair.session() for _ in range(3)]
        for sess in sessions:
            _warm(sess, sql)
        before = serving.serving_queue().snapshot()
        results = [None] * 3

        def worker(i):
            try:
                _, payload, _ = sessions[i].execute(sql)
                results[i] = ("rows", _lists(payload))
            except SQLError as e:
                results[i] = ("err", e.pgcode)

        q, release = _hold_window_open()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        try:
            threads[0].start()
            _wait_for_members(q, 1)
            threads[1].start()
            threads[2].start()
            _wait_for_members(q, 3)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if sessions[1].cancel_query("mid-batch cancel"):
                    break
                time.sleep(0.01)
            for t in threads:
                t.join(30)
        finally:
            release()
        assert not any(t.is_alive() for t in threads)
        want = ("rows", pair.jax_rows(sql))
        assert results[1] == ("err", "57014"), results
        assert results[0] == want and results[2] == want, results
        d = _deltas(before, serving.serving_queue().snapshot())
        assert d["batched_dispatch_total"] >= 1, d
        _, payload, _ = sessions[1].execute(sql)
        assert _lists(payload) == want[1]


def test_drain_cancel_flushes_window_without_stranding():
    pair = _pair()
    Settings().set(serving.COALESCE_WINDOW_MS, 5000.0)
    sessions = [pair.session() for _ in range(2)]
    for sess in sessions:
        _warm(sess, WARM_Q)
    results = [None] * 2

    def worker(i):
        try:
            sessions[i].execute(WARM_Q)
            results[i] = ("rows", None)
        except SQLError as e:
            results[i] = ("err", e.pgcode)

    q, release = _hold_window_open()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2)]
    try:
        for t in threads:
            t.start()
        _wait_for_members(q, 2)
        t0 = time.monotonic()
        for sess in sessions:
            sess.cancel_query("server draining")
        for t in threads:
            t.join(10)
        elapsed = time.monotonic() - t0
    finally:
        release()
    assert not any(t.is_alive() for t in threads)
    assert results == [("err", "57014")] * 2, results
    assert elapsed < 3.0, elapsed


def test_prewarm_fills_every_pow2_bucket():
    pair = _pair()
    sess = pair.session()
    _warm(sess, WARM_Q)
    sess.execute(WARM_Q)
    q = serving.serving_queue()
    with q._runners_mu:
        runners = list(q._runners.values())
    assert len(runners) == 1
    assert q.prewarm(max_batch=8) == 4
    n_before = runners[0]._batched._cache_size()
    assert n_before == 4
    for b in range(1, 9):
        z = np.zeros(b, dtype=np.int64)
        runners[0].run(z, z, np.full(b, runners[0].window, np.int64))
    assert runners[0]._batched._cache_size() == n_before
    # the pre-warm job's entries: the runner's shape as a task, and a
    # shape pre-warmed from it at the table's current version
    tasks = q.prewarm_tasks(max_batch=8, capacity=256)
    assert tasks == [{"kind": "serving", "class": "scan", "table": "t",
                      "buckets": [1, 2, 4, 8], "cols": ["pk", "v"],
                      "window": 128, "capacity": 256}]
    assert q.prewarm_shape(pair.cat, 256, "t", ("pk", "v"), 128,
                           [1, 2, 16], device="cpu") == 3


def test_occupancy_counts_padding_as_dispatched():
    pair = _pair()
    sessions = [pair.session() for _ in range(3)]
    queries = ["select pk, v from t where pk >= %d and pk < %d order by pk"
               % (lo, lo + 9) for lo in (3, 30, 60)]
    for s, sql in zip(sessions, queries):
        _warm(s, sql)
    q = serving.serving_queue()
    ops0, slots0 = q.ops_submitted, q.slots_dispatched
    out = _coalesce(sessions, queries)
    assert [o[1] for o in out] == [pair.jax_rows(sql) for sql in queries]
    assert (q.ops_submitted - ops0, q.slots_dispatched - slots0) == (3, 4)
    jq = jserving.ServingQueue.__new__(jserving.ServingQueue)
    tq = serving.ServingQueue.__new__(serving.ServingQueue)
    for x in (jq, tq):
        x.ops_submitted, x.slots_dispatched = 3, 4
    assert tq.occupancy() == jq.occupancy() == pytest.approx(0.75)


def test_admission_wait_slice_respects_statement_deadline():
    pair = _pair()
    sess = pair.session()
    Settings().set(SESSION_SLOTS, 1)
    queue = session_queue()
    queue.acquire(timeout=5.0)
    try:
        sess.execute("set statement_timeout = 0.02")
        t0 = time.monotonic()
        with pytest.raises(SQLError) as ei:
            sess.execute("select pk, sum(v) as s from t where pk < 50 "
                         "group by pk")
        assert ei.value.pgcode == "57014"
        assert time.monotonic() - t0 < 0.5
    finally:
        queue.release()


def test_mixed_classes_group_separately():
    """One table, three classes in the same window: members group per
    (class, shape, version, device) key, never in one group, and each
    class's demux returns its own statement's payload."""
    pair = _pair()
    queries = [WARM_Q, AGG_Q,
               "select pk, v from t where pk >= 16 and pk < 56 "
               "order by v limit 5"]
    sessions = [pair.session() for _ in queries]
    for s, sql in zip(sessions, queries):
        _warm(s, sql)
    Settings().set(serving.COALESCE_WINDOW_MS, 2000.0)
    results = [None] * 3

    def worker(i):
        _, payload, _ = sessions[i].execute(queries[i])
        results[i] = _lists(payload)

    q, release = _hold_window_open()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(3)]
    try:
        for t in threads:
            t.start()
        _wait_for_members(q, 3)
        with q._mu:
            keys = list(q._groups.keys())
        for t in threads:
            t.join(30)
    finally:
        release()
    assert len(keys) == 3 and {k[0] for k in keys} == {"scan", "agg",
                                                        "topk"}
    # the device rides every key
    assert {k[-1] for k in keys} == {("cpu", None)}
    assert results == [pair.jax_rows(sql) for sql in queries]


def test_adaptive_window_is_per_class():
    s, js = Settings(), JSettings()
    s.set(serving.COALESCE_WINDOW_MS, -1.0)
    q = serving.ServingQueue()
    jq = jserving.ServingQueue()
    prev = js.get(jserving.COALESCE_WINDOW_MS)
    js.set(jserving.COALESCE_WINDOW_MS, -1.0)
    try:
        for x in (q, jq):
            for i in range(64):
                x._observe_arrival("scan", 10.0 + i * 1e-4)
            for i in range(4):
                x._observe_arrival("vector", 10.0 + i * 5e-2)
        for cls in ("scan", "agg", "vector"):
            assert q.effective_window_s(cls) == jq.effective_window_s(cls)
        # the counters are the process's metric registry's; the windows
        # are each queue's own
        snap, jsnap = q.snapshot()["classes"], jq.snapshot()["classes"]
        for cls in serving.CLASSES:
            for f in ("coalesce_window_ms", "ewma_interarrival_ms"):
                assert snap[cls][f] == jsnap[cls][f], (cls, f)
        assert snap["scan"]["ewma_interarrival_ms"] == pytest.approx(0.1)
    finally:
        js.set(jserving.COALESCE_WINDOW_MS, prev)


def test_new_classes_bit_identical_concurrent_with_nulls():
    """agg/topk/vector members coalescing — NULL values and embeddings,
    empty and point ranges, DESC, a NULLable order column, both metrics —
    each class in one full batch, every answer the JAX package's serial
    one, no fallback."""
    pair = _pair(nulls=True)
    agg_sel = ("select count(*) as c, count(v) as cv, sum(v) as s, "
               "min(v) as mn, max(v) as mx, avg(v) as a from n "
               "where pk >= %d and pk < %d")
    # (class, texts, members per compatibility group): the aggregates
    # form two groups, window 128 and the window-1 point/empty ranges
    groups = [
        ("agg", [agg_sel % (10, 90), agg_sel % (50, 60),
                 agg_sel % (40, 41), agg_sel % (200, 200)], 2),
        ("topk", ["select pk, v from n where pk >= 0 and pk < 100 "
                  "order by w limit 7",
                  "select pk, v from n where pk >= 5 and pk < 105 "
                  "order by w limit 4",
                  "select pk, v from n where pk >= 0 and pk < 100 "
                  "order by w limit 9"], 3),
        ("vector", ["select id from e order by v <-> '[0,1,0,2]' limit 5",
                    "select id from e order by v <-> '[1,-1,2,0]' limit 5",
                    "select id from e order by v <-> '[3,1,0,-2]' limit 5"],
         3),
    ]
    singles = ["select pk, v from n where pk >= 30 and pk < 170 "
               "order by w desc limit 9",
               "select pk, w from n where pk >= 0 and pk < 120 "
               "order by v limit 6",
               "select id from e order by v <=> '[1,-1,2,0]' limit 4"]
    for cls, queries, size in groups:
        sessions = [pair.session() for _ in queries]
        for s, sql in zip(sessions, queries):
            _warm(s, sql)
        before = serving.serving_queue().snapshot()["classes"][cls]
        out = _coalesce(sessions, queries, max_batch=size)
        after = serving.serving_queue().snapshot()["classes"][cls]
        assert out == [("rows", pair.jax_rows(sql)) for sql in queries], cls
        assert after["batched_dispatch_total"] \
            - before["batched_dispatch_total"] == len(queries) // size, cls
        assert after["coalesced_statements"] \
            - before["coalesced_statements"] == len(queries), cls
        assert after["fallbacks"] == before["fallbacks"], cls
    sess = pair.session()
    for sql in singles:
        _warm(sess, sql)
        _, payload, _ = sess.execute(sql)
        assert _lists(payload) == pair.jax_rows(sql), sql


def test_batch_failure_degrades_members_to_serial():
    """A fault past the retries fails the batch: its members run the
    serial path on their own device and still answer; the fallbacks are
    counted, and an EXECUTE member's fallback is an insight."""
    from cockroach_tpu_torch.sql.insights import default_insights

    pair = _pair()
    sessions = [pair.session() for _ in range(2)]
    for s in sessions:
        _warm(s, WARM_Q)
    # one terminal fault: the batch's dispatch takes it, the members'
    # serial runs do not
    tfault.registry().arm("fused.exec", after=0,
                          make=lambda: RuntimeError("boom"))
    before = serving.serving_queue().snapshot()
    try:
        out = _coalesce(sessions, [WARM_Q, WARM_Q])
    finally:
        tfault.registry().disarm()
    assert out == [("rows", pair.jax_rows(WARM_Q))] * 2, out
    d = _deltas(before, serving.serving_queue().snapshot())
    assert d["fallbacks"] == 2 and d["batched_dispatch_total"] == 0, d
    spec = serving.match_bound_sql(sessions[0], WARM_Q)
    tfault.registry().arm("fused.exec", after=0,
                          make=lambda: RuntimeError("boom"))
    try:
        assert sessions[0].execute_spec(spec, WARM_Q) is None
    finally:
        tfault.registry().disarm()
    kinds = [i["kinds"] for i in default_insights().insights()]
    assert any("batch_fallback" in k for k in kinds)
    assert _lists(sessions[0].execute_spec(spec, WARM_Q)[1]) == \
        pair.jax_rows(WARM_Q)


def test_vtable_serving_batches_equal_jax_columns():
    from cockroach_tpu.sql import vtable as jvtable
    from cockroach_tpu_torch.sql import vtable as tvtable

    rows = tvtable._rows_serving_batches()
    assert [r["batch_class"] for r in rows] == sorted(
        serving.CLASSES + ("execute",))
    jcols = [c for c, _t, _n in jvtable.TABLES["serving_batches"][0]]
    assert all(list(r) == jcols for r in rows)


# ------------------------------------------ the serving cases of resident --

@pytest.fixture
def resident_on():
    s, js = Settings(), JSettings()
    prev = (s.get(tresident.RESIDENT_SCAN), js.get(jresident.RESIDENT_SCAN))
    s.set(tresident.RESIDENT_SCAN, True)
    js.set(jresident.RESIDENT_SCAN, True)
    yield
    s.set(tresident.RESIDENT_SCAN, prev[0])
    js.set(jresident.RESIDENT_SCAN, prev[1])
    tresident.reset()
    jresident.reset()
    scan_image_cache().clear()


def _resident_sessions():
    jstore = JMVCCStore(engine=JPyEngine())
    js = JSession(JSessionCatalog(jstore), capacity=256)
    store = MVCCStore(engine=PyEngine(), device="cpu")
    ts = Session(SessionCatalog(store), capacity=256, device="cpu")
    return (jstore, js), (store, ts)


def _both(sides, sql):
    out = []
    for _store, s in sides:
        _k, payload, _s = s.execute(sql)
        out.append(_lists(payload))
    assert out[0] == out[1], sql
    return out[1]


def test_serving_runner_stays_warm_across_writes(resident_on):
    sides = _resident_sessions()
    for _st, s in sides:
        s.execute("create table w (pk int primary key, v int)")
        for i in range(64):
            s.execute(f"insert into w values ({i}, {i * 3})")
    q = "select v from w where pk >= 8 and pk < 24 order by pk asc"
    _both(sides, q)
    _both(sides, q)
    sq = serving.serving_queue()
    runners = {k: r for k, r in sq._runners.items()
               if getattr(r, "table", None) == "w"}
    (rkey, runner), = runners.items()
    assert isinstance(runner, tfused.ResidentServingRunner)
    for _st, s in sides:
        s.execute("update w set v = -5 where pk = 9")
    got = _both(sides, q)
    want = [i * 3 for i in range(8, 24)]
    want[1] = -5
    assert got["v"] == want
    assert sq._runners.get(rkey) is runner


def test_pk_projection_serving_sees_writes(resident_on):
    sides = _resident_sessions()
    for _st, s in sides:
        s.execute("create table k (pk int primary key, v int)")
        for i in range(32):
            s.execute(f"insert into k values ({i}, {i * 2})")
    q = "select pk, v from k where pk >= 4 and pk < 12 order by pk asc"
    _both(sides, q)
    _both(sides, q)
    runners = [r for r in serving.serving_queue()._runners.values()
               if getattr(r, "table", None) == "k"]
    assert runners and all(isinstance(r, tfused.ResidentServingRunner)
                           for r in runners)
    for _st, s in sides:
        s.execute("update k set v = -7 where pk = 5")
        s.execute("delete from k where pk = 8")
    got = _both(sides, q)
    assert got["pk"] == [4, 5, 6, 7, 9, 10, 11]
    assert got["v"] == [8, -7, 12, 14, 18, 20, 22]


def test_point_lookup_rides_serving(resident_on):
    sides = _resident_sessions()
    for _st, s in sides:
        s.execute("create table p (pk int primary key, v int)")
        for i in range(32):
            s.execute(f"insert into p values ({i}, {i + 100})")
    q = "select v from p where pk = 11"
    _both(sides, q)
    before = serving.serving_queue().dispatches
    assert _both(sides, q)["v"] == [111]
    assert serving.serving_queue().dispatches == before + 1


def test_detach_recovers_host_serving(resident_on):
    sides = _resident_sessions()
    for _st, s in sides:
        s.execute("create table d (pk int primary key, v int)")
        for i in range(16):
            s.execute(f"insert into d values ({i}, {i})")
    q = "select v from d where pk >= 0 and pk < 8 order by pk asc"
    _both(sides, q)
    _both(sides, q)
    (jstore, js), (store, ts) = sides
    jresident.detach(jstore, js.catalog.desc("d").table_id)
    tresident.detach(store, ts.catalog.desc("d").table_id)
    Settings().set(tresident.RESIDENT_SCAN, False)
    JSettings().set(jresident.RESIDENT_SCAN, False)
    assert _both(sides, q)["v"] == list(range(8))


def test_write_burst_keeps_one_runner_per_shape(resident_on):
    """Each write rotates the frozen-snapshot classes' version: their
    stale runners go at once, so the resident scan runner of the table
    stays cached (the same object) through a burst longer than the LRU."""
    store = MVCCStore(engine=PyEngine(), device="cpu")
    s = Session(SessionCatalog(store), capacity=256, device="cpu")
    s.execute("create table w (pk int primary key, v int)")
    s.execute("insert into w values " + ", ".join(
        "(%d, %d)" % (i, 3 * i) for i in range(64)))
    scan = "select v from w where pk >= 8 and pk < 24 order by pk asc"
    agg = "select count(*) as c, sum(v) as s from w where pk >= 0 and pk < 9"
    for q in (scan, agg):
        _warm(s, q)
    sq = serving.serving_queue()

    def runners(kind):
        return [r for k, r in sq._runners.items()
                if k[0] == kind and getattr(r, "table", None) == "w"]

    (scan_runner,) = runners("scan")
    total = 3 * sum(range(9))
    for i in range(serving._RUNNER_ENTRIES + 4):
        s.execute(f"insert into w values ({100 + i}, 1)")
        _k, p, _s = s.execute(agg)
        assert p["c"].tolist() == [9] and p["s"].tolist() == [total]
        assert len(runners("agg")) == 1
        _k, p, _s = s.execute(scan)
        assert p["v"].tolist() == [3 * i for i in range(8, 24)]
    assert runners("scan") == [scan_runner]
