"""TPC-H through the port's MVCC storage layer, against the JAX package.

At SF 0.01, capacity 2^12, the eight tables go into an MVCC store with
`mvcc_load` in each package (native engines). Q1, Q3, Q9 and Q18
through the port's MVCCCatalog equal the JAX package's
`collect(qN(gen, catalog=jax_mvcc_catalog))` on the streaming and the
fused tier; the fifteen `PLANS` through the port's MVCCCatalog equal the
port's generator-direct results; with `storage.resident_scan` on, the
queries read through the resident tier equal the host walk, and after a
write burst (puts that change l_quantity, l_extendedprice and
l_discount, and deletes) applied alike to the JAX store and to the port
store carried over from it (`coldata/carry.py` carry_store), the
resident and host-walk tiers agree with each other and with the JAX
package; a read pinned before the burst still sees the loaded rows.
Statistics persist through save_stats/load_stats with the JAX encoding's
bytes. Tolerance: exact for every column (integer, decimal, date,
dictionary code, float32 averages alike), row order included."""

import numpy as np
import pytest

from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.storage import MVCCStore as JStore
from cockroach_tpu.storage.engine import NativeEngine as JNative
from cockroach_tpu.util.hlc import HLC as JHLC
from cockroach_tpu.util.hlc import ManualClock as JManualClock
from cockroach_tpu.util.hlc import Timestamp as JTimestamp
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.coldata.carry import carry_store
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.scan_cache import scan_image_cache
from cockroach_tpu_torch.sql.plan import MVCCCatalog
from cockroach_tpu_torch.storage import MVCCStore, NativeEngine, resident
from cockroach_tpu_torch.util.hlc import HLC, ManualClock, Timestamp
from cockroach_tpu_torch.util.settings import Settings
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 12
Q18_THRESHOLD = 150
TABLES = ["lineitem", "orders", "customer", "part", "supplier",
          "partsupp", "nation", "region"]
PLAN_QUERIES = ("q1", "q2", "q3", "q4", "q5", "q6", "q9", "q10", "q12",
                "q14", "q15", "q16", "q17", "q18", "q19")
BURST_PUTS = 300
BURST_DELETES = 30


def _flow(mod, name, gen, catalog=None):
    if name == "q18":
        return mod.q18(gen, Q18_THRESHOLD, CAPACITY, catalog=catalog)
    return getattr(mod, name)(gen, CAPACITY, catalog=catalog)


@pytest.fixture(autouse=True)
def _hygiene():
    s = Settings()
    prev = s.get(resident.RESIDENT_SCAN)
    resident.reset()
    scan_image_cache().clear()
    yield
    s.set(resident.RESIDENT_SCAN, prev)
    resident.reset()
    scan_image_cache().clear()


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


@pytest.fixture(scope="module")
def catalogs(gens):
    jgen, tgen = gens
    jcat = jgen.mvcc_load(JStore(engine=JNative(),
                                 clock=JHLC(JManualClock(1000))), TABLES)
    tcat = tgen.mvcc_load(MVCCStore(engine=NativeEngine(),
                                    clock=HLC(ManualClock(1000)),
                                    device="cpu"), TABLES)
    return jcat, tcat


@pytest.mark.parametrize("fuse", [False, True], ids=["streaming", "fused"])
@pytest.mark.parametrize("name", ["q1", "q3", "q9", "q18"])
def test_query_through_mvcc_catalog_matches_jax(gens, catalogs, name, fuse):
    jgen, tgen = gens
    jcat, tcat = catalogs
    want = jcollect(_flow(jq, name, jgen, jcat), fuse=fuse)
    got = tcollect(_flow(tq, name, tgen, tcat), device="cpu", fuse=fuse)
    _assert_equal_results(want, got)


@pytest.mark.parametrize("name", PLAN_QUERIES)
def test_plans_through_mvcc_catalog_match_generator(gens, catalogs, name):
    _jgen, tgen = gens
    _jcat, tcat = catalogs
    want = tcollect(_flow(tq, name, tgen), device="cpu")
    got = tcollect(_flow(tq, name, tgen, tcat), device="cpu")
    _assert_equal_results(want, got)


def test_catalog_surface(gens, catalogs):
    from cockroach_tpu.sql.stats import TableStats as JStats

    _jgen, tgen = gens
    jcat, tcat = catalogs
    assert sorted(tcat.tables) == sorted(TABLES)
    for i, name in enumerate(TABLES):
        tid, schema = tcat.tables[name]
        assert tid == 10 + i == jcat.tables[name][0]
        assert schema.names() == [f.name for f in jcat.tables[name][1]]
        assert tcat.table_rows(name) == tgen.num_rows(name)
        assert tcat.table_pk(name) == jcat.table_pk(name)
        # the sampled statistics equal the JAX loader's, byte for byte
        assert tcat.table_stats(name).encode() == \
            jcat.table_stats(name).encode()
        assert isinstance(JStats.decode(tcat.table_stats(name).encode()),
                          JStats)
    key = tcat.scan_cache_key("lineitem", ["l_quantity"], CAPACITY)
    store = tcat.store
    assert key == store.scan_cache_prefix(10) + (
        store.table_version(10), CAPACITY, ("l_quantity",))
    flow = tq.q6(tgen, CAPACITY, catalog=tcat)
    from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators

    scans = [op for op in walk_operators(flow) if isinstance(op, ScanOp)]
    src = scans[0]._mvcc_src
    names = tcat.table_schema("lineitem").names()
    assert src[0] is store and src[1] == 10
    assert src[3] == tuple(names.index(c) for c in scans[0].schema.names())
    assert src[2] == tcat._scan_ts["lineitem"]


def test_stats_round_trip_matches_jax_bytes(catalogs):
    from cockroach_tpu.sql import stats as jstats

    from cockroach_tpu_torch.sql import stats as tstats

    jcat, tcat = catalogs
    st = tcat.table_stats("orders")
    assert tstats.stats_key(11) == jstats.stats_key(11)
    store = MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(5)))
    assert tstats.load_stats(store, 11) is None
    tstats.save_stats(store, 11, st)
    back = tstats.load_stats(store, 11)
    assert back == st
    assert back.encode() == jcat.table_stats("orders").encode()
    raw = store.engine.get(tstats.stats_key(11), Timestamp.MAX)[0]
    assert raw == jcat.table_stats("orders").encode()


# ------------------------------------------------- the resident tier --


def _resident_collect(flow, fuse):
    with stats.query_stats() as col:
        res = tcollect(flow, device="cpu", fuse=fuse)
    return res, col


@pytest.mark.parametrize("name", ["q1", "q3", "q6", "q18"])
def test_resident_tier_equals_host_walk(gens, catalogs, name):
    _jgen, tgen = gens
    _jcat, tcat = catalogs
    want = tcollect(_flow(tq, name, tgen, tcat), device="cpu")
    scan_image_cache().clear()
    Settings().set(resident.RESIDENT_SCAN, True)
    got, col = _resident_collect(_flow(tq, name, tgen, tcat), fuse=True)
    _assert_equal_results(want, got)
    assert col.stages["scan.resident"].events >= 1
    assert "scan.resident_fallback" not in col.stages
    assert resident.lookup(tcat.store, 10) is not None


def _burst(jstore, tstore, tcat, rng):
    """The same puts and deletes on both stores, at later timestamps:
    (pks put, pks deleted)."""
    tid, schema = tcat.tables["lineitem"]
    names = schema.names()
    cols = [names.index(c) for c in ("l_quantity", "l_extendedprice",
                                     "l_discount")]
    n = tcat.table_rows("lineitem")
    put_pks = rng.choice(n, BURST_PUTS, replace=False)
    del_pks = rng.choice(np.setdiff1d(np.arange(n), put_pks), BURST_DELETES,
                         replace=False)
    wall = 2000
    for pk in put_pks.tolist():
        row, _ts = tstore.get(tid, pk)
        row[cols[0]] = int(rng.integers(1, 51)) * 100
        row[cols[1]] = int(rng.integers(90_000, 10_000_000))
        row[cols[2]] = int(rng.integers(0, 11))
        tstore.put(tid, pk, row, ts=Timestamp(wall, 0))
        jstore.put(tid, pk, row, ts=JTimestamp(wall, 0))
        wall += 1
    for pk in del_pks.tolist():
        tstore.delete(tid, pk, ts=Timestamp(wall, 0))
        jstore.delete(tid, pk, ts=JTimestamp(wall, 0))
        wall += 1
    return put_pks, del_pks


def test_resident_after_write_burst_matches_jax(gens, catalogs):
    """The JAX store and the port store carried over from it take the
    same burst; the port's resident tier (folded deltas), its host walk
    and the JAX package agree on Q1, Q6 and Q3 at a timestamp after the
    burst, and a read pinned before the burst sees the loaded rows."""
    jgen, tgen = gens
    _jcat0, tcat0 = catalogs
    jclock = JManualClock(1000)
    jstore = JStore(engine=JNative(), clock=JHLC(jclock))
    jcat = jgen.mvcc_load(jstore, TABLES)
    tclock = ManualClock(1000)
    tstore = carry_store(jstore, device="cpu", clock=HLC(tclock))
    assert tstore.fingerprint() == jstore.fingerprint()
    tcat = MVCCCatalog(tstore, tcat0.tables, rows=tcat0.rows,
                       pks=tcat0.pks, stats=tcat0.stats)
    before = Timestamp(1500, 0)
    Settings().set(resident.RESIDENT_SCAN, True)
    assert tstore.make_resident(10, len(tcat.table_schema("lineitem")))
    rt = resident.lookup(tstore, 10)
    rebuilds = rt.rebuilds
    _burst(jstore, tstore, tcat, np.random.default_rng(23))
    assert tstore.fingerprint() == jstore.fingerprint()
    jclock.advance(10**6)
    tclock.advance(10**6)
    for name in ("q1", "q6", "q3"):
        # the write rotated every key of the table (its version): no
        # image from before the burst can serve
        want = jcollect(_flow(jq, name, jgen, jcat), fuse=False)
        got_res, col = _resident_collect(_flow(tq, name, tgen, tcat),
                                         fuse=True)
        assert "scan.resident_fallback" not in col.stages
        _assert_equal_results(want, got_res)
        got_str, _ = _resident_collect(_flow(tq, name, tgen, tcat),
                                       fuse=False)
        _assert_equal_results(want, got_str)
    assert rt.rebuilds == rebuilds and rt.folds == 1  # folded, no rebuild
    assert resident.lookup(tstore, 10) is rt
    # the host walk (detached, setting off) at the same timestamp
    Settings().set(resident.RESIDENT_SCAN, False)
    resident.detach(tstore, 10)
    scan_image_cache().clear()
    for name in ("q1", "q6"):
        want = jcollect(_flow(jq, name, jgen, jcat), fuse=False)
        got = tcollect(_flow(tq, name, tgen, tcat), device="cpu")
        _assert_equal_results(want, got)
    # a snapshot read before the burst, through a fresh attach's arrays
    # (every version, the burst's included), equals the loaded rows
    Settings().set(resident.RESIDENT_SCAN, True)
    ncols = len(tcat.table_schema("lineitem"))
    assert tstore.make_resident(10, ncols)
    rt2 = resident.lookup(tstore, 10)
    loaded = tgen.table("lineitem")
    with stats.query_stats() as col:
        old = list(tstore.scan_chunks(10, ncols, 1 << 14, ts=before))
    assert col.stages["scan.resident"].events == 1
    names = tcat.table_schema("lineitem").names()
    for j, c in enumerate(names):
        got = np.concatenate([ch[f"f{j}"] for ch in old])
        assert np.array_equal(got, np.asarray(loaded[c], np.int64)), c
    assert rt2.n == tcat.table_rows("lineitem") + BURST_PUTS + BURST_DELETES


def test_snapshot_scan_op_before_burst_reads_folded_versions(gens, catalogs):
    """scan_op pinned before a burst, built after it, over the resident
    tier's folded arrays: the loaded rows; pinned after: the burst's."""
    from cockroach_tpu_torch.exec.operators import collect

    _jgen, tgen = gens
    _jcat0, tcat0 = catalogs
    store = MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(1000)),
                      device="cpu")
    tcat = tgen.mvcc_load(store, ["lineitem"])
    schema = tcat.table_schema("lineitem")
    Settings().set(resident.RESIDENT_SCAN, True)
    assert store.make_resident(10, len(schema))
    jstore = JStore(engine=JNative(), clock=JHLC(JManualClock(1000)))
    put_pks, del_pks = _burst(jstore, store, tcat, np.random.default_rng(5))
    rt = resident.lookup(store, 10)
    for ts, deleted in ((Timestamp(1500, 0), 0),
                        (Timestamp(10**6, 0), BURST_DELETES)):
        op = store.scan_op(10, schema, CAPACITY, ts=ts)
        assert op.cache_key[3] == "resident"
        res = collect(op, device="cpu", fuse=False)
        assert len(res["l_orderkey"]) == tgen.num_rows("lineitem") - deleted
    assert rt.folds == 1 and rt.rebuilds == 1


@pytest.mark.parametrize("resident_tier", [False, True],
                         ids=["host_walk", "resident"])
def test_catalog_pinned_before_burst_reads_loaded_rows(gens, resident_tier):
    """MVCCCatalog(ts=) reads every table at that timestamp and keys no
    scan image: Q1 and Q6 built after a burst over a catalog pinned
    before it equal the generator-direct results."""
    _jgen, tgen = gens
    store = MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(1000)),
                      device="cpu")
    tcat = tgen.mvcc_load(store, ["lineitem"])
    before = Timestamp(1500, 0)
    Settings().set(resident.RESIDENT_SCAN, resident_tier)
    if resident_tier:
        assert store.make_resident(10, len(tcat.table_schema("lineitem")))
    jstore = JStore(engine=JNative(), clock=JHLC(JManualClock(1000)))
    _burst(jstore, store, tcat, np.random.default_rng(31))
    pinned = MVCCCatalog(store, tcat.tables, rows=tcat.rows, pks=tcat.pks,
                         stats=tcat.stats, ts=before)
    assert pinned.scan_cache_key("lineitem", None, CAPACITY) is None
    for name in ("q1", "q6"):
        want = tcollect(_flow(tq, name, tgen), device="cpu")
        with stats.query_stats() as col:
            got = tcollect(_flow(tq, name, tgen, pinned), device="cpu",
                           fuse=False)
        assert pinned._scan_ts["lineitem"] == before
        assert ("scan.resident" in col.stages) == resident_tier
        assert "scan.resident_fallback" not in col.stages
        _assert_equal_results(want, got)
