"""TPC-H SF 0.01 in session tables: the eight tables loaded into a port
SessionCatalog with chip_smoke.py's `session_load` (the session's row
codec written straight into the engine, descriptors holding the
generator's dictionaries), then the ten SQL texts of
workload/tpch_queries.py `SQL`:

- a host walk of each table through `table_chunks` equals the
  generator's columns;
- the same stored bytes, copied into a JAX package MVCCStore, read
  through the JAX package's SessionCatalog as through the port's, on the
  host walk and on the resident tier: equal descriptors, statistics,
  chunk boundaries, columns (dictionary codes included) and validity
  lanes;
- each text through a port Session over the session tables (the fused
  tier, device="cpu") and through `build` + `collect(fuse=False)` (the
  streaming tier) equals the JAX package's `run_sql` over its TPC-H
  catalog, the port's TPCHCatalog run on the same tier and the port's
  oracle, bit for bit on int, decimal, date and dictionary-code columns
  and validity (float32 averages within test_torch_sql.py's tolerance);
  Q1 and Q6 (the texts chip_smoke.py phase 13 runs) also equal JAX's
  `run_sql` over its SessionCatalog on the copied bytes;
- a second execute of each text is a prepared hit.

The four texts whose JAX programs take longest to build run in
test_torch_session_tpch_b.py (Q5, Q12) and test_torch_session_tpch_c.py
(Q10, Q18), so that `--dist loadfile` spreads them. chip_smoke.py
phase 13 runs Q1 and Q6 the same way at SF 1 on the card."""

import numpy as np
import pytest

import chip_smoke
from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import run_sql as jrun_sql
from cockroach_tpu.sql.session import SessionCatalog as JSessionCatalog
from cockroach_tpu.storage.engine import open_engine as jopen_engine
from cockroach_tpu.storage.mvcc import MVCCStore as JMVCCStore
from cockroach_tpu.util.hlc import HLC as JHLC
from cockroach_tpu.util.hlc import ManualClock as JManualClock
from cockroach_tpu.util.hlc import Timestamp as JTimestamp
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.exec import collect, stats
from cockroach_tpu_torch.sql import run_sql as trun_sql
from cockroach_tpu_torch.sql.bind import plan_sql
from cockroach_tpu_torch.sql.plan import TPCHCatalog as TCatalog
from cockroach_tpu_torch.sql.plan import build
from cockroach_tpu_torch.sql.session import Session
from cockroach_tpu_torch.storage import resident
from cockroach_tpu_torch.storage.engine import NativeEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util.hlc import HLC, ManualClock
from cockroach_tpu_torch.util.settings import Settings
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH

from test_torch_sql import CAP, assert_same_result, check_oracle, sql_text
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = [1, 3, 6, 9, 14, 16]
JAX_SESSION_QUERIES = (1, 6)
TABLES = ("lineitem", "orders", "customer", "part", "partsupp",
          "supplier", "nation", "region")


@pytest.fixture(scope="module")
def loaded():
    gen = TTPCH(sf=0.01)
    store = MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(1000)),
                      device="cpu")
    cat, _secs = chip_smoke.session_load(gen, store, TABLES)
    # the same bytes in a JAX package store (coldata/carry.py's
    # carry_session_store the other way round), for its SessionCatalog
    jstore = JMVCCStore(engine=jopen_engine(),
                        clock=JHLC(JManualClock(store.clock.now().wall + 1)))
    jstore.engine.ingest_span(
        [(bytes(k), JTimestamp(int(ts.wall), int(ts.logical)), bytes(v))
         for k, ts, v in store.engine.export_span(b"", b"\xff" * 16)])
    return (gen, cat, TCatalog(gen), JCatalog(JTPCH(sf=0.01)),
            JSessionCatalog(jstore))


@pytest.mark.parametrize("table", TABLES)
def test_host_walk_reads_the_generated_columns(loaded, table):
    gen, cat, _tcat, _jcat, _jsess = loaded
    chunks = list(cat.table_chunks(table, CAP)())
    assert chunks
    want = gen.table(table)
    pk = chip_smoke.SESSION_PKS.get(table)
    order = (np.argsort(np.asarray(want[pk]), kind="stable") if pk
             else np.arange(gen.num_rows(table)))
    for f in gen.schema(table):
        got = np.concatenate([c[f.name] for c in chunks])
        np.testing.assert_array_equal(
            got, np.asarray(want[f.name], np.int64)[order], err_msg=f.name)
        assert f.name + "__valid" not in chunks[0]  # declared NOT NULL
    assert cat.table_rows(table) == gen.num_rows(table)


@pytest.mark.parametrize("tier", ["host", "resident"])
@pytest.mark.parametrize("table", TABLES)
def test_session_tables_read_as_jax_session_tables(loaded, table, tier):
    _gen, cat, _tcat, _jcat, jsess = loaded
    assert cat.desc(table).encode() == jsess.desc(table).encode()
    ts, js = cat.table_stats(table), jsess.table_stats(table)
    assert (ts and ts.encode()) == (js and js.encode())
    want = list(jsess.table_chunks(table, CAP)())
    settings = Settings()
    prev = settings.get(resident.RESIDENT_SCAN)
    settings.set(resident.RESIDENT_SCAN, tier == "resident")
    resident.reset()
    try:
        got = list(cat.table_chunks(table, CAP)())
        attached = resident.lookup(cat.store, cat.desc(table).table_id)
        assert (attached is not None) == (tier == "resident")
    finally:
        settings.set(resident.RESIDENT_SCAN, prev)
        resident.reset()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for c in w:
            np.testing.assert_array_equal(np.asarray(g[c]), np.asarray(w[c]),
                                          err_msg=c)


@pytest.mark.parametrize("q", QUERIES)
def test_text_over_session_tables_matches_both_catalogs(loaded, q):
    check_text(loaded, q)


def check_text(loaded, q):
    gen, cat, tcat, jcat, jsess = loaded
    text = sql_text(q)
    want = jrun_sql(text, jcat, CAP)
    # the fused tier, through a session over the session tables
    session = Session(cat, capacity=CAP, device="cpu")
    kind, fused, _schema = session.execute(text)
    assert kind == "rows"
    assert_same_result(fused, want)
    assert_same_result(fused, trun_sql(text, tcat, CAP, device="cpu"))
    if q in JAX_SESSION_QUERIES:
        assert_same_result(fused, jrun_sql(text, jsess, CAP))
    check_oracle(q, fused, gen)
    col = stats.enable()
    try:
        _kind, again, _schema = session.execute(text)
    finally:
        stats.disable()
    assert "sql.prepared_hit" in col.stages
    assert_same_result(again, fused)
    # the streaming tier over both catalogs
    streamed = collect(build(plan_sql(text, cat), cat, CAP), device="cpu",
                       fuse=False)
    assert_same_result(streamed, want)
    assert_same_result(streamed, collect(build(plan_sql(text, tcat), tcat,
                                               CAP), device="cpu",
                                         fuse=False))
    check_oracle(q, streamed, gen)
