"""The resident scan, the scan-image cache and the stacked fold and build
of the port (cockroach_tpu_torch/exec/operators.py ScanOp, HashAggOp,
JoinOp; exec/scan_cache.py; util/mon.py; util/stop.py;
coldata/arrow.py make_flat_unpack) on the CPU, against the JAX package
where it has the same function: the LRU cache, the memory monitor, the
resident scan's caching, accounting and budget, the stacked image,
the catalog's cache key, the fold and the build over an image (with a
restart, and the workmem decline), the flat unpack, the image's bytes
across runs, a fresh plan build borrowing the image, the prefetch
thread's close, error and stop paths, and the fifteen TPC-H queries with
every scan resident. Everything is small (SF 0.01, capacities 2^8 to
2^14), so every scan has several chunks."""

import numpy as np
import pytest
import torch

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.exec import scan_cache as jscan_cache
from cockroach_tpu.exec import stats as jstats
from cockroach_tpu.ops.agg import AggSpec as JAggSpec
from cockroach_tpu.ops import expr as jx
from cockroach_tpu.sql import plan as jplan
from cockroach_tpu.util import mon as jmon
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.coldata.arrow import (
    make_flat_unpack, make_unpack, pack_chunk,
)
from cockroach_tpu_torch.coldata.batch import Field, INT, Schema
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import operators as tops
from cockroach_tpu_torch.exec import scan_cache as tscan_cache
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.sql import plan as tplan
from cockroach_tpu_torch.util import mon as tmon
from cockroach_tpu_torch.util.stop import Stopper, StopperStopped
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_expr import port_schema
from test_torch_expr_nodes import to_port
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 14
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_caches():
    """Each test starts with both packages' scan-image caches empty."""
    tscan_cache.scan_image_cache().clear()
    jscan_cache.scan_image_cache().clear()
    yield
    tscan_cache.scan_image_cache().clear()
    jscan_cache.scan_image_cache().clear()


def _make_resident(flow, scan_cls):
    for op in walk(flow, scan_cls):
        op.resident = True


def walk(flow, scan_cls):
    walker = (tops.walk_operators if scan_cls is tops.ScanOp
              else jops.walk_operators)
    return [op for op in walker(flow) if isinstance(op, scan_cls)]


def _stage(col, name):
    s = col.stages.get(name)
    return s.events if s else 0


# ------------------------------------------------------ cache and monitor

@pytest.mark.parametrize("cache_cls", [tscan_cache.ScanImageCache,
                                       jscan_cache.ScanImageCache],
                         ids=["port", "jax"])
def test_lru_eviction_under_budget(cache_cls):
    """JAX test_fused_cache.py's LRU case, on both caches."""
    c = cache_cls(budget=100)
    assert c.put(("a",), "A", 60)
    assert c.nbytes == 60
    assert c.put(("b",), "B", 60)              # evicts a (LRU)
    assert c.get(("a",)) is None
    assert c.get(("b",)) == "B"
    assert c.nbytes == 60
    assert not c.put(("c",), "C", 200)         # alone exceeds the budget
    assert c.get(("b",)) == "B"                # untouched
    # a get refreshes recency: b survives the next eviction, d does not
    assert c.put(("d",), "D", 30)
    assert c.get(("b",)) == "B"
    assert c.put(("e",), "E", 60)
    assert c.get(("d",)) is None
    assert c.get(("b",)) is None or c.get(("e",)) == "E"
    assert c.contains(("e",)) and len(c) >= 1
    c.invalidate(("e",))
    assert c.get(("e",)) is None


def test_cache_stats_events():
    """Hits, misses, evictions and invalidations count as stats events."""
    c = tscan_cache.ScanImageCache(budget=100)
    with stats.query_stats() as col:
        c.get(("x",))
        c.put(("a", 1), "A", 60)
        c.put(("b", 1), "B", 60)
        c.get(("b", 1))
        c.invalidate(("b",))
    assert [_stage(col, f"scan.cache_{k}") for k in
            ("miss", "hit", "evict", "invalidate")] == [1, 1, 1, 1]


def test_snapshot_restore_round_trip():
    """A snapshot taken before a clear puts every entry back, in LRU
    order, under the budget."""
    c = tscan_cache.ScanImageCache(budget=100)
    c.put(("a",), "A", 30)
    c.put(("b",), "B", 40)
    c.get(("a",))                              # a is now the newest
    snap = c.snapshot()
    assert snap == [(("b",), "B", 40), (("a",), "A", 30)]
    c.clear()
    assert len(c) == 0 and c.nbytes == 0
    c.restore(snap)
    assert c.snapshot() == snap and c.nbytes == 70
    small = tscan_cache.ScanImageCache(budget=50)
    small.restore(snap)                        # b goes first, as LRU
    assert small.snapshot() == [(("a",), "A", 30)]


def _monitor_trace(mon_mod, budget):
    """A fixed sequence of grow/shrink/resize/close calls on a two-level
    monitor tree: (used, peak, parent used) after each step, and the
    step that raised."""
    root = mon_mod.BytesMonitor("root", budget=budget)
    kid = root.child("kid", budget=budget // 2)
    a, b = kid.make_account(), root.make_account()
    steps = [(a.grow, 30), (b.grow, 20), (a.shrink, 10), (a.resize, 45),
             (b.grow, 40), (a.grow, 10), (a.close, None), (b.grow, 55),
             (b.shrink, 500), (b.grow, 80), (a.grow, 120)]
    trace, raised = [], None
    for i, (fn, n) in enumerate(steps):
        try:
            fn() if n is None else fn(n)
        except mon_mod.BudgetExceededError as e:
            raised = raised or (i, e.requested, e.used)
        trace.append((kid.used, kid.peak, root.used, root.peak, a.used,
                      b.used))
    return trace, raised


@pytest.mark.parametrize("budget", [100, 120, 200])
def test_monitor_matches_jax(budget):
    got = _monitor_trace(tmon, budget)
    assert got == _monitor_trace(jmon, budget)
    assert got[1] is not None  # every budget here raises at some step


# ------------------------------------------------------ the resident scan

def _int_scan(mod, data, capacity, **kw):
    """A ScanOp (of the port, tops, or the JAX package, jops) over INT
    columns, with a chunk thunk that counts its calls."""
    calls = {"n": 0}

    def chunks():
        calls["n"] += 1
        yield data

    if mod is tops:
        schema = Schema([Field(k, INT) for k in data])
    else:
        schema = jbatch.Schema([jbatch.Field(k, jbatch.INT) for k in data])
    return mod.ScanOp(schema, chunks, capacity, **kw), calls


def test_resident_scan_caches_and_accounts():
    """JAX test_runtime.py's case on the port: the second run is served
    from the image, eviction releases the accounting and re-streams."""
    mon = tmon.BytesMonitor("test-hbm", budget=1 << 20)
    op, calls = _int_scan(tops, {"k": np.arange(100, dtype=np.int64)}, 32,
                          resident=True, monitor=mon)
    agg = tops.HashAggOp(op, [], [AggSpec("sum", "k", "s")])
    r1 = tcollect(agg, device="cpu", fuse=False)
    assert calls["n"] == 1
    # one image: four pieces of 32 rows and their four row counts
    assert op._stacked.bufs.shape == (4, op._nbytes)
    assert mon.used == 4 * op._nbytes + 4 * 4
    with stats.query_stats() as col:
        r2 = tcollect(agg, device="cpu", fuse=False)
    assert calls["n"] == 1  # served from the resident image
    assert _stage(col, "scan.pack") == 0
    assert _stage(col, "agg.fold_stacked") == 1
    assert r1["s"][0] == r2["s"][0] == 4950
    op.evict()
    assert mon.used == 0
    tcollect(agg, device="cpu", fuse=False)
    assert calls["n"] == 2  # evicted => re-streams


def test_resident_scan_respects_budget():
    """A budget smaller than one packed piece: the scan stays
    streaming-only and pins nothing."""
    mon = tmon.BytesMonitor("tiny", budget=64)
    op, calls = _int_scan(tops, {"k": np.arange(100, dtype=np.int64)}, 32,
                          resident=True, monitor=mon)
    agg = tops.HashAggOp(op, [], [AggSpec("count_star", None, "n")])
    assert tcollect(agg, device="cpu", fuse=False)["n"][0] == 100
    assert op._stacked is None
    assert mon.used == 0
    assert tcollect(agg, device="cpu", fuse=False)["n"][0] == 100
    assert calls["n"] == 2


@pytest.mark.parametrize("slack", [0, -1])
def test_image_takes_over_the_pass_account(slack):
    """The stack takes over the account of the pass's pieces, so a
    budget of one copy and the row counts pins it (slack 0): the stack is
    made once, on the cold run, and no later run packs. One byte less
    (slack -1) and the scan streams every run, pinning nothing."""
    op, calls = _int_scan(tops, {"k": np.arange(100, dtype=np.int64)}, 32,
                          resident=True)
    budget = 4 * op._nbytes + 4 * 4 + slack
    op._monitor = tmon.BytesMonitor("one-copy", budget=budget)
    agg = tops.HashAggOp(op, [], [AggSpec("sum", "k", "s")])
    cols = []
    for _ in range(3):
        with stats.query_stats() as col:
            assert tcollect(agg, device="cpu", fuse=False)["s"][0] == 4950
        cols.append(col)
    stacks = [_stage(c, "scan.stack") for c in cols]
    packs = [_stage(c, "scan.pack") for c in cols]
    if slack == 0:
        assert calls["n"] == 1 and op._monitor.used == budget
        assert stacks == [1, 0, 0] and packs == [4, 0, 0]
    else:
        assert calls["n"] == 3 and op._monitor.used == 0
        assert op._stacked is None
        assert stacks == [0, 0, 0] and packs == [4, 4, 4]


def test_limit_pins_no_prefix():
    """A consumer that stops early (LIMIT) leaves no image and no
    accounting behind."""
    mon = tmon.BytesMonitor("test-hbm", budget=1 << 20)
    data = {"k": np.arange(4096, dtype=np.int64)}
    op, calls = _int_scan(tops, data, 256, resident=True, monitor=mon)
    out = tcollect(tops.LimitOp(op, 10), device="cpu", fuse=False)
    assert out["k"].tolist() == list(range(10))
    assert op._stacked is None and mon.used == 0


@pytest.mark.parametrize("rows", [50, 192, 300])
def test_image_stacks_only_the_real_chunks(rows):
    """The image holds exactly the pass's chunks (1, 3 or 5 here, no
    padding: the port compiles no program whose shape a power of two
    would bound), and a pass over it reads each chunk once, in order."""
    data = {"k": np.arange(rows, dtype=np.int64) % 7,
            "v": np.ones(rows, dtype=np.int64)}
    scan, calls = _int_scan(tops, data, 64, resident=True)
    assert scan.stacked_image(CPU) is None  # no complete pass yet
    streamed = [(b.clone(), m) for b, m in scan._raw_stream(CPU)]
    st = scan.stacked_image(CPU)
    n = -(-rows // 64)
    want_ms = tuple(min(64, rows - 64 * i) for i in range(n))
    assert st.bufs.shape == (n, scan._nbytes)
    assert st.ms_host == want_ms and st.ms.tolist() == list(want_ms)
    again = list(scan._raw_stream(CPU))
    assert calls["n"] == 1 and [m for _, m in again] == list(want_ms)
    for (b0, m0), (b1, m1) in zip(streamed, again):
        assert m0 == m1 and torch.equal(b0, b1)


def test_image_is_per_device_in_the_cache():
    """The cache key of an image carries its device: a key the catalog
    gives is never matched by an image made on another device."""
    data = {"k": np.arange(100, dtype=np.int64)}
    op, _ = _int_scan(tops, data, 32, resident=True, cache_key=("t", 1))
    list(op.batches(CPU))
    cache = tscan_cache.scan_image_cache()
    assert cache.contains(("t", 1, ("cpu", None)))
    assert not cache.contains(("t", 1, ("cuda", 0)))
    assert op.has_image(CPU)


# ------------------------------------------------------ the catalog's key

def test_tpch_catalog_cache_key():
    cols = ["l_quantity", "l_discount"]
    key = tplan.TPCHCatalog(ttpch.TPCH(sf=SF)).scan_cache_key(
        "lineitem", cols, 1 << 12)
    assert key == tplan.TPCHCatalog(ttpch.TPCH(sf=SF)).scan_cache_key(
        "lineitem", cols, 1 << 12)
    assert key == jplan.TPCHCatalog(jtpch.TPCH(sf=SF)).scan_cache_key(
        "lineitem", cols, 1 << 12)
    other = [tplan.TPCHCatalog(ttpch.TPCH(sf=0.02)).scan_cache_key(
                 "lineitem", cols, 1 << 12),
             tplan.TPCHCatalog(ttpch.TPCH(sf=SF)).scan_cache_key(
                 "lineitem", cols[:1], 1 << 12),
             tplan.TPCHCatalog(ttpch.TPCH(sf=SF)).scan_cache_key(
                 "lineitem", cols, 1 << 13)]
    assert all(k != key for k in other)
    assert tplan.Catalog().scan_cache_key("t", None, 8) is None


def test_build_sets_cache_key_on_every_scan():
    flow = tq.q9(ttpch.TPCH(sf=SF), CAPACITY)
    scans = walk(flow, tops.ScanOp)
    assert len(scans) >= 5
    assert all(s.cache_key[0] == "tpch" and s.cache_key[3] == s.table
               for s in scans)


# -------------------------------------------- stacked fold and build

_WORDS = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"], dtype=object)


def _agg_case(kind):
    """(JAX schema, data, capacity, group_by, aggs, filter) of a GROUP BY
    over a MapOp filter over a scan, for the dense route (a dictionary
    key), the sort route, and a sort route whose accumulator overflows
    (40 groups in 8 lanes: three restarts, to 64)."""
    rng = np.random.default_rng(7)
    n = 700 if kind != "overflow" else 64
    js = jbatch.Schema([jbatch.Field("s", jbatch.STRING, dict_ref="w"),
                        jbatch.Field("g", jbatch.INT),
                        jbatch.Field("v", jbatch.INT),
                        jbatch.Field("d", jbatch.DECIMAL(2))],
                       {"w": _WORDS})
    data = {"s": rng.integers(0, len(_WORDS), n).astype(np.int32),
            "g": (np.arange(n) % 40 if kind == "overflow"
                  else rng.integers(0, 50, n)).astype(np.int64),
            "v": rng.integers(-1000, 1000, n).astype(np.int64),
            "d": rng.integers(0, 10 ** 6, n).astype(np.int64)}
    gb = ["s"] if kind == "dense" else ["g"]
    aggs = [("sum", "v", "sv"), ("count_star", None, "n"),
            ("min", "d", "md"), ("avg", "d", "ad")]
    cap = 8 if kind == "overflow" else 128
    pred = (jx.Cmp(">", jx.Col("v"), jx.Lit(-900)) if kind != "overflow"
            else None)
    return js, data, cap, gb, aggs, pred


def _agg_flow(mod, kind, resident):
    js, data, cap, gb, aggs, pred = _agg_case(kind)
    schema = port_schema(js) if mod is tops else js
    spec = AggSpec if mod is tops else JAggSpec

    def chunks():
        yield data

    scan = mod.ScanOp(schema, chunks, cap, resident=resident)
    child = scan if pred is None else mod.MapOp(
        scan, [("filter", to_port(pred) if mod is tops else pred)])
    return mod.HashAggOp(child, gb, [spec(*a) for a in aggs])


@pytest.mark.parametrize("kind", ["dense", "sort", "overflow"])
def test_stacked_fold_matches_jax(kind):
    """The fold over a resident image: the second run of each side folds
    from the image (agg.fold_stacked on both), equal to the JAX
    package's, to the port's own streaming run, and (overflow) with one
    restart on the cold run, as streaming has."""
    tflow, jflow = _agg_flow(tops, kind, True), _agg_flow(jops, kind, True)
    with stats.query_stats() as streaming:
        streamed = tcollect(_agg_flow(tops, kind, False), device="cpu",
                            fuse=False)
    restarts = _stage(streaming, "flow.restart")
    assert (restarts > 0) == (kind == "overflow")
    with stats.query_stats() as cold:
        tcollect(tflow, device="cpu", fuse=False)
    with stats.query_stats() as warm:
        got = tcollect(tflow, device="cpu", fuse=False)
    jcollect(jflow, fuse=False)
    jcol = jstats.enable()
    try:
        want = jcollect(jflow, fuse=False)
    finally:
        jstats.disable()
    _assert_equal_results(want, got)
    _assert_equal_results(streamed, got)
    assert _stage(warm, "agg.fold_stacked") == 1
    assert _stage(jcol, "agg.fold_stacked") == 1
    assert _stage(warm, "scan.pack") == 0
    assert _stage(cold, "flow.restart") == restarts
    assert _stage(warm, "flow.restart") == 0


def _join_flows(mod, resident, capacity=1 << 10):
    """Orders (probe) joined with a filtered customer (build) at SF 0.01
    through each package's planner: the build side is MapOp -> ScanOp
    over two chunks at capacity 2^10, three at 2^9. -> (flow, its
    JoinOp)."""
    if mod is tops:
        from cockroach_tpu_torch.coldata.batch import DECIMAL
        from cockroach_tpu_torch.ops import expr as x
        P, gen, dec = tplan, ttpch.TPCH(sf=SF), DECIMAL(2)
    else:
        x, P, gen, dec = jx, jplan, jtpch.TPCH(sf=SF), jbatch.DECIMAL(2)
    plan = P.Join(
        P.Scan("orders", ("o_orderkey", "o_custkey", "o_totalprice")),
        P.Filter(P.Scan("customer", ("c_custkey", "c_acctbal",
                                     "c_mktsegment")),
                 x.Cmp(">", x.Col("c_acctbal"), x.Lit(0.0, dec))),
        ("o_custkey",), ("c_custkey",))
    flow = P.build(plan, P.TPCHCatalog(gen), capacity=capacity)
    join = [op for op in mod.walk_operators(flow)
            if isinstance(op, mod.JoinOp)][0]
    if resident:
        _make_resident(flow, mod.ScanOp)
    return flow, join


def _batch_arrays(b):
    out = {"__sel": b.sel.numpy(), "__length": int(b.length)}
    for n, c in b.columns.items():
        out[n] = c.values.numpy()
        out[n + "__valid"] = (None if c.validity is None
                              else c.validity.numpy())
    return out


@pytest.mark.parametrize("capacity, chunks", [(1 << 11, 1), (1 << 10, 2),
                                              (1 << 9, 3)])
def test_stacked_build_matches_chunked_and_jax(capacity, chunks):
    """The build side made from the image equals the chunked build
    batch lane for lane (values, validity, sel, length), with two
    chunks and with three (one chunk takes the chunked path: there is
    nothing to concatenate), and the join's result equals the JAX
    package's resident run."""
    tflow, tjoin = _join_flows(tops, True, capacity)
    tcollect(tflow, device="cpu", fuse=False)
    build_scan = tops._source_scan(tjoin.build)[1]
    assert len(build_scan.stacked_image(CPU).ms_host) == chunks
    stacked = int(chunks > 1)
    chunked_flow, chunked_join = _join_flows(tops, False, capacity)
    # _materialize_build gives ("mem", the build batch) within workmem
    kind, built = chunked_join._materialize_build(CPU)
    assert kind == "mem"
    want_build = _batch_arrays(built)
    with stats.query_stats() as col:
        kind, built = tjoin._materialize_build(CPU)
    assert kind == "mem"
    got_build = _batch_arrays(built)
    assert _stage(col, "join.build_stacked") == stacked
    assert want_build.keys() == got_build.keys()
    for k in want_build:
        if want_build[k] is None:
            assert got_build[k] is None, k
        else:
            np.testing.assert_array_equal(got_build[k], want_build[k], k)
    with stats.query_stats() as warm:
        got = tcollect(tflow, device="cpu", fuse=False)
    assert _stage(warm, "join.build_stacked") == stacked
    assert _stage(warm, "scan.pack") == 0
    _assert_equal_results(tcollect(chunked_flow, device="cpu",
                                   fuse=False), got)
    jflow, _ = _join_flows(jops, True, capacity)
    jcollect(jflow, fuse=False)
    jcol = jstats.enable()
    try:
        want = jcollect(jflow, fuse=False)
    finally:
        jstats.disable()
    assert _stage(jcol, "join.build_stacked") == 1
    _assert_equal_results(want, got)


def test_stacked_build_declines_past_workmem():
    """A build that could pass workmem declines the stacked build and
    streams into the grace join, which completes: its rows equal the JAX
    package's in-memory join of the same flow as a multiset (the grace
    join emits partition by partition)."""
    from cockroach_tpu_torch.exec.spill import host_spill_monitor

    tflow, tjoin = _join_flows(tops, True)
    tcollect(tflow, device="cpu", fuse=False)
    tjoin.workmem = 1000
    with stats.query_stats() as col:
        got = tcollect(tflow, device="cpu", fuse=False)
    assert _stage(col, "join.build_stacked") == 0
    assert _stage(col, "join.grace_spill") >= 1
    assert host_spill_monitor().used == 0
    jflow, _ = _join_flows(jops, False)
    want = jcollect(jflow, fuse=False)
    names = list(want)
    assert sorted(names) == sorted(got)

    def rows(res):
        return sorted(zip(*(np.asarray(res[n]).tolist() for n in names)))

    assert rows(got) == rows(want)


# ------------------------------------------------------ make_flat_unpack

def test_flat_unpack_equals_concatenated_chunk_unpacks():
    from cockroach_tpu_torch.coldata.batch import (
        BOOL, FLOAT, concat_batches,
    )

    schema = Schema([Field("a", INT, wire="i2"), Field("f", FLOAT),
                     Field("n", INT, nullable=True), Field("b", BOOL)])
    cap = 64
    rng = np.random.default_rng(3)
    bufs, ms, parts = [], [], []
    unpack = make_unpack(schema, cap)
    for m in (64, 17, 0, 40):
        chunk = {"a": rng.integers(-300, 300, m),
                 "f": rng.normal(size=m).astype(np.float32),
                 "n": rng.integers(0, 9, m),
                 "n__valid": (rng.random(m) > 0.3).astype(np.uint8),
                 "b": rng.random(m) > 0.5}
        buf, got_m = pack_chunk(chunk, schema, cap)
        assert got_m == m
        bufs.append(torch.from_numpy(buf))
        ms.append(m)
        parts.append(unpack(bufs[-1], m))
    flat = make_flat_unpack(schema, cap)(
        torch.stack(bufs), torch.tensor(ms, dtype=torch.int32))
    want = concat_batches(parts)
    assert int(flat.length) == sum(ms)
    assert torch.equal(flat.sel, want.sel)
    for name in want.names():
        w, g = want.col(name), flat.col(name)
        assert g.values.dtype == w.values.dtype, name
        assert torch.equal(g.values, w.values), name
        assert (g.validity is None) == (w.validity is None), name
        if w.validity is not None:
            assert torch.equal(g.validity, w.validity), name


# ------------------------------------------ aliasing and the fresh build

def _image_bytes(flow):
    return {id(s): s._stacked.bufs.clone() for s in walk(flow, tops.ScanOp)
            if s._stacked is not None}


@pytest.mark.parametrize("name", ["q1", "q3", "q9"])
def test_image_bytes_unchanged_by_runs(name):
    """Columns are views of the image where the wire dtype is the
    device's: three runs leave every resident image's bytes as they
    were."""
    gen = ttpch.TPCH(sf=SF)
    flow = getattr(tq, name)(gen, CAPACITY)
    _make_resident(flow, tops.ScanOp)
    first = tcollect(flow, device="cpu", fuse=False)
    before = _image_bytes(flow)
    assert before and len(before) == len(walk(flow, tops.ScanOp))
    for _ in range(3):
        _assert_equal_results(first, tcollect(flow, device="cpu", fuse=False))
    after = _image_bytes(flow)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_fresh_plan_build_borrows_the_image():
    """JAX test_fused_cache.py test_second_query_hits_scan_image_cache on
    the port: a second plan build, not marked resident, over data whose
    images are cached borrows them: a cache hit, no pack, no copy."""
    gen = ttpch.TPCH(sf=SF)
    flow = tq.q3(gen, CAPACITY)
    _make_resident(flow, tops.ScanOp)
    want = tcollect(flow, device="cpu", fuse=False)
    fresh = tq.q3(ttpch.TPCH(sf=SF), CAPACITY)
    with stats.query_stats() as col:
        got = tcollect(fresh, device="cpu", fuse=False)
    _assert_equal_results(want, got)
    assert _stage(col, "scan.cache_hit") >= len(walk(fresh, tops.ScanOp))
    assert _stage(col, "scan.pack") == 0
    assert _stage(col, "scan.transfer") == 0


# ------------------------------------------------------ the prefetch thread

def test_prefetch_closes_source_on_early_exit():
    closed = []

    def source():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.append(True)

    it = tops._prefetch(source(), CPU, depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed == [True]


def test_prefetch_passes_producer_error_on():
    def source():
        yield 1
        raise ValueError("producer broke")

    with pytest.raises(ValueError, match="producer broke"):
        list(tops._prefetch(source(), CPU))


def test_flow_stopper_drains_prefetch():
    """JAX test_util.py's case on the port: a stopped flow stopper makes
    a scan raise StopperStopped, not yield an empty stream."""
    old = tops._flow_stopper
    try:
        tops._flow_stopper = Stopper()
        tops._flow_stopper.stop()
        scan, _ = _int_scan(tops, {"k": np.arange(10, dtype=np.int64)}, 4)
        with pytest.raises(StopperStopped):
            list(scan.batches(CPU))
    finally:
        tops._flow_stopper = old


def test_prefetch_reports_into_the_consumers_stats():
    scan, _ = _int_scan(tops, {"k": np.arange(100, dtype=np.int64)}, 32)
    with stats.query_stats() as col:
        assert len(list(scan.batches(CPU))) == 4
    assert _stage(col, "scan.pack") == 4 and _stage(col, "scan.transfer") == 4


# ------------------------------------------------- the fifteen queries

QUERIES = ("q1", "q2", "q3", "q4", "q5", "q6", "q9", "q10", "q12", "q14",
           "q15", "q16", "q17", "q18", "q19")


def _query(mod, name, gen):
    if name == "q18":
        return mod.q18(gen, 300, CAPACITY) if mod is tq else jq.q18(
            gen, 300, CAPACITY)
    return getattr(mod, name)(gen, CAPACITY)


@pytest.fixture(scope="module")
def tgen():
    return ttpch.TPCH(sf=SF)


@pytest.mark.parametrize("name", QUERIES)
def test_query_resident_equals_streaming(tgen, name):
    """Every scan resident: runs 2 and 3 equal the streaming result bit
    for bit and pack nothing. Q15's shared revenue subplan reads the
    image its first pull pinned, so even the cold run packs each table
    once."""
    streamed = tcollect(_query(tq, name, tgen), device="cpu", fuse=False)
    tscan_cache.scan_image_cache().clear()
    flow = _query(tq, name, tgen)
    _make_resident(flow, tops.ScanOp)
    scans = walk(flow, tops.ScanOp)
    with stats.query_stats() as cold:
        _assert_equal_results(streamed, tcollect(flow, device="cpu",
                                                 fuse=False))
    n_chunks = {}
    for s in scans:
        n = -(-tgen.num_rows(s.table) // CAPACITY)
        n_chunks[id(s)] = n
    restarts = _stage(cold, "flow.restart")
    assert _stage(cold, "scan.pack") <= (1 + restarts) * sum(
        n_chunks.values())
    if name == "q15":
        assert _stage(cold, "scan.pack") == sum(n_chunks.values())
    for _ in range(2):
        with stats.query_stats() as warm:
            _assert_equal_results(streamed, tcollect(flow, device="cpu",
                                                     fuse=False))
        assert _stage(warm, "scan.pack") == 0
        assert _stage(warm, "scan.transfer") == 0
        assert _stage(warm, "flow.restart") == 0


@pytest.mark.parametrize("name", ["q1", "q3", "q18"])
def test_query_resident_matches_jax_resident(tgen, name):
    jflow = _query(jq, name, jtpch.TPCH(sf=SF))
    _make_resident(jflow, jops.ScanOp)
    jcollect(jflow, fuse=False)
    want = jcollect(jflow, fuse=False)
    flow = _query(tq, name, tgen)
    _make_resident(flow, tops.ScanOp)
    tcollect(flow, device="cpu", fuse=False)
    _assert_equal_results(want, tcollect(flow, device="cpu", fuse=False))


# ------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sort", "overflow"])
def test_stacked_fold_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    want = tcollect(_agg_flow(tops, kind, False), device="cpu", fuse=False)
    flow = _agg_flow(tops, kind, True)
    tcollect(flow, device="cuda", fuse=False)
    with stats.query_stats() as warm:
        got = tcollect(flow, device="cuda", fuse=False)
    _assert_equal_results(want, got)
    assert _stage(warm, "agg.fold_stacked") == 1
    assert _stage(warm, "scan.pack") == 0


@pytest.mark.cuda
def test_stacked_build_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chunked_flow, _ = _join_flows(tops, False)
    want = tcollect(chunked_flow, device="cpu", fuse=False)
    flow, _ = _join_flows(tops, True)
    tcollect(flow, device="cuda", fuse=False)
    with stats.query_stats() as warm:
        got = tcollect(flow, device="cuda", fuse=False)
    _assert_equal_results(want, got)
    assert _stage(warm, "join.build_stacked") == 1
    assert _stage(warm, "scan.pack") == 0
