"""The fused whole-query runner and the degradation ladder of the port
(cockroach_tpu_torch/exec/fused.py, exec/operators.py run_flow and
collect, util/retry.py, util/circuit.py) against the JAX package's, on
the CPU, where the fused program runs eagerly.

- The fifteen TPC-H queries of `PLANS` at SF 0.01, capacity 2^13
  (Q18 with threshold 150): the port's `collect(fuse=True,
  device="cpu")` equals the JAX package's `collect(fuse=True)` column
  for column, row order included, and the query's oracle; it takes the
  fused tier, and its tracer takes the JAX tracer's routes (counted by
  wrapping `_Tracer._try_groupjoin` and `_try_int_agg` on both sides:
  the group join in Q3 and Q18, the int-key GROUP BY in Q15, Q17 and
  Q18), and builds the JAX tracer's payload-carry joins (counted by
  wrapping ops/sortjoin.py prepare_unique on both sides). Its restarts
  equal the JAX runner's: both JoinOps start at "unique" (Q4's semi
  join, whose build keys repeat, steps down to "unique-mat" and then to
  "expand").
- At capacity 2^12 lineitem spans 15 chunks, not a power of two: the
  port's tracer reckons the capacities of the JAX tracer's batches,
  whose image pads to 16 chunks, while its own batches hold only the 15
  real chunks' lanes.
- The cases of tests/test_fused.py: join and aggregate overflow
  restarts, the custom-operator and empty-scan fallbacks, the group-join
  collapse against streaming, duplicate build keys, the workmem
  fallback; a shared float product across two projections.
- The ladder: a RESOURCE error in the fused tier degrades to streaming
  with the same rows (`resilience.degrade.fused`), a TERMINAL error (a
  CUDA fault) propagates, a tripped breaker skips the tier; the
  classifier, the breaker and the backoff policy against the JAX
  package's.
- `cuda`-marked twins, which skip without a card: a graph replay equals
  the eager program bit for bit, and a second run replays."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import fused as jfused
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.exec import stats as jstats
from cockroach_tpu.ops import expr as jx
from cockroach_tpu.ops import sortjoin as jsortjoin
from cockroach_tpu.ops.agg import AggSpec as JAggSpec
from cockroach_tpu.ops.sort import SortKey as JSortKey
from cockroach_tpu.util import circuit as jcircuit
from cockroach_tpu.util import retry as jretry
from cockroach_tpu.workload import tpch as jtpch
from cockroach_tpu.workload import tpch_queries as jq
from cockroach_tpu_torch.coldata.batch import (
    FLOAT, INT, STRING, Field, Schema,
)
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import fused as tfused
from cockroach_tpu_torch.exec import operators as tops
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops import sortjoin as tsortjoin
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util import retry as tretry
from cockroach_tpu_torch.util.mon import BudgetExceededError
from cockroach_tpu_torch.workload import tpch as ttpch
from cockroach_tpu_torch.workload import tpch_queries as tq
from test_torch_expr_nodes import to_port
from test_torch_q3_q18 import _assert_equal_results
from torch_threads import one_torch_thread  # noqa: F401

SF = 0.01
CAPACITY = 1 << 13
Q18_THRESHOLD = 150
QUERIES = ("q1", "q2", "q3", "q4", "q5", "q6", "q9", "q10", "q12", "q14",
           "q15", "q16", "q17", "q18", "q19")
LEFT_FUSED = ("fused.fallback_", "resilience.")


def _flow(mod, name, gen, capacity):
    if name == "q18":
        return mod.q18(gen, Q18_THRESHOLD, capacity)
    return getattr(mod, name)(gen, capacity)


@pytest.fixture(autouse=True)
def _closed_breakers():
    """Every test starts and ends with every breaker closed."""
    tcircuit.reset_all()
    jcircuit.reset_all()
    yield
    tcircuit.reset_all()
    jcircuit.reset_all()


class _Recorder:
    """Counts the routes each package's tracer takes, and the capacity of
    every batch it materializes, by wrapping its _Tracer methods: `caps`
    the capacity as the JAX tracer reckons it (the port's tracer adds the
    padding lanes it reckons), `real` the batch's own. `routes["carry"]`
    counts the unique builds that took the payload carry (wrapping the
    package's ops/sortjoin.py prepare_unique)."""

    def __init__(self, mp, mod):
        self.routes = collections.Counter()
        self.caps = []
        self.real = []
        sortjoin = jsortjoin if mod is jfused else tsortjoin
        orig_prepare = sortjoin.prepare_unique

        def prepare(*args, **kwargs):
            ub = orig_prepare(*args, **kwargs)
            if ub.payv is not None:
                self.routes["carry"] += 1
            return ub

        mp.setattr(sortjoin, "prepare_unique", prepare)
        for name in ("_try_groupjoin", "_try_int_agg"):
            orig = getattr(mod._Tracer, name)

            def wrapped(tracer, op, _orig=orig, _name=name):
                out = _orig(tracer, op)
                if out is not None:
                    self.routes[_name] += 1
                return out

            mp.setattr(mod._Tracer, name, wrapped)
        orig_mat = mod._Tracer._mat_inner

        def mat(tracer, op, _orig=orig_mat):
            out = _orig(tracer, op)
            pad = getattr(tracer, "_pad", {}).get(id(op), 0)
            self.caps.append((type(op).__name__, int(out.capacity) + pad))
            self.real.append((type(op).__name__, int(out.capacity)))
            return out

        mp.setattr(mod._Tracer, "_mat_inner", mat)


def _run_both(name, jgen, tgen, capacity):
    """(JAX result, port result, JAX routes, port routes, JAX restarts,
    port stats, port runner, JAX capacities, port capacities as the JAX
    tracer reckons them, the port's own batch capacities)."""
    with pytest.MonkeyPatch.context() as mp:
        jrec, trec = _Recorder(mp, jfused), _Recorder(mp, tfused)
        with jstats.query_stats() as jcol:
            want = jcollect(_flow(jq, name, jgen, capacity), fuse=True)
        flow = _flow(tq, name, tgen, capacity)
        with stats.query_stats() as tcol:
            got = tcollect(flow, device="cpu", fuse=True)
    jexec = jcol.stages.get("fused.exec")
    j_restarts = (jexec.events if jexec else 0) - 1
    return (want, got, dict(jrec.routes), dict(trec.routes), j_restarts,
            tcol, flow._fused_runner, jrec.caps, trec.caps, trec.real)


@pytest.fixture(scope="module")
def gens():
    return jtpch.TPCH(sf=SF), ttpch.TPCH(sf=SF)


@pytest.fixture(scope="module")
def results(gens):
    return {name: _run_both(name, *gens, CAPACITY) for name in QUERIES}


def _events(col, name):
    s = col.stages.get(name)
    return s.events if s else 0


@pytest.mark.parametrize("name", QUERIES)
def test_fused_query_matches_jax_fused(results, name):
    want, got, _jr, _tr, _jn, tcol, runner, *_ = results[name]
    _assert_equal_results(want, got)
    assert len(got[next(iter(got))]) > 0
    # the port stayed on the fused tier
    assert runner is not None and runner.last["mode"] == "eager"
    assert not [e for e in tcol.stages if e.startswith(LEFT_FUSED)]


@pytest.mark.parametrize("name", QUERIES)
def test_fused_query_matches_oracle(results, gens, name, monkeypatch):
    """Each fused result against the query's oracle (chip_smoke.py's
    checks, which phase 9 runs at SF 1)."""
    _want, got, *_ = results[name]
    tgen = gens[1]
    if name == "q1":
        lineitem = tgen.schema("lineitem").dicts
        chip_smoke.check_q1(got, tq.q1_oracle(tgen),
                            lineitem["l_returnflag"],
                            lineitem["l_linestatus"])
        return
    monkeypatch.setattr(chip_smoke, "Q18_THRESHOLD", Q18_THRESHOLD)
    assert chip_smoke.query_rows(name, got) \
        == chip_smoke.query_oracle(name, tgen)


@pytest.mark.parametrize("name", QUERIES)
def test_fused_routes_match_jax(results, name):
    _want, _got, jroutes, troutes, *_ = results[name]
    assert troutes == jroutes
    assert ("_try_groupjoin" in troutes) == (name in ("q3", "q18"))
    assert ("_try_int_agg" in troutes) == (name in ("q15", "q17", "q18"))


@pytest.mark.parametrize("name", QUERIES)
def test_fused_restarts_match_jax(results, name):
    _w, _g, _jr, _tr, j_restarts, tcol, *_ = results[name]
    t_restarts = _events(tcol, "flow.restart")
    assert t_restarts == j_restarts


@pytest.mark.parametrize("name", QUERIES)
def test_fused_carry_joins_match_jax(results, name):
    """The payload-carry joins the port's tracer builds are the JAX
    tracer's, query by query."""
    _want, _got, jroutes, troutes, *_ = results[name]
    assert troutes.get("carry", 0) == jroutes.get("carry", 0)


@pytest.mark.parametrize("name", ["q3", "q18"])
def test_fused_capacities_match_jax_unpadded_chunks(gens, name):
    """At capacity 2^12 lineitem spans 15 chunks: the JAX image pads to
    16, the port's holds 15. Every batch the port's tracer materializes
    has, as its tracer reckons it, the capacity of the JAX tracer's, so
    the routes, capacities and rows are the same; the port's lineitem
    batch holds only the 15 real chunks' lanes."""
    jgen, tgen = gens
    capacity = 1 << 12
    assert -(-tgen.num_rows("lineitem") // capacity) == 15
    want, got, jroutes, troutes, _jn, _col, runner, jcaps, tcaps, treal = \
        _run_both(name, jgen, tgen, capacity)
    _assert_equal_results(want, got)
    assert troutes == jroutes and troutes
    assert tcaps == jcaps
    assert ("ScanOp", 16 * capacity) in tcaps
    assert ("ScanOp", 15 * capacity) in treal
    assert ("ScanOp", 16 * capacity) not in treal
    assert runner.last["mode"] == "eager"


# ------------------------------------------------- tests/test_fused.py

def _int_scans(data, capacity, chunk=None):
    """(JAX ScanOp, port ScanOp) over the same int64 columns, in chunks
    of `chunk` rows (one chunk by default)."""
    n = len(next(iter(data.values())))
    chunk = chunk or n

    def chunks():
        for a in range(0, n, chunk):
            yield {k: v[a:a + chunk] for k, v in data.items()}

    jscan = jops.ScanOp(jbatch.Schema([jbatch.Field(k, jbatch.INT)
                                       for k in data]), chunks, capacity)
    tscan = tops.ScanOp(Schema([Field(k, INT) for k in data]), chunks,
                        capacity)
    return jscan, tscan


def _sorted_rows(res, names):
    cols = [np.asarray(res[n]) for n in names]
    order = np.lexsort(cols[::-1])
    return [tuple(c[i] for c in cols) for i in order]


def test_fused_join_overflow_restarts():
    """Every probe row matches every build row: 64 pairs exceed the
    first output capacity (8), and the restarts double the expansion
    until they fit, as in the JAX runner."""
    out = {}
    for mod, idx in ((jops, 0), (tops, 1)):
        probe = _int_scans({"a": np.zeros(8, np.int64)}, 8)[idx]
        build = _int_scans({"b": np.zeros(8, np.int64),
                            "bv": np.arange(8, dtype=np.int64)}, 8)[idx]
        join = mod.JoinOp(probe, build, ["a"], ["b"], how="inner")
        if mod is tops:
            assert tfused.try_compile(join) is not None
            with stats.query_stats() as col:
                out["port"] = tcollect(join, device="cpu")
            assert join._fused_runner.last["mode"] == "eager"
            assert _events(col, "flow.restart") >= 3
        else:
            out["jax"] = jcollect(join)
        assert join.expansion >= 8
    assert len(out["port"]["bv"]) == 64
    _assert_equal_results(out["jax"], out["port"])


def test_fused_agg_overflow_restarts():
    """More groups than the accumulator: the hash fold's overflow flag
    restarts the fused program until the accumulator holds all 64
    groups. The workmem keeps the materialized input (64 x 24 bytes)
    out, so the fold runs, and lets the 64-group accumulator (64 x 16
    bytes) in. (The JAX test's next step, past workmem into the grace
    aggregation, waits for the out-of-core paths.)"""
    n = 64
    data = {"k": np.arange(n, dtype=np.int64),
            "v": np.ones(n, dtype=np.int64),
            "pad": np.zeros(n, dtype=np.int64)}
    res = {}
    for mod, idx in ((jops, 0), (tops, 1)):
        scan = _int_scans(data, 8, chunk=8)[idx]
        if mod is jops:
            agg = jops.HashAggOp(scan, ["k"], [JAggSpec("sum", "v", "s")],
                                 workmem=1200)
            res["jax"] = jcollect(agg)
        else:
            agg = tops.HashAggOp(scan, ["k"], [AggSpec("sum", "v", "s")])
            agg.workmem = 1200
            with stats.query_stats() as col:
                res["port"] = tcollect(agg, device="cpu")
            assert agg._fused_runner.last == {"mode": "eager",
                                              "routes": {"fold": 1}}
            assert _events(col, "flow.restart") == 3
        assert agg.expansion == 8
    got = sorted(zip(res["port"]["k"].tolist(), res["port"]["s"].tolist()))
    assert got == [(k, 1) for k in range(n)]
    assert _sorted_rows(res["port"], ["k", "s"]) \
        == _sorted_rows(res["jax"], ["k", "s"])


def test_fused_falls_back_on_custom_operator():
    class Weird(tops.SortOp):
        pass

    _j, scan = _int_scans({"k": np.arange(4, dtype=np.int64)}, 4)
    # a subclass of a supported operator still fuses; an unknown type not
    assert tfused.try_compile(Weird(scan, [SortKey("k")])) is not None

    class Custom(tops.Operator):
        schema = scan.schema

        def batches(self, device):
            yield from scan.batches(device)

    op = Custom()
    assert tfused.try_compile(op) is None
    assert tcollect(op, device="cpu")["k"].tolist() == [0, 1, 2, 3]


def test_fused_empty_scan_falls_back():
    schema = Schema([Field("k", INT)])
    scan = tops.ScanOp(schema, lambda: iter(()), 4)
    agg = tops.HashAggOp(scan, [], [AggSpec("count_star", None, "c")])
    with stats.query_stats() as col:
        res = tcollect(agg, device="cpu")
    # a scalar aggregate over no rows: one row, count 0
    assert list(res["c"]) == [0]
    assert _events(col, "fused.fallback_unsupported") == 1
    assert agg._fused_runner.last == {"mode": "streaming",
                                      "unsupported": "empty scan"}


def _gj_flows(mod, pk, pv, bk, bd, key_side, chunk):
    jidx = 0 if mod is jops else 1
    probe = _int_scans({"fk": pk, "v": pv}, chunk, chunk=chunk)[jidx]
    build = _int_scans({"k": bk, "d": bd}, len(bk))[jidx]
    spec = JAggSpec if mod is jops else AggSpec
    join = mod.JoinOp(probe, build, ["fk"], ["k"], how="inner")
    return mod.HashAggOp(join, [key_side, "d"],
                         [spec("sum", "v", "s"), spec("count_star", None, "n"),
                          spec("avg", "v", "m")])


@pytest.mark.parametrize("key_side", ["k", "fk"])
def test_groupjoin_collapse_matches_streaming(key_side):
    """The aggregate-over-join collapse is invisible: the same rows as
    the port's streaming JoinOp + HashAggOp, and as the JAX package's
    fused runner, grouped on the probe or the build join column."""
    rng = np.random.default_rng(7)
    nb, np_ = 32, 200
    bk = rng.permutation(500)[:nb]
    bd = rng.integers(100, 4000, nb)
    pk = rng.integers(0, 500, np_)
    pv = rng.integers(-30, 90, np_)
    agg = _gj_flows(tops, pk, pv, bk, bd, key_side, 64)  # 4 chunks of 64
    assert tfused.try_compile(agg) is not None
    fused = tcollect(agg, device="cpu", fuse=True)
    assert agg._fused_runner.last["routes"] == {"groupjoin": 1}
    streamed = tcollect(_gj_flows(tops, pk, pv, bk, bd, key_side, 64),
                        device="cpu", fuse=False)
    names = [key_side, "d", "s", "n", "m"]
    assert _sorted_rows(fused, names) == _sorted_rows(streamed, names)
    jres = jcollect(_gj_flows(jops, pk, pv, bk, bd, key_side, 64),
                    fuse=True)
    _assert_equal_results(jres, fused)


def test_groupjoin_duplicate_build_falls_back_correct():
    """Duplicate build keys raise the collapse's fallback flag: the first
    restart widens its keys, the second takes the general route, and
    the rows equal the streaming path's and the JAX runner's."""
    rng = np.random.default_rng(9)
    bk = rng.integers(0, 20, 32)            # duplicates guaranteed
    bd = rng.integers(0, 100, 32)
    pk = rng.integers(0, 25, 100)
    pv = rng.integers(0, 50, 100)

    def flow(mod):
        jidx = 0 if mod is jops else 1
        probe = _int_scans({"fk": pk, "v": pv}, 50, chunk=50)[jidx]
        build = _int_scans({"k": bk, "d": bd}, 32)[jidx]
        spec = JAggSpec if mod is jops else AggSpec
        return mod.HashAggOp(
            mod.JoinOp(probe, build, ["fk"], ["k"], how="inner"),
            ["fk", "d"], [spec("sum", "v", "s")])

    agg = flow(tops)
    with stats.query_stats() as col:
        fused = tcollect(agg, device="cpu", fuse=True)
    assert agg._gj_bump == 2
    assert _events(col, "flow.restart") >= 2
    assert agg._fused_runner.last["mode"] == "eager"
    streamed = tcollect(flow(tops), device="cpu", fuse=False)
    names = ["fk", "d", "s"]
    assert _sorted_rows(fused, names) == _sorted_rows(streamed, names)
    assert _sorted_rows(fused, names) \
        == _sorted_rows(jcollect(flow(jops), fuse=True), names)


def test_fused_respects_workmem_fallback():
    """A sort whose materialized input passes workmem leaves the fused
    tier: 3 chunks of 4 rows, which the JAX image pads to 4 chunks, so
    the fused sort would hold 16 x 8 bytes, past a 100-byte workmem,
    while the streaming SortOp holds the 12 rows in 96 bytes. The port
    falls back as the JAX runner does, by the same workmem rule."""
    data = {"k": np.arange(12, dtype=np.int64)[::-1].copy()}
    jscan, tscan = _int_scans(data, 4, chunk=4)
    srt = tops.SortOp(tscan, [SortKey("k")])
    srt.workmem = 100
    with stats.query_stats() as col:
        res = tcollect(srt, device="cpu")
    np.testing.assert_array_equal(res["k"], np.arange(12))
    assert _events(col, "fused.fallback_unsupported") == 1
    assert srt._fused_runner.last == {"mode": "streaming",
                                      "unsupported": "sort exceeds workmem"}
    jsrt = jops.SortOp(jscan, [JSortKey("k")], workmem=100)
    _assert_equal_results(jcollect(jsrt), res)


def test_fused_shared_float_product():
    """A float product with two consumers in one fused program,
    f*g + h and f*g - k: the JAX package's whole-query program rounds
    both as fused multiply-adds, and so does the port; every lane equal
    bit for bit (NaN lanes compare as NaN)."""
    rng = np.random.default_rng(20261017)
    n = 4096
    cols = {c: (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n))
            .astype(np.float32) for c in "fghk"}
    C = jx.Col
    prod = jx.BinOp("*", C("f"), C("g"))
    proj = [("a", jx.BinOp("+", prod, C("h"))),
            ("b", jx.BinOp("-", prod, C("k"))),
            ("c", jx.BinOp("-", C("h"), jx.BinOp("*", C("f"), C("g"))))]

    def chunks():
        for a in range(0, n, 1024):
            yield {k: v[a:a + 1024] for k, v in cols.items()}

    jschema = jbatch.Schema([jbatch.Field(c, jbatch.FLOAT) for c in "fghk"])
    jflow = jops.MapOp(jops.ScanOp(jschema, chunks, 1024),
                       [("project", proj)])
    tschema = Schema([Field(c, FLOAT) for c in "fghk"])
    tflow = tops.MapOp(tops.ScanOp(tschema, chunks, 1024),
                       [("project", [(nm, to_port(e)) for nm, e in proj])])
    want = jcollect(jflow, fuse=True)
    got = tcollect(tflow, device="cpu", fuse=True)
    assert tflow._fused_runner.last["mode"] == "eager"
    f, g, h, k = (cols[c].astype(np.float64) for c in "fghk")
    fma_a = (f * g + h).astype(np.float32)
    for name in ("a", "b", "c"):
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      want[name].view(np.int32),
                                      err_msg=name)
    # both consumers contract: a is the once-rounded f*g + h
    assert (got["a"] == fma_a).mean() > 0.999


# ------------------------------------------------------------ the ladder

def _q6(tgen):
    return tq.q6(tgen, CAPACITY)


@pytest.mark.parametrize("exc", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.00 GiB"),
    MemoryError("host memory"),
    BudgetExceededError("hbm", 1 << 30, 1 << 29, 1 << 28),
], ids=["cuda_oom", "memory_error", "budget"])
def test_ladder_resource_error_degrades_to_streaming(gens, monkeypatch, exc):
    tgen = gens[1]
    want = tcollect(_q6(tgen), device="cpu", fuse=False)

    def boom(self, op):
        raise exc

    monkeypatch.setattr(tfused._Tracer, "_mat", boom)
    flow = _q6(tgen)
    with stats.query_stats() as col:
        got = tcollect(flow, device="cpu", fuse=True)
    _assert_equal_results(want, got)
    assert _events(col, "resilience.degrade.fused") == 1
    assert tcircuit.breaker("flow.fused").state() == tcircuit.CLOSED


def test_ladder_terminal_error_propagates(gens, monkeypatch):
    def boom(self, op):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(tfused._Tracer, "_mat", boom)
    with stats.query_stats() as col:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            tcollect(_q6(gens[1]), device="cpu", fuse=True)
    assert not [e for e in col.stages if e.startswith("resilience.")]


def test_ladder_breaker_skips_a_failing_tier(gens, monkeypatch):
    """Five consecutive RESOURCE failures trip the fused tier's breaker
    open; the next query skips the tier."""
    tgen = gens[1]

    def boom(self, op):
        raise MemoryError("no room")

    monkeypatch.setattr(tfused._Tracer, "_mat", boom)
    for _ in range(5):
        tcollect(_q6(tgen), device="cpu")
    assert tcircuit.breaker("flow.fused").state() == tcircuit.OPEN
    with stats.query_stats() as col:
        got = tcollect(_q6(tgen), device="cpu")
    assert _events(col, "resilience.skip.fused") == 1
    assert got["revenue"].tolist() == [tq.q6_oracle(tgen)]


def test_classify():
    R, T, X = tretry.RESOURCE, tretry.TERMINAL, tretry.RETRYABLE
    cases = [
        (torch.cuda.OutOfMemoryError("CUDA out of memory"), R),
        (MemoryError(), R),
        (BudgetExceededError("x", 2, 1, 0), R),
        (RuntimeError("RESOURCE_EXHAUSTED: hbm"), R),
        (RuntimeError("CUDA error: an illegal memory access was "
                      "encountered"), T),
        (RuntimeError("dense_sums kernel launch failed: CUDA error 700"), T),
        (RuntimeError("CUDA error: out of memory"), T),
        (tops.FlowRestart(object()), X),
        (ConnectionError("reset"), X),
        (TimeoutError(), X),
        (RuntimeError("UNAVAILABLE: link"), X),
        (ValueError("bad plan"), T),
        (NotImplementedError("grace join"), T),
    ]
    for exc, want in cases:
        assert tretry.classify(exc) == want, exc
    # the verdicts the JAX classifier gives the same messages
    for msg in ("RESOURCE_EXHAUSTED: hbm", "UNAVAILABLE: link", "bad plan"):
        assert tretry.classify(RuntimeError(msg)) \
            == jretry.classify(RuntimeError(msg))


def test_circuit_breaker_matches_jax():
    """The same calls on both packages' breakers, under one fake clock,
    give the same states."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    tb = tcircuit.CircuitBreaker("t", threshold=2, cooldown_s=5.0,
                                 clock=clock)
    jb = jcircuit.CircuitBreaker("j", threshold=2, cooldown_s=5.0,
                                 clock=clock)
    steps = ["allow", "failure", "allow", "failure", "allow", "tick",
             "allow", "allow", "failure", "tick", "allow", "success",
             "allow", "failure", "reset", "allow"]
    for step in steps:
        if step == "tick":
            now[0] += 6.0
            continue
        got = getattr(tb, step)()
        want = getattr(jb, step)()
        assert got == want, step
        assert tb.state() == jb.state(), step


def test_retry_policy_matches_jax():
    """The backoff sequence and with_retry's verdicts equal the JAX
    package's."""
    t_opts = tretry.Options(sleep=lambda s: None)
    j_opts = jretry.Options(sleep=lambda s: None)
    assert list(t_opts.backoffs()) == list(j_opts.backoffs())
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("reset")
        return "ok"

    with stats.query_stats() as col:
        assert tretry.with_retry(flaky, tretry.Options(
            sleep=lambda s: None), name="t") == "ok"
    assert _events(col, "resilience.retry.t") == 2
    with pytest.raises(MemoryError):
        tretry.with_retry(lambda: (_ for _ in ()).throw(MemoryError()),
                          tretry.Options(sleep=lambda s: None))
    defaults = tretry.options_from_settings()
    assert defaults.max_retries == jretry.options_from_settings().max_retries


# ------------------------------------------------------------- on the card

CARD_QUERIES = ("q1", "q3", "q4", "q18")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_QUERIES)
def test_graph_replay_matches_eager_on_card(gens, name):
    """Every scan resident: the cold run captures the query's graph, the
    next run replays it, and both equal the eager program on the card
    (a flow whose scans are not resident) and on the CPU, bit for bit
    (chip_smoke.py phase 9 runs the fifteen queries at SF 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 9 runs the "
                    "fused queries at SF 1 there)")
    tgen = gens[1]
    cpu = tcollect(_flow(tq, name, tgen, CAPACITY), device="cpu")
    eager_flow = _flow(tq, name, tgen, CAPACITY)
    for sc in [o for o in tops.walk_operators(eager_flow)
               if isinstance(o, tops.ScanOp)]:
        sc.cache_key = None
    eager = tcollect(eager_flow, device="cuda")
    assert eager_flow._fused_runner.last["mode"] == "eager"
    flow = _flow(tq, name, tgen, CAPACITY)
    for sc in [o for o in tops.walk_operators(flow)
               if isinstance(o, tops.ScanOp)]:
        sc.resident = True
    cold = tcollect(flow, device="cuda")
    assert flow._fused_runner.last["mode"] in ("eager", "capture")
    runs = [tcollect(flow, device="cuda") for _ in range(2)]
    assert flow._fused_runner.last["mode"] == "replay"
    for got in [cold] + runs:
        _assert_equal_results(eager, got)
        _assert_equal_results(cpu, got)


def test_groupjoin_float_inputs_take_the_general_route():
    """A float32 SUM over an aggregate-over-join: the JAX tracer lets it
    ride the collapse, whose cumsums add the float's raw bits as int64
    (a fault of the reference: 1.5 + 2.25 comes out as 2144337920, and
    the packed result reads 8-byte sums as 4-byte floats). The port's
    tracer sends float inputs to the general route; its sums equal the
    streaming operators' within float32's 1e-5 relative tolerance (the
    two add in different orders)."""
    rng = np.random.default_rng(11)
    nb, np_ = 16, 200
    bk = rng.permutation(100)[:nb]
    pk = rng.integers(0, 100, np_)
    pv = rng.standard_normal(np_).astype(np.float32)

    def flow():
        probe = tops.ScanOp(Schema([Field("fk", INT), Field("v", FLOAT)]),
                            lambda: iter([{"fk": pk, "v": pv}]), 64)
        build = _int_scans({"k": bk}, nb)[1]
        return tops.HashAggOp(
            tops.JoinOp(probe, build, ["fk"], ["k"], how="inner"), ["fk"],
            [AggSpec("sum", "v", "s"), AggSpec("count_star", None, "n")])

    agg = flow()
    fused = tcollect(agg, device="cpu", fuse=True)
    assert agg._fused_runner.last["routes"] == {"mat": 1}
    streamed = tcollect(flow(), device="cpu", fuse=False)
    f, s = (sorted(zip(r["fk"].tolist(), r["s"].tolist(), r["n"].tolist()))
            for r in (fused, streamed))
    assert [(k, n) for k, _v, n in f] == [(k, n) for k, _v, n in s]
    np.testing.assert_allclose([v for _k, v, _n in f],
                               [v for _k, v, _n in s], rtol=1e-5)
    want = {}
    for k, v in zip(pk, pv):
        if k in set(bk.tolist()):
            want[int(k)] = want.get(int(k), 0.0) + float(v)
    np.testing.assert_allclose([v for _k, v, _n in f],
                               [want[k] for k, _v, _n in f], rtol=1e-5,
                               atol=1e-5)


def test_capture_holds_rank_tables_past_eviction(gens):
    """A CUDA graph reads Q1's ORDER BY rank tables (its string keys) by
    address. While a capture records, every table the program reads is
    appended to the graph's holds: evicting the cache's entries (256 new
    dictionaries) leaves the held tables alive and unchanged, and a
    trace after the eviction builds equal ones."""
    from cockroach_tpu_torch.ops import sort as tsort

    flow = _flow(tq, "q1", gens[1], CAPACITY)
    runner = tfused.FusedRunner(flow)
    images, _vkey = runner._prepare(torch.device("cpu"))
    held = []
    tsort.hold_rank_tables(held)
    try:
        first = runner._trace(images)
    finally:
        tsort.hold_rank_tables(None)
    assert len(held) == 2   # l_returnflag, l_linestatus
    copies = [t.clone() for t in held]
    for i in range(tsort._RANK_TABLES_MAX):
        schema = Schema([Field("s", STRING, dict_ref="s")],
                        {"s": np.array([f"x{i}", "a"], dtype=object)})
        tsort._string_rank_table(schema, "s", "cpu")
    assert not any(t is h for _d, t in tsort._RANK_TABLES.values()
                   for h in held)
    for t, c in zip(held, copies):
        assert torch.equal(t, c)
    again = runner._trace(images)
    assert torch.equal(first.packed, again.packed)


@pytest.mark.cuda
def test_graph_replay_after_rank_table_eviction_on_card(gens):
    """Q1's graph replays correctly after the rank tables it captured
    were evicted from the cache and their memory handed to new tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph replays only there)")
    from cockroach_tpu_torch.ops import sort as tsort

    tgen = gens[1]
    want = tcollect(_flow(tq, "q1", tgen, CAPACITY), device="cpu")
    flow = _flow(tq, "q1", tgen, CAPACITY)
    for sc in [o for o in tops.walk_operators(flow)
               if isinstance(o, tops.ScanOp)]:
        sc.resident = True
    tcollect(flow, device="cuda")
    tcollect(flow, device="cuda")
    assert flow._fused_runner.last["mode"] == "replay"
    tsort._RANK_TABLES.clear()
    torch.cuda.empty_cache()
    # new tensors of the tables' size, filled with what a freed table's
    # memory would then hold
    junk = [torch.full((8,), 7, dtype=torch.int32, device="cuda")
            for _ in range(256)]
    got = tcollect(flow, device="cuda")
    assert flow._fused_runner.last["mode"] == "replay"
    _assert_equal_results(want, got)
    del junk
