"""The join and aggregate routes the port took on in its out-of-core
slice, against the JAX package's, on the CPU:

- the payload-carry join (ops/sortjoin.py prepare_unique(carry=True),
  _probe_carry, probe_unique's dispatch and its lazy row matrix) bit for
  bit against the JAX functions, for inner/left/semi/anti with each of
  its fallback flags raised (a duplicate build key, a key outside
  [0, 2^30), a payload over 62 bits) and for right/outer through the
  lazily built row matrix;
- merge_join (ops/join.py) against the JAX function for the six join
  types, and its hash_join fallback for float and two-column keys;
- range_dense_aggregate and HashAggOp(dense_range=...) against
  tests/test_ops.py's cases and the JAX HashAggOp on both tiers, the
  out-of-range flag and the restart that turns the route off included;
- exec/invariants.py check_batch and CheckedOp against
  tests/test_observability.py's cases; a checked Q3 build equals its
  oracle, and the fused tier declines it.

The `cuda`-marked twins run the same routes on a CUDA batch and hold them
to the CPU results; they skip without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.ops import agg as jagg
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.ops import sortjoin as jsortjoin
from cockroach_tpu_torch.coldata.batch import (
    Batch, Column, Field, INT, Schema, concat_batches,
)
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import operators as tops
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.exec.invariants import (
    INVARIANTS, CheckedOp, InvariantViolation, check_batch,
)
from cockroach_tpu_torch.ops import agg as tagg
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import sortjoin as tsortjoin
from cockroach_tpu_torch.util.settings import Settings
from test_torch_join import assert_same_batch, jax_batch, port_batch
from torch_threads import one_torch_thread  # noqa: F401

HOWS = ("inner", "left", "semi", "anti", "right", "outer")
CARRY_HOWS = ("inner", "left", "semi", "anti")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _to(b: Batch, device) -> Batch:
    return Batch({n: Column(c.values.to(device),
                            None if c.validity is None
                            else c.validity.to(device))
                  for n, c in b.columns.items()},
                 b.sel.to(device), b.length.to(device))


def _cpu(b: Batch) -> Batch:
    return _to(b, "cpu")


# --------------------------------------------------------- payload carry

def _carry_sides(case: str, seed: int = 7):
    """(JAX probe, JAX build) for one carry case: unique int keys in
    [0, 2^30) with NULL keys and dead lanes on both sides, an int64, an
    int32, a nullable int, a float32 and a bool payload; `case` raises
    one fallback flag."""
    rng = np.random.default_rng(seed)
    rcap, lcap = 96, 160
    keys = rng.permutation(np.arange(10, 400))[:rcap].astype(np.int64)
    bsel = rng.random(rcap) > 0.1
    bkv = rng.random(rcap) > 0.05
    wide = rng.integers(0, 1 << 10, rcap).astype(np.int64)
    if case == "dup":
        keys[5] = keys[9]
        bsel[5] = bsel[9] = True
        bkv[5] = bkv[9] = True
    elif case == "range":
        keys[3] = 1 << 31
        bsel[3] = bkv[3] = True
    elif case == "wide":
        wide = rng.integers(-(1 << 61), 1 << 61, rcap).astype(np.int64)
    build = {
        "bk": (keys, bkv),
        "bw": (wide, None),
        "b32": (rng.integers(-5000, 5000, rcap).astype(np.int32), None),
        "bn": (rng.integers(0, 9, rcap).astype(np.int64),
               rng.random(rcap) > 0.3),
        "bf": (rng.standard_normal(rcap).astype(np.float32), None),
        "bb": (rng.random(rcap) > 0.5, None),
    }
    pk = rng.choice(np.concatenate([keys, np.arange(500, 540)]), lcap)
    probe = {"pk": (pk.astype(np.int64), rng.random(lcap) > 0.05),
             "pv": (np.arange(lcap, dtype=np.int64), None)}
    return (jax_batch(probe, rng.random(lcap) > 0.1),
            jax_batch(build, bsel))


def _carry_both(case, how, device="cpu"):
    jl, jr = _carry_sides(case)
    jub = jsortjoin.prepare_unique(jr, ("bk",), carry=True)
    want = jsortjoin.probe_unique(jl, jub, ("pk",), how=how)
    tub = tsortjoin.prepare_unique(_to(port_batch(jr), device), ("bk",),
                                   carry=True)
    got = tsortjoin.probe_unique(_to(port_batch(jl), device), tub, ("pk",),
                                 how=how)
    return jub, tub, want, got


def _probe_carry_cummax(case, how):
    """The port's _probe_carry with the JAX package's two-cummax
    broadcast."""
    jl, jr = _carry_sides(case)
    tl = port_batch(jl)
    tub = tsortjoin.prepare_unique(port_batch(jr), ("bk",), carry=True)
    p_packed, p_range = tsortjoin._pack_keys(tl, ("pk",), 1, tub.seed,
                                             tub.key_kind, narrow=tub.narrow)
    return tsortjoin._probe_carry(tl, tub, ("pk",), how, p_packed, p_range,
                                  broadcast=tsortjoin._broadcast_cummax)


@pytest.mark.parametrize("case", ["plain", "dup", "range", "wide"])
@pytest.mark.parametrize("how", CARRY_HOWS)
def test_probe_carry_matches_jax(case, how):
    """_probe_carry with the JAX package's broadcast equals the JAX
    function bit for bit, flags raised or not; probe_unique (the
    cummax-free broadcast) equals it wherever each run holds at most one
    build lane and the payload fits 62 bits (the flag is clear, or raised
    only by a key out of range). A duplicate key or a wider payload
    raises the flag, and the restart discards the output."""
    jub, tub, want, got = _carry_both(case, how)
    assert jub.payv is not None and tub.payv is not None
    assert jub.packed.dtype == jnp.uint32 and tub.narrow
    np.testing.assert_array_equal(tub.packed.numpy(),
                                  np.asarray(jub.packed).astype(np.int64))
    np.testing.assert_array_equal(tub.payv.numpy(),
                                  np.asarray(jub.payv).view(np.int64))
    exact = _probe_carry_cummax(case, how)
    assert_same_batch(want.batch, exact.batch, f"{case} {how}")
    assert bool(exact.overflow) == bool(want.overflow) == (case != "plain")
    assert bool(got.overflow) == bool(want.overflow)
    assert got.matched_build is None and want.matched_build is None
    if case in ("plain", "range"):
        assert_same_batch(want.batch, got.batch, f"{case} {how}")


@pytest.mark.parametrize("how", CARRY_HOWS)
def test_carry_broadcast_heads_matches_cummax(how):
    """The cummax-free broadcast against the two-cummax one on the
    duplicate-key case: the same flag, selection and length, and every
    probe lane outside the duplicated key's run bit for bit (inside it
    each lane takes the run head's payload, where the cummaxes mix the
    build lanes' halves; the flag discards that output)."""
    jl, jr = _carry_sides("dup")
    exact = _probe_carry_cummax("dup", how)
    _j, _t, _w, got = _carry_both("dup", how)
    assert bool(got.overflow) and bool(exact.overflow)
    assert torch.equal(got.batch.sel, exact.batch.sel)
    assert int(got.batch.length) == int(exact.batch.length)
    dup_key = int(np.asarray(jr.col("bk").values)[5])
    outside = port_batch(jl).col("pk").values != dup_key
    assert int((~outside).sum()) > 0
    for n in exact.batch.columns:
        a, b = exact.batch.col(n), got.batch.col(n)
        assert torch.equal(a.values[outside], b.values[outside]), n
        if a.validity is not None:
            assert torch.equal(a.validity[outside], b.validity[outside]), n


@pytest.mark.parametrize("run_rate", [0.05, 0.3, 0.9])
def test_carry_broadcasts_agree(run_rate):
    """The two broadcasts themselves, lane for lane, over sorted lanes
    whose runs hold at most one build lane (at the head) and 62-bit
    payloads, at three run lengths."""
    rng = np.random.default_rng(13)
    n = 4096
    newrun = torch.from_numpy(rng.random(n) < run_rate)
    newrun[0] = True
    is_build = newrun & torch.from_numpy(rng.random(n) < 0.6)
    s_val = torch.from_numpy(rng.integers(0, 1 << 62, n, dtype=np.int64))
    ha, pa = tsortjoin._broadcast_cummax(s_val, newrun, is_build)
    hb, pb = tsortjoin._broadcast_heads(s_val, newrun, is_build)
    assert torch.equal(ha, hb)
    assert torch.equal(pa, pb)


@pytest.mark.parametrize("how", ["right", "outer"])
def test_carry_build_lazy_row_matrix_matches_jax(how):
    """A carry-prepared build on a path the carry does not cover builds
    its row matrix and 64-bit keys at probe time, as the JAX function
    does."""
    _jub, _tub, want, got = _carry_both("plain", how)
    assert_same_batch(want.batch, got.batch, how)
    np.testing.assert_array_equal(got.matched_build.numpy(),
                                  np.asarray(want.matched_build))
    assert bool(got.overflow) == bool(want.overflow) is False


def test_carry_declines_unpackable_and_hash_keys():
    """A two-column key (the hash kind) and a float64 payload column take
    the row matrix, as in the JAX package."""
    jl, jr = _carry_sides("plain")
    tr = port_batch(jr)
    ub = tsortjoin.prepare_unique(tr, ("bk", "bw"), carry=True)
    assert ub.payv is None and ub.mat is not None and ub.key_kind == "hash"
    wide = Batch(dict(tr.columns, bd=Column(
        torch.zeros(tr.capacity, dtype=torch.float64))), tr.sel, tr.length)
    ub = tsortjoin.prepare_unique(wide, ("bk",), carry=True)
    assert ub.payv is None and ub.mat is not None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "dup"])
@pytest.mark.parametrize("how", CARRY_HOWS)
def test_probe_carry_on_cuda_matches_cpu(case, how):
    _needs_cuda()
    _j, _t, _w, cpu = _carry_both(case, how)
    _j, _t, _w, dev = _carry_both(case, how, device="cuda")
    assert_same_batch_port(cpu.batch, _cpu(dev.batch), f"{case} {how}")
    assert bool(cpu.overflow) == bool(dev.overflow)


def assert_same_batch_port(a: Batch, b: Batch, what: str):
    assert torch.equal(a.sel, b.sel), what
    assert int(a.length) == int(b.length), what
    assert list(a.columns) == list(b.columns), what
    for n in a.columns:
        ca, cb = a.col(n), b.col(n)
        assert torch.equal(ca.values, cb.values), f"{what}: {n}"
        assert (ca.validity is None) == (cb.validity is None), f"{what}: {n}"
        if ca.validity is not None:
            assert torch.equal(ca.validity, cb.validity), f"{what}: {n}"


# ------------------------------------------------------------ merge join

def _merge_sides(seed=11):
    """Probe with NULL keys and dead lanes; build sorted on its key, with
    repeated keys and NULL and dead lanes interleaved."""
    rng = np.random.default_rng(seed)
    rcap, lcap = 48, 64
    bk = np.sort(rng.integers(0, 30, rcap)).astype(np.int64)
    build = {"bk": (bk, rng.random(rcap) > 0.1),
             "bv": (np.arange(rcap, dtype=np.int64), None)}
    probe = {"pk": (rng.integers(0, 35, lcap).astype(np.int64),
                    rng.random(lcap) > 0.1),
             "pv": (np.arange(lcap, dtype=np.int64), None)}
    return (jax_batch(probe, rng.random(lcap) > 0.1),
            jax_batch(build, rng.random(rcap) > 0.1))


@pytest.mark.parametrize("how", HOWS)
def test_merge_join_matches_jax(how):
    jl, jr = _merge_sides()
    for cap in (None, 16, 512):
        want = jjoin.merge_join(jl, jr, ["pk"], ["bk"], how=how,
                                out_capacity=cap)
        got = tjoin.merge_join(port_batch(jl), port_batch(jr), ["pk"],
                               ["bk"], how=how, out_capacity=cap)
        assert_same_batch(want.batch, got.batch, f"{how} {cap}")
        assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_merge_join_falls_back_to_hash_join(how):
    jl, jr = _carry_sides("plain")
    for lon, ron in ((["pk", "pv"], ["bk", "bw"]),):
        want = jjoin.merge_join(jl, jr, lon, ron, how=how)
        got = tjoin.merge_join(port_batch(jl), port_batch(jr), lon, ron,
                               how=how)
        assert_same_batch(want.batch, got.batch, how)
    rng = np.random.default_rng(5)
    fl = jax_batch({"a": (rng.integers(0, 5, 32).astype(np.float32), None)},
                   np.ones(32, bool))
    fr = jax_batch({"b": (np.arange(8, dtype=np.float32), None),
                    "v": (np.arange(8, dtype=np.int64), None)},
                   np.ones(8, bool))
    want = jjoin.merge_join(fl, fr, ["a"], ["b"], how=how)
    got = tjoin.merge_join(port_batch(fl), port_batch(fr), ["a"], ["b"],
                           how=how)
    assert_same_batch(want.batch, got.batch, f"float {how}")


@pytest.mark.cuda
@pytest.mark.parametrize("how", HOWS)
def test_merge_join_on_cuda_matches_cpu(how):
    _needs_cuda()
    jl, jr = _merge_sides()
    tl, tr = port_batch(jl), port_batch(jr)
    cpu = tjoin.merge_join(tl, tr, ["pk"], ["bk"], how=how)
    dev = tjoin.merge_join(_to(tl, "cuda"), _to(tr, "cuda"), ["pk"], ["bk"],
                           how=how)
    assert_same_batch_port(cpu.batch, _cpu(dev.batch), how)


# ------------------------------------------------------------ range dense

_RD_AGGS = (("sum", "v", "s"), ("count_star", None, "n"),
            ("min", "v", "mn"), ("max", "v", "mx"))


def _rd_specs(mod):
    return tuple(mod.AggSpec(f, c, o) for f, c, o in _RD_AGGS)


def _rd_batch(n, seed, null_key=False):
    r = np.random.default_rng(seed)
    kv = (r.random(n) > 0.1) if null_key else None
    cols = {"k": (r.integers(2, 70, n).astype(np.int64), kv),
            "v": (r.integers(-50, 50, n).astype(np.int64),
                  r.random(n) > 0.2)}
    return jax_batch(cols, r.random(n) > 0.1)


def test_range_dense_aggregate_matches_jax():
    """tests/test_ops.py's case: two partials merged lane-wise equal the
    sort route's groups, and both partials and the merge equal the JAX
    package's lane for lane; a narrow range raises the flag."""
    b1, b2 = _rd_batch(500, 1), _rd_batch(300, 2)
    outs = []
    for jb in (b1, b2):
        want, wf = jagg.range_dense_aggregate(jb, "k", 0, 128,
                                              _rd_specs(jagg))
        got, gf = tagg.range_dense_aggregate(port_batch(jb), "k", 0, 128,
                                             _rd_specs(tagg))
        assert not bool(wf) and not bool(gf)
        assert_same_batch(want, got, "partial")
        outs.append((want, got))
    (w1, g1), (w2, g2) = outs
    wm = jagg.dense_merge(w1, w2, ("k",), _rd_specs(jagg))
    gm = tagg.dense_merge(g1, g2, ("k",), _rd_specs(tagg))
    assert_same_batch(wm, gm, "merged")
    ref = tagg.hash_aggregate(
        concat_batches([port_batch(b1), port_batch(b2)]), ["k"],
        _rd_specs(tagg), method="lex")

    def rows(b):
        live = b.sel.numpy()
        return sorted(zip(*(b.col(c).values.numpy()[live].tolist()
                            for c in ("k", "s", "n", "mn", "mx"))))

    assert rows(gm) == rows(ref)
    for lo, span in ((0, 16), (10, 128)):
        _, wf = jagg.range_dense_aggregate(b1, "k", lo, span,
                                           _rd_specs(jagg))
        _, gf = tagg.range_dense_aggregate(port_batch(b1), "k", lo, span,
                                           _rd_specs(tagg))
        assert bool(gf) and bool(wf)
    # a live NULL key has no lane: the flag
    nb = _rd_batch(200, 3, null_key=True)
    want, wf = jagg.range_dense_aggregate(nb, "k", 0, 128, _rd_specs(jagg))
    got, gf = tagg.range_dense_aggregate(port_batch(nb), "k", 0, 128,
                                         _rd_specs(tagg))
    assert bool(wf) and bool(gf)
    assert_same_batch(want, got, "null key")


def _rd_scans(n=3000, chunk=512):
    rng = np.random.default_rng(9)
    data = {"k": rng.integers(5, 900, n).astype(np.int64),
            "v": rng.integers(-1000, 1000, n).astype(np.int64)}

    def chunks():
        for a in range(0, n, chunk):
            yield {k: v[a:a + chunk] for k, v in data.items()}

    js = jops.ScanOp(jbatch.Schema([jbatch.Field(k, jbatch.INT)
                                    for k in data]), chunks, chunk)
    ts = tops.ScanOp(Schema([Field(k, INT) for k in data]), chunks, chunk)
    return js, ts, data


AGGS_AVG = (("sum", "v", "s"), ("count_star", None, "n"),
            ("avg", "v", "a"), ("max", "v", "mx"))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("dense_range", [(0, 1023), (100, 800)])
def test_hash_agg_dense_range_matches_jax(fuse, dense_range):
    """HashAggOp(dense_range=...) on both tiers equals the JAX HashAggOp
    row for row. A range that misses keys raises the flag, and the
    restart turns the route off on both sides."""
    js, ts, data = _rd_scans()
    jop = jops.HashAggOp(js, ["k"], [jagg.AggSpec(*a) for a in AGGS_AVG],
                         dense_range=dense_range)
    top = tops.HashAggOp(ts, ["k"], [tagg.AggSpec(*a) for a in AGGS_AVG],
                         dense_range=dense_range)
    assert top._range_dense is not None
    want = jcollect(jop, fuse=fuse)
    with stats.query_stats() as col:
        got = tcollect(top, device="cpu", fuse=fuse)
    restarts = col.stages.get("flow.restart")
    stale = dense_range == (100, 800)
    # a stale range restarts once to turn the route off; the sort route
    # then widens as the JAX operator does
    assert bool(restarts and restarts.events) == stale
    assert (top._range_dense is None) == stale == (jop._range_dense is None)
    assert top.expansion == jop.expansion
    for c in ("k", "s", "n", "a", "mx"):
        np.testing.assert_array_equal(got[c], np.asarray(want[c]), c)
    assert sorted(got["k"].tolist()) == sorted(set(data["k"].tolist()))
    if fuse and not stale:
        assert top._fused_runner.last["routes"] == {"range_dense": 1}


def test_hash_agg_dense_range_declines_as_jax():
    """The JAX constructor's rule: one integer key, span at most 2^22,
    RANGE_DENSE_FUNCS aggregates only."""
    js, ts, _ = _rd_scans()
    for dr in ((1, 6_000_000), (5, 4)):
        top = tops.HashAggOp(ts, ["k"], [tagg.AggSpec(*a) for a in AGGS_AVG],
                             dense_range=dr)
        jop = jops.HashAggOp(js, ["k"], [jagg.AggSpec(*a) for a in AGGS_AVG],
                             dense_range=dr)
        assert top._range_dense is None and jop._range_dense is None
    top = tops.HashAggOp(ts, ["k"], [tagg.AggSpec("any_not_null", "v", "x")],
                         dense_range=(0, 1023))
    jop = jops.HashAggOp(js, ["k"], [jagg.AggSpec("any_not_null", "v", "x")],
                         dense_range=(0, 1023))
    assert top._range_dense is None and jop._range_dense is None


@pytest.mark.cuda
def test_range_dense_on_cuda_matches_cpu():
    _needs_cuda()
    jb = _rd_batch(5000, 4)
    cpu, cf = tagg.range_dense_aggregate(port_batch(jb), "k", 0, 128,
                                         _rd_specs(tagg))
    dev, df = tagg.range_dense_aggregate(_to(port_batch(jb), "cuda"), "k",
                                         0, 128, _rd_specs(tagg))
    assert bool(cf) == bool(df)
    assert_same_batch_port(cpu, _cpu(dev), "range dense")


# ------------------------------------------------------------ invariants

def _ok_batch():
    return Batch({"a": Column(torch.arange(4, dtype=torch.int64))},
                 torch.ones(4, dtype=torch.bool),
                 torch.tensor(4, dtype=torch.int32))


def test_check_batch_accepts_valid():
    check_batch(_ok_batch(), Schema([Field("a", INT)]))


def test_check_batch_rejects_bad_length():
    b = _ok_batch()
    bad = Batch(b.columns, b.sel, torch.tensor(3, dtype=torch.int32))
    with pytest.raises(InvariantViolation):
        check_batch(bad, Schema([Field("a", INT)]))


def test_check_batch_rejects_wrong_columns_and_dtype():
    with pytest.raises(InvariantViolation):
        check_batch(_ok_batch(), Schema([Field("b", INT)]))
    b = _ok_batch()
    bad = Batch({"a": Column(torch.arange(4, dtype=torch.int32))}, b.sel,
                b.length)
    with pytest.raises(InvariantViolation, match="dtype"):
        check_batch(bad, Schema([Field("a", INT)]))


def test_checked_build_runs_q3_and_declines_fusion():
    """With sql.tpu.invariants on, every operator is wrapped, the walks
    see through the wrappers, Q3 equals its oracle on the streaming tier,
    and the fused tier declines the tree, as the JAX tracer does."""
    from cockroach_tpu_torch.exec.fused import try_compile
    from cockroach_tpu_torch.sql.plan import TPCHCatalog, build
    from cockroach_tpu_torch.workload import tpch as ttpch
    from cockroach_tpu_torch.workload import tpch_queries as tq

    gen = ttpch.TPCH(sf=0.01)
    s = Settings()
    prev = s.get(INVARIANTS)
    s.set(INVARIANTS, True)
    try:
        op = build(tq.q3_plan(), TPCHCatalog(gen), 1 << 14)
    finally:
        s.set(INVARIANTS, prev)
    assert isinstance(op, CheckedOp)
    walked = list(tops.walk_operators(op))
    assert any(isinstance(o, tops.JoinOp) for o in walked)
    assert any(isinstance(o, tops.ScanOp) for o in walked)
    assert sum(isinstance(o, CheckedOp) for o in walked) >= 5
    assert try_compile(op) is None
    with stats.query_stats() as col:
        got = tcollect(op, device="cpu")
    assert "fused.exec" not in col.stages
    rows = list(zip(got["l_orderkey"].tolist(), got["revenue"].tolist(),
                    got["o_orderdate"].tolist(),
                    got["o_shippriority"].tolist()))
    assert rows == tq.q3_oracle_columnar(gen)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_hash_agg_dense_range_on_cuda_matches_cpu(fuse):
    """HashAggOp(dense_range=...) on a card equals its CPU run, on the
    streaming tier and on the fused one (resident scan: a captured graph,
    then a replay)."""
    _needs_cuda()
    results = {}
    for device in ("cpu", "cuda"):
        _js, ts, _data = _rd_scans()
        ts.resident = True
        op = tops.HashAggOp(ts, ["k"], [tagg.AggSpec(*a) for a in AGGS_AVG],
                            dense_range=(0, 1023))
        for _ in range(2):
            results[device] = tcollect(op, device=device, fuse=fuse)
        if fuse and device == "cuda":
            assert op._fused_runner.last["mode"] == "replay"
    for c in ("k", "s", "n", "a", "mx"):
        np.testing.assert_array_equal(results["cuda"][c], results["cpu"][c],
                                      c)


@pytest.mark.cuda
def test_checked_batches_on_cuda():
    """check_batch reads a CUDA batch back and holds it to the contract."""
    _needs_cuda()
    b = _to(_ok_batch(), "cuda")
    check_batch(b, Schema([Field("a", INT)]))
    bad = Batch(b.columns, b.sel, torch.tensor(3, dtype=torch.int32,
                                               device="cuda"))
    with pytest.raises(InvariantViolation):
        check_batch(bad, Schema([Field("a", INT)]))
