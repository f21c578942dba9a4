"""The port's device-resident MVCC tier against the JAX package's.

ops/bitpack.py's MVCC timestamp helpers (hypothesis against the JAX
functions), ops/mvcc_filter.py's fold_versions and visible_image
(random version sets with duplicate (pk, ts) lanes, tombstones, several
pow2 capacities, `n` below the capacity and read timestamps before,
inside and after the versions, against `jax.jit`'s results), and the
cases of tests/test_resident.py on the port's storage/resident.py, on
the CPU (`MVCCStore(device="cpu")`). Tolerance: exact (int64 lanes,
bools, row values)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cockroach_tpu_torch.ops import bitpack as bp
from cockroach_tpu_torch.ops import mvcc_filter as mf
from cockroach_tpu_torch.storage import resident
from cockroach_tpu_torch.storage.engine import NativeEngine, PyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util import fault
from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.settings import Settings
from torch_threads import one_torch_thread  # noqa: F401

T = 3
ENGINES = ["py", "native"]


@pytest.fixture(autouse=True)
def _resident_hygiene():
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    s = Settings()
    prev = s.get(resident.RESIDENT_SCAN)
    prev_frac = s.get(resident.RESIDENT_COMPACT_FRACTION)
    resident.reset()
    scan_image_cache().clear()
    yield
    s.set(resident.RESIDENT_SCAN, prev)
    s.set(resident.RESIDENT_COMPACT_FRACTION, prev_frac)
    resident.reset()
    scan_image_cache().clear()
    fault.registry().disarm()


def _store(kind="py"):
    eng = PyEngine() if kind == "py" else NativeEngine()
    return MVCCStore(engine=eng, device="cpu")


# ------------------------------------------------------- timestamp pack --

_walls = st.integers(min_value=0, max_value=1 << 62)
_logicals = st.integers(min_value=0, max_value=(1 << 32) - 1)


@settings(max_examples=200, deadline=None)
@given(_walls, _walls, _logicals)
def test_pack_ts_matches_jax(min_wall, wall, logical):
    from cockroach_tpu.ops import bitpack as jbp

    base = bp.ts_base(min_wall)
    assert base == jbp.ts_base(min_wall)
    assert bp.pack_ts_read(wall, logical, base) == \
        jbp.pack_ts_read(wall, logical, base)
    try:
        want = jbp.pack_ts(wall, logical, base)
    except jbp.TsOverflow:
        with pytest.raises(bp.TsOverflow):
            bp.pack_ts(wall, logical, base)
    else:
        assert bp.pack_ts(wall, logical, base) == want


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 1 << 44), st.integers(0, 1 << 21)),
                min_size=0, max_size=20),
       st.integers(0, 1 << 44))
def test_pack_ts_arrays_matches_jax(pairs, min_wall):
    from cockroach_tpu.ops import bitpack as jbp

    walls = np.array([w for w, _ in pairs], np.int64)
    logicals = np.array([lo for _, lo in pairs], np.int64)
    base = bp.ts_base(min_wall)
    try:
        want = jbp.pack_ts_arrays(walls, logicals, base)
    except jbp.TsOverflow:
        with pytest.raises(bp.TsOverflow):
            bp.pack_ts_arrays(walls, logicals, base)
    else:
        got = bp.pack_ts_arrays(walls, logicals, base)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pack_ts_order_isomorphic():
    base = bp.ts_base(10_000)
    pairs = [(9_000, 0), (9_000, 5), (10_000, 0), (10_000, 1),
             (10_001, 0), (11_000, 999_999)]
    packed = [bp.pack_ts(w, l, base) for w, l in pairs]
    assert packed == sorted(packed)
    assert len(set(packed)) == len(packed)


def test_pack_ts_overflow_raises():
    base = bp.ts_base(10_000)
    with pytest.raises(bp.TsOverflow):
        bp.pack_ts(base - 1, 0, base)
    with pytest.raises(bp.TsOverflow):
        bp.pack_ts(base + (1 << bp.TS_WALL_BITS), 0, base)
    with pytest.raises(bp.TsOverflow):
        bp.pack_ts(10_000, 1 << bp.TS_LOGICAL_BITS, base)
    with pytest.raises(bp.TsOverflow):
        bp.pack_ts_arrays(np.array([10_000, 1 << 62]),
                          np.array([0, 0]), base)


def test_pack_ts_read_clamps_comparison_exact():
    base = bp.ts_base(10_000)
    lo = bp.pack_ts(9_000, 0, base)
    hi = bp.pack_ts(11_000, (1 << bp.TS_LOGICAL_BITS) - 1, base)
    assert bp.pack_ts_read(0, 0, base) < lo
    assert bp.pack_ts_read(1 << 61, 0, base) > hi
    assert bp.pack_ts_read(11_000, 1 << 40, base) >= hi


# ------------------------------------------- fold and visibility passes --


def _lanes(rng, n, cap, ncols, seq0=0, n_pk=12, n_ts=40):
    """A sorted lane set of n real lanes in a pow2 cap: duplicate pks,
    duplicate (pk, ts) pairs (distinct seqs), tombstones."""
    lane = mf.sentinel_arrays(cap, ncols)
    pk = rng.integers(0, n_pk, n).astype(np.int64)
    ts = rng.integers(0, n_ts, n).astype(np.int64)
    seq = np.arange(seq0, seq0 + n, dtype=np.int64)
    tomb = rng.random(n) < 0.25
    vals = rng.integers(-2**62, 2**62, (ncols, n)).astype(np.int64)
    order = np.lexsort((seq, ts, pk))
    lane[0][:n], lane[1][:n], lane[2][:n] = pk[order], ts[order], seq[order]
    lane[3][:n] = tomb[order]
    lane[4][:, :n] = vals[:, order]
    return lane


def _delta(rng, d, dcap, ncols, seq0):
    """An unsorted delta batch (the fold sorts it)."""
    lane = mf.sentinel_arrays(dcap, ncols)
    lane[0][:d] = rng.integers(0, 12, d)
    lane[1][:d] = rng.integers(0, 40, d)
    lane[2][:d] = np.arange(seq0, seq0 + d)
    lane[3][:d] = rng.random(d) < 0.25
    lane[4][:, :d] = rng.integers(-2**62, 2**62, (ncols, d))
    return lane


def _t(lane):
    return tuple(torch.from_numpy(a.copy()) for a in lane)


def _j(lane):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in lane)


@pytest.mark.parametrize("cap,n,dcap,d,out_cap", [
    (8, 5, 4, 3, 8), (16, 16, 8, 8, 32), (32, 20, 16, 9, 32),
    (64, 40, 1, 1, 64), (16, 3, 32, 30, 64), (128, 100, 64, 27, 128)])
def test_fold_versions_matches_jax(cap, n, dcap, d, out_cap):
    from cockroach_tpu.ops import mvcc_filter as jmf

    rng = np.random.default_rng(cap * 131 + d)
    base = _lanes(rng, n, cap, 3)
    delta = _delta(rng, d, dcap, 3, n)
    got = mf.fold_versions(_t(base), _t(delta), out_cap)
    want = jmf.fold_versions(_j(base), _j(delta), out_cap)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("cap,n", [(1, 1), (8, 5), (16, 16), (64, 37),
                                   (256, 200), (1024, 1000)])
def test_visible_image_matches_jax(cap, n):
    from cockroach_tpu.ops import mvcc_filter as jmf

    rng = np.random.default_rng(cap + n)
    lane = _lanes(rng, n, cap, 2, n_pk=max(2, n // 3))
    t, j = _t(lane), _j(lane)
    # before every version, inside the range, at the newest, after all
    for tread in (-1, 0, 5, 17, 39, 40, 1 << 62):
        pk, vals, count = mf.visible_image(t[0], t[1], t[3], t[4], n, tread)
        wpk, wvals, wcount = jmf.visible_image(j[0], j[1], j[3], j[4], n,
                                               tread)
        assert count.dtype == torch.int32 and count.dim() == 0
        assert int(count) == int(wcount), tread
        assert np.array_equal(pk.numpy(), np.asarray(wpk)), tread
        assert np.array_equal(vals.numpy(), np.asarray(wvals)), tread


def test_fold_then_visible_matches_jax_with_same_ts_replays():
    """Replays at an existing (pk, ts) fold in and win by append seq."""
    from cockroach_tpu.ops import mvcc_filter as jmf

    rng = np.random.default_rng(5)
    base = _lanes(rng, 50, 64, 2, n_pk=10, n_ts=8)
    delta = mf.sentinel_arrays(16, 2)
    delta[0][:10] = base[0][:10]      # the same pks ...
    delta[1][:10] = base[1][:10]      # ... at the same timestamps
    delta[2][:10] = np.arange(50, 60)
    delta[4][:, :10] = np.arange(20).reshape(2, 10) + 7
    got = mf.fold_versions(_t(base), _t(delta), 64)
    want = jmf.fold_versions(_j(base), _j(delta), 64)
    for tread in (0, 3, 7, 100):
        g = mf.visible_image(got[0], got[1], got[3], got[4], 60, tread)
        w = jmf.visible_image(want[0], want[1], want[3], want[4], 60, tread)
        assert int(g[2]) == int(w[2])
        assert np.array_equal(g[0].numpy(), np.asarray(w[0]))
        assert np.array_equal(g[1].numpy(), np.asarray(w[1]))


def _np_visible(pk, ts, tomb, n, tread):
    newest = {}
    for i in range(n):
        if ts[i] <= tread:
            newest[int(pk[i])] = i
    return [(k, i) for k, i in sorted(newest.items()) if not tomb[i]]


def test_visible_pass_matches_oracle():
    rng = np.random.default_rng(7)
    n = 37
    cap = mf.pow2_at_least(n)
    pk_v = np.sort(rng.integers(0, 12, n).astype(np.int64))
    ts_v = rng.integers(0, 50, n).astype(np.int64)
    tomb_v = rng.random(n) < 0.3
    order = np.lexsort((np.arange(n), ts_v, pk_v))
    pk_v, ts_v, tomb_v = pk_v[order], ts_v[order], tomb_v[order]
    lanes = mf.sentinel_arrays(cap, 1)
    lanes[0][:n], lanes[1][:n] = pk_v, ts_v
    lanes[2][:n] = np.arange(n)
    lanes[3][:n] = tomb_v
    lanes[4][0, :n] = np.arange(n) * 11
    dev = _t(lanes)
    for tread in (0, 10, 25, 49, 100):
        out_pk, out_vals, count = mf.visible_image(
            dev[0], dev[1], dev[3], dev[4], n, tread)
        want = _np_visible(pk_v, ts_v, tomb_v, n, tread)
        assert out_pk[:int(count)].tolist() == [k for k, _ in want]
        assert out_vals[0, :int(count)].tolist() == [i * 11 for _, i in want]


def test_fold_merges_sorted():
    base = mf.sentinel_arrays(8, 1)
    base[0][:5] = [1, 1, 2, 5, 9]
    base[1][:5] = [10, 20, 10, 10, 10]
    base[2][:5] = np.arange(5)
    delta = mf.sentinel_arrays(4, 1)
    delta[0][:3] = [1, 3, 9]
    delta[1][:3] = [15, 10, 5]
    delta[2][:3] = np.arange(5, 8)
    out = mf.fold_versions(_t(base), _t(delta), 8)
    assert out[0][:8].tolist() == [1, 1, 1, 2, 3, 5, 9, 9]
    assert out[1][:8].tolist() == [10, 15, 20, 10, 10, 10, 5, 10]


# ------------------------------------------------- resident scan tier --


def _rows(store, ts, ncols=2):
    chunks = list(MVCCStore.scan_chunks(store, T, ncols, 1 << 14, ts=ts))
    if not chunks:
        return [np.zeros(0, np.int64)] * ncols
    return [np.concatenate([c[f"f{i}"] for c in chunks])
            for i in range(ncols)]


@pytest.mark.parametrize("kind", ENGINES)
def test_resident_scan_bit_exact_and_cached(kind):
    store = _store(kind)
    for pk in range(64):
        store.put(T, pk, [pk, pk * 2], ts=Timestamp(100 + pk, 0))
    want = _rows(store, Timestamp(10**6, 0))
    assert store.make_resident(T, 2)
    rt = resident.lookup(store, T)
    assert rt is not None and rt.n == 64 and rt.device.type == "cpu"
    got = _rows(store, Timestamp(10**6, 0))
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    folds_before = rt.folds
    _rows(store, Timestamp(10**6, 0))
    assert rt.folds == folds_before


@pytest.mark.parametrize("kind", ENGINES)
def test_tombstone_at_horizon(kind):
    store = _store(kind)
    store.put(T, 1, [7, 8], ts=Timestamp(100, 0))
    store.put(T, 2, [9, 10], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    store.delete(T, 1, ts=Timestamp(200, 0))
    assert _rows(store, Timestamp(200, 0))[0].tolist() == [9]
    assert _rows(store, Timestamp(199, (1 << bp.TS_LOGICAL_BITS) - 1)
                 )[0].tolist() == [7, 9]


def test_equal_wall_logical_tie_order():
    store = _store()
    store.put(T, 1, [1, 0], ts=Timestamp(100, 0))
    store.put(T, 1, [2, 0], ts=Timestamp(100, 1))
    assert store.make_resident(T, 2)
    store.put(T, 1, [3, 0], ts=Timestamp(100, 2))
    assert _rows(store, Timestamp(100, 0))[0].tolist() == [1]
    assert _rows(store, Timestamp(100, 1))[0].tolist() == [2]
    assert _rows(store, Timestamp(100, 2))[0].tolist() == [3]
    assert _rows(store, Timestamp(101, 0))[0].tolist() == [3]


@pytest.mark.parametrize("kind", ENGINES)
def test_same_timestamp_replay_replaces(kind):
    store = _store(kind)
    store.put(T, 1, [1, 1], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    store.put(T, 1, [2, 2], ts=Timestamp(100, 0))  # replace, not add
    assert _rows(store, Timestamp(100, 0))[0].tolist() == [2]


@pytest.mark.parametrize("kind", ENGINES)
def test_delta_fold_then_compaction(kind):
    store = _store(kind)
    Settings().set(resident.RESIDENT_COMPACT_FRACTION, 0.25)
    for pk in range(32):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    rt = resident.lookup(store, T)
    store.put(T, 100, [1, 1], ts=Timestamp(200, 0))
    _rows(store, Timestamp(300, 0))
    assert rt.folds == 1 and rt.rebuilds == 1
    for i in range(300):
        store.put(T, i % 32, [i, i], ts=Timestamp(1000 + i, 0))
    f0 = _rows(store, Timestamp(10**6, 0))[0]
    assert rt.rebuilds == 2  # compacted, not folded
    resident.reset()
    assert np.array_equal(f0, _rows(store, Timestamp(10**6, 0))[0])


def test_out_of_band_write_resyncs():
    from cockroach_tpu_torch.storage.mvcc import encode_key

    store = _store()
    for pk in range(8):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    _rows(store, Timestamp(200, 0))
    store.engine.delete(encode_key(T, 3), Timestamp(300, 0))
    rt = resident.lookup(store, T)
    rebuilds = rt.rebuilds
    f0 = _rows(store, Timestamp(400, 0))[0]
    assert f0.tolist() == [0, 1, 2, 4, 5, 6, 7]
    assert rt.rebuilds == rebuilds + 1


def test_budget_refusal_keeps_host_tier():
    from cockroach_tpu_torch.util.settings import SCAN_IMAGE_CACHE_BUDGET

    store = _store()
    for pk in range(64):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    s = Settings()
    prev = s.get(SCAN_IMAGE_CACHE_BUDGET)
    s.set(SCAN_IMAGE_CACHE_BUDGET, 64)  # nothing fits
    try:
        assert not store.make_resident(T, 2)
        assert resident.lookup(store, T) is None
        assert _rows(store, Timestamp(200, 0))[0].tolist() == \
            list(range(64))
    finally:
        s.set(SCAN_IMAGE_CACHE_BUDGET, prev)


def test_ts_overflow_degrades_to_host():
    store = _store()
    store.put(T, 1, [1, 0], ts=Timestamp(100, 0))
    store.put(T, 2, [2, 0],
              ts=Timestamp(100 + (1 << bp.TS_WALL_BITS) + 10, 0))
    assert not store.make_resident(T, 2)
    assert _rows(store, Timestamp(1 << 61, 0))[0].tolist() == [1, 2]


def test_pin_survives_write_invalidation():
    from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

    store = _store()
    store.put(T, 1, [1, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    rt = resident.lookup(store, T)
    assert scan_image_cache().contains(rt._pin_key())
    store.put(T, 2, [2, 0], ts=Timestamp(200, 0))  # eager invalidation
    assert scan_image_cache().contains(rt._pin_key())
    assert _rows(store, Timestamp(300, 0))[0].tolist() == [1, 2]
    assert resident.lookup(store, T) is rt


def test_invalidate_keep_tag_matches_jax():
    from cockroach_tpu.exec.scan_cache import ScanImageCache as JCache

    from cockroach_tpu_torch.exec.scan_cache import ScanImageCache

    keys = [("mvcc", 1, 3, "resident-pin"), ("mvcc", 1, 3, 7, 64, ("a",)),
            ("mvcc", 1, 3, "resident", 1, 0, 2, 5, 64, ("a",)),
            ("mvcc", 1, 4, 7, 64, ("a",)), ("tpch", 0.01, 1, "x", 64, ())]
    for keep in (None, "resident-pin"):
        port, jax_cache = ScanImageCache(1 << 20), JCache(1 << 20)
        for c in (port, jax_cache):
            for k in keys:
                c.put(k, object(), 8)
        assert port.invalidate(("mvcc", 1, 3), keep_tag=keep) == \
            jax_cache.invalidate(("mvcc", 1, 3), keep_tag=keep)
        assert [port.contains(k) for k in keys] == \
            [jax_cache.contains(k) for k in keys]


def test_injected_fault_retries_then_serves():
    from cockroach_tpu_torch.exec import stats

    store = _store()
    store.put(T, 1, [1, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    reg = fault.registry()
    reg.arm("scan.resident", probability=1.0)
    try:
        with stats.query_stats() as col:
            assert _rows(store, Timestamp(200, 0))[0].tolist() == [1]
        # probability-1 faults exhaust the retries -> host-walk backstop
        assert col.stages["scan.resident_fallback"].events == 1
        assert col.stages["resilience.retry.scan.resident"].events >= 1
    finally:
        reg.disarm("scan.resident")
    assert _rows(store, Timestamp(200, 0))[0].tolist() == [1]
    assert resident.lookup(store, T) is not None  # still attached


# a device fault in a pass propagates; running out of device memory
# degrades to the host walk and detaches the table
_PASS_FAULTS = [
    (RuntimeError, "CUDA error: an illegal memory access was encountered",
     False),
    (RuntimeError, "the pass failed", False),
    (torch.cuda.OutOfMemoryError, "CUDA out of memory", True),
]


@pytest.mark.parametrize("exc,msg,falls_back", _PASS_FAULTS)
@pytest.mark.parametrize("pass_name", ["visible_image", "fold_versions"])
def test_pass_fault_propagates_unless_out_of_memory(monkeypatch, pass_name,
                                                    exc, msg, falls_back):
    from cockroach_tpu_torch.exec import stats

    store = _store()
    for pk in range(8):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    rt = resident.lookup(store, T)
    store.put(T, 9, [9, 0], ts=Timestamp(150, 0))  # a delta to fold

    def planted(*args, **kwargs):
        raise exc(msg)

    monkeypatch.setattr(mf, pass_name, planted)
    if not falls_back:
        with pytest.raises(exc, match=msg):
            _rows(store, Timestamp(200, 0))
        assert resident.lookup(store, T) is rt  # still attached
        monkeypatch.undo()
        assert _rows(store, Timestamp(200, 0))[0].tolist() == \
            list(range(8)) + [9]
        return
    with stats.query_stats() as col:
        assert _rows(store, Timestamp(200, 0))[0].tolist() == \
            list(range(8)) + [9]
    assert col.stages["scan.resident_fallback"].events == 1
    assert resident.lookup(store, T) is None  # detached, lanes freed


def test_auto_attach_setting_and_scan_op_key():
    """storage.resident_scan attaches on the first scan; scan_op keys a
    resident table's image by (generation, base, version, bucket)."""
    from cockroach_tpu_torch.coldata.batch import INT, Field, Schema
    from cockroach_tpu_torch.exec.operators import collect

    store = _store()
    for pk in range(10):
        store.put(T, pk, [pk, -pk], ts=Timestamp(100, 0))
    schema = Schema([Field("a", INT), Field("b", INT)])
    op = store.scan_op(T, schema, 8, ts=Timestamp(150, 0))
    assert "resident" not in op.cache_key
    assert resident.lookup(store, T) is None
    Settings().set(resident.RESIDENT_SCAN, True)
    res = collect(op, device="cpu", fuse=False)
    assert res["a"].tolist() == list(range(10))
    rt = resident.lookup(store, T)
    assert rt is not None
    op2 = store.scan_op(T, schema, 8, ts=Timestamp(150, 0))
    base, bucket = rt.read_bucket(Timestamp(150, 0))
    assert op2.cache_key == store.scan_cache_prefix(T) + (
        "resident", rt.generation, base, store.table_version(T), bucket, 8,
        ("a", "b"))
    assert op2._mvcc_src[:3] == (store, T, Timestamp(150, 0))
    assert collect(op2, device="cpu", fuse=False)["b"].tolist() == \
        [-i for i in range(10)]


def test_changed_span_and_horizon():
    store = _store()
    for pk in range(16):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    rt = resident.lookup(store, T)
    ep = rt.epoch
    assert rt.changed_span(ep) == (0, -1)
    h0 = rt.horizon()
    store.put(T, 5, [50, 0], ts=Timestamp(200, 0))
    store.put(T, 9, [90, 0], ts=Timestamp(201, 0))
    assert rt.horizon() == (h0[0], h0[1] + 2)
    _rows(store, Timestamp(300, 0))
    assert rt.changed_span(ep) == (5, 9)
    assert rt.changed_span(ep - 1) is None  # a rebuild is in the window


def _export_oracle(engine, start, end, ncols):
    """The rebuild's host arrays, decoded one export tuple at a time (the
    JAX package's loop)."""
    import struct

    entries = engine.export_span(start, end)
    n = len(entries)
    pks, walls, logicals = (np.zeros(n, np.int64) for _ in range(3))
    tomb = np.zeros(n, bool)
    vals = np.zeros((ncols, n), np.int64)
    for i, (key, ts, val) in enumerate(entries):
        pks[i] = struct.unpack(">HQ", key)[1]
        walls[i], logicals[i] = ts.wall, ts.logical
        row = np.frombuffer(val, dtype="<i8", count=len(val) // 8)
        vals[:min(ncols, len(row)), i] = row[:ncols]
        tomb[i] = not val
    return pks, walls, logicals, tomb, vals


@pytest.mark.parametrize("kind", ENGINES)
def test_export_arrays_match_per_version_decode(kind):
    """The numpy parse of an export (one record size; then mixed sizes:
    tombstones, short and wide rows, runs longer than one window)
    equals decoding each version on its own."""
    from cockroach_tpu_torch.storage import resident as res
    from cockroach_tpu_torch.storage.mvcc import encode_key, encode_row

    e = NativeEngine() if kind == "native" else PyEngine()
    for i in range(30):
        e.put(encode_key(T, i), Timestamp(100 + i, i % 3),
              encode_row([i, 2 * i, 3 * i]))
    start, end = encode_key(T, 0), encode_key(T + 1, 0)
    for ncols in (2, 3, 4):
        got = res._export_arrays(e, start, end, ncols)
        for g, w in zip(got, _export_oracle(e, start, end, ncols)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    rng = np.random.default_rng(3)
    e.delete(encode_key(T, 4), Timestamp(500, 0))
    e.put(encode_key(T, 6), Timestamp(501, 0), encode_row([66]))
    e.put(encode_key(T, 1 << 40), Timestamp(502, 0),
          encode_row(rng.integers(-9, 9, 5).tolist()))
    for i in range(40, 40 + 3 * res._WINDOW):
        e.put(encode_key(T, i), Timestamp(600, 0), encode_row([i, -i, 7]))
    for ncols in (1, 3, 6):
        got = res._export_arrays(e, start, end, ncols)
        for g, w in zip(got, _export_oracle(e, start, end, ncols)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_concurrent_writes_and_resident_reads():
    """Writers queue deltas while readers fold and read the resident
    tier from other threads (more threads than cores, a short switch
    interval): no read falls back, none sees a torn version, and the
    final read equals the host walk."""
    import sys
    import threading

    from cockroach_tpu_torch.exec import stats

    store = _store("native")
    for pk in range(64):
        store.put(T, pk, [pk, 0], ts=Timestamp(100, 0))
    assert store.make_resident(T, 2)
    n_writers, n_readers, per_writer = 6, 6, 60
    errors, cols = [], []
    wall = [1000]
    mu = threading.Lock()

    def writer(w):
        try:
            for i in range(per_writer):
                with mu:
                    wall[0] += 1
                    ts = Timestamp(wall[0], 0)
                    # field 1 mirrors field 0: a torn version breaks it
                    store.put(T, (w * 7 + i) % 64, [w * 1000 + i,
                                                    -(w * 1000 + i)], ts=ts)
        except Exception as e:  # noqa: BLE001 — reported by the test
            errors.append(e)

    def reader():
        try:
            with stats.query_stats() as col:
                for _ in range(20):
                    f0, f1 = _rows(store, Timestamp(10**9, 0))
                    assert len(f0) == 64
                    assert np.array_equal(f1[f0 != np.arange(64)],
                                          -f0[f0 != np.arange(64)])
            cols.append(col)
        except Exception as e:  # noqa: BLE001 — reported by the test
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=writer, args=(w,))
                    for w in range(n_writers)]
                   + [threading.Thread(target=reader)
                      for _ in range(n_readers)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert not errors, errors
    assert len(cols) == n_readers
    assert not any("scan.resident_fallback" in c.stages for c in cols)
    got = _rows(store, Timestamp(10**9, 0))
    resident.reset()
    want = _rows(store, Timestamp(10**9, 0))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("pattern", ["runs", "alternating", "random"])
def test_record_layout_mixed_widths(pattern):
    """The export parser's offsets and value lengths equal a walk of the
    records one header at a time, for runs of one width, widths that
    alternate at every record (a table's versions before and after ALTER
    TABLE ADD COLUMN, tombstones between them) and random widths, with
    a short tail that is not a whole record."""
    import struct

    from cockroach_tpu_torch.storage import resident as res

    rng = np.random.default_rng(3)
    n = 5000
    if pattern == "runs":
        vl = np.repeat([64, 0, 72, 64], n // 4)
    elif pattern == "alternating":
        vl = np.tile([72, 64, 0], n // 3 + 1)[:n]
    else:
        vl = rng.choice([0, 8, 64, 72], n)
    parts = []
    for i, v in enumerate(vl.tolist()):
        parts.append(struct.pack("<IIQI", 10, v, 1000 + i, i % 7)
                     + struct.pack(">HQ", 5, i) + bytes(rng.integers(
                         0, 256, v, dtype=np.uint8)))
    buf = b"".join(parts) + b"\x0a\x00\x00"   # a short tail
    offs, vlens = res._record_layout(buf)
    want_offs = np.cumsum([0] + [30 + v for v in vl.tolist()])[:-1]
    np.testing.assert_array_equal(offs, want_offs)
    np.testing.assert_array_equal(vlens, vl)
