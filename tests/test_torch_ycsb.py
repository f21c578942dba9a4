"""YCSB-E on the port against the JAX package.

workload/ycsb.py (Zipf, fnv_scramble, load, run_e, scan_topk_flow,
ScanTopKBatcher) and ops/sort.py range_top_k, on the CPU: the key draws,
the rows workload E scans, the device top-K over an MVCC scan, and the
micro-query kernel one op at a time and batched, each against the JAX
package's (its `range_top_k` under `jax.jit` and `jax.vmap`) and a numpy
oracle. Tolerance: exact (int64 values, int32 counts, bool masks)."""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.ops.sort import range_top_k
from cockroach_tpu_torch.storage import MVCCStore, NativeEngine
from cockroach_tpu_torch.util.hlc import HLC, ManualClock
from cockroach_tpu_torch.workload import ycsb
from torch_threads import one_torch_thread  # noqa: F401

N_RECORDS = 600
K = 10
WINDOW = 128


def _stores():
    from cockroach_tpu.storage import MVCCStore as JStore
    from cockroach_tpu.storage.engine import NativeEngine as JNative
    from cockroach_tpu.util.hlc import HLC as JHLC
    from cockroach_tpu.util.hlc import ManualClock as JManualClock

    return (JStore(engine=JNative(), clock=JHLC(JManualClock(1000))),
            MVCCStore(engine=NativeEngine(), clock=HLC(ManualClock(1000)),
                      device="cpu"))


@pytest.fixture(scope="module")
def loaded():
    from cockroach_tpu.workload import ycsb as jycsb

    jstore, tstore = _stores()
    jycsb.load(jstore, N_RECORDS, np.random.default_rng(3))
    ycsb.load(tstore, N_RECORDS, np.random.default_rng(3))
    return jstore, tstore


def test_zipf_and_scramble_match_jax():
    from cockroach_tpu.workload import ycsb as jycsb

    for n in (1, 7, 1000, 100_000):
        a = ycsb.Zipf(n, rng=np.random.default_rng(n))
        b = jycsb.Zipf(n, rng=np.random.default_rng(n))
        assert np.array_equal(a.cdf, b.cdf)
        da, db = a.draw(5000), b.draw(5000)
        assert np.array_equal(da, db) and da.dtype == db.dtype
        assert np.array_equal(ycsb.fnv_scramble(da, n),
                              jycsb.fnv_scramble(db, n))
    assert (ycsb.TABLE_ID, ycsb.N_FIELDS, ycsb.MAX_SCAN_LEN,
            ycsb.ZIPF_THETA) == (jycsb.TABLE_ID, jycsb.N_FIELDS,
                                 jycsb.MAX_SCAN_LEN, jycsb.ZIPF_THETA)


def test_load_and_run_e_match_jax(loaded):
    from cockroach_tpu.workload import ycsb as jycsb

    jstore, tstore = loaded
    assert tstore.fingerprint(ycsb.TABLE_ID) == \
        jstore.fingerprint(jycsb.TABLE_ID)
    j2, t2 = _stores()
    jycsb.load(j2, 300, np.random.default_rng(9))
    ycsb.load(t2, 300, np.random.default_rng(9))
    ops_t, rows_t = ycsb.run_e(t2, 400, 300, np.random.default_rng(4))
    ops_j, rows_j = jycsb.run_e(j2, 400, 300, np.random.default_rng(4))
    assert ops_t > 0 and rows_t == rows_j > 0
    # the inserts landed alike (values; the clocks stamp the same walls)
    start, end = ycsb._key(0), ycsb._key(1 << 40)
    assert t2.engine.scan_keys(start, end, t2.clock.now()) == \
        j2.engine.scan_keys(start, end, j2.clock.now())


@pytest.mark.parametrize("k", [10, 100])
def test_scan_topk_flow_matches_jax_and_numpy(loaded, k):
    from cockroach_tpu.exec import collect as jcollect
    from cockroach_tpu.workload import ycsb as jycsb

    jstore, tstore = loaded
    got = tcollect(ycsb.scan_topk_flow(tstore, capacity=256, k=k),
                   device="cpu")
    want = jcollect(jycsb.scan_topk_flow(jstore, capacity=256, k=k))
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    f0 = np.concatenate([c["f0"] for c in tstore.scan_chunks(
        ycsb.TABLE_ID, ycsb.N_FIELDS, 1 << 12)])
    assert got["field0"].tolist() == sorted(f0.tolist(), reverse=True)[:k]


def _cases(n, rng, contiguous):
    """(values, pks, lo, hi): ops inside, across the end and empty."""
    vals = rng.integers(-2**62, 2**62, n).astype(np.int64)
    vals[rng.integers(0, n, 5)] = np.iinfo(np.int64).min  # ties w/ sentinel
    if contiguous:
        pks = 40 + np.arange(n, dtype=np.int64)
    else:
        pks = np.cumsum(rng.integers(1, 4, n)).astype(np.int64)
    top = int(pks[-1])
    lo = np.concatenate([rng.integers(0, top, 40), [top - 5, top + 3, 0, 7,
                                                    int(pks[0]) - 50]])
    lens = np.concatenate([rng.integers(1, 101, 40), [100, 20, 0, 0, 60]])
    return vals, pks, lo.astype(np.int64), (lo + lens).astype(np.int64)


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "sparse"])
@pytest.mark.parametrize("n", [1, 90, 500])
def test_range_top_k_matches_jax_vmap(n, contiguous):
    import jax
    import jax.numpy as jnp

    from cockroach_tpu.ops.sort import range_top_k as jrange_top_k

    rng = np.random.default_rng(n * 7 + contiguous)
    vals, pks, lo, hi = _cases(n, rng, contiguous)
    pk0 = int(pks[0]) if contiguous else None

    def one(a, b):
        return jrange_top_k(jnp.asarray(vals), jnp.asarray(pks), a, b, k=K,
                            window=WINDOW, pk0=pk0)

    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        jnp.asarray(lo), jnp.asarray(hi))]
    tv, tp = torch.from_numpy(vals), torch.from_numpy(pks)
    got = range_top_k(tv, tp, torch.from_numpy(lo), torch.from_numpy(hi),
                      k=K, window=WINDOW, pk0=pk0)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)
    for i in range(len(lo)):
        single = range_top_k(tv, tp, int(lo[i]), int(hi[i]), k=K,
                             window=WINDOW, pk0=pk0)
        wone = [np.asarray(x) for x in jax.jit(one)(lo[i], hi[i])]
        for g, w in zip(single, wone):
            assert np.array_equal(g.numpy(), w)
        # the numpy oracle
        sel = vals[(pks >= lo[i]) & (pks < hi[i])]
        assert int(single[2]) == len(sel)
        top = np.sort(sel)[::-1][:K]
        assert single[0][:len(top)].tolist() == top.tolist()


def test_batcher_matches_jax_and_oracle(loaded):
    from cockroach_tpu.workload import ycsb as jycsb

    jstore, tstore = loaded
    tb = ycsb.ScanTopKBatcher.from_store(tstore, capacity=256, k=K)
    jb = jycsb.ScanTopKBatcher.from_store(jstore, capacity=256, k=K)
    assert tb.device.type == "cpu"
    rng = np.random.default_rng(8)
    zipf = ycsb.Zipf(N_RECORDS, rng=rng)
    starts = ycsb.fnv_scramble(zipf.draw(700), N_RECORDS)
    lens = rng.integers(1, ycsb.MAX_SCAN_LEN + 1, 700)
    un_v, un_c = tb.run_unbatched(starts[:200], lens[:200])
    b_v, b_c = tb.run(starts, lens, batch_size=256)
    jv, jc = jb.run(starts, lens, batch_size=256)
    assert np.array_equal(b_v, jv) and np.array_equal(b_c, jc)
    assert b_c.dtype == jc.dtype == np.int32
    assert np.array_equal(un_v, b_v[:200]) and np.array_equal(un_c, b_c[:200])
    ju_v, ju_c = jb.run_unbatched(starts[:200], lens[:200])
    assert np.array_equal(un_v, ju_v) and np.array_equal(un_c, ju_c)
    # occupancy: 700 ops in batches of 256, 256 and 188 (bucket 256)
    assert (tb.ops_submitted, tb.slots_dispatched, tb.dispatches) == \
        (jb.ops_submitted, jb.slots_dispatched, jb.dispatches) == \
        (700, 768, 3)
    assert tb.occupancy() == jb.occupancy()
    tb.run(starts[:5], lens[:5], batch_size=256)
    jb.run(starts[:5], lens[:5], batch_size=256)
    assert tb.occupancy() == jb.occupancy()
    f0 = np.concatenate([c["f0"] for c in tstore.scan_chunks(
        ycsb.TABLE_ID, ycsb.N_FIELDS, 1 << 12)])
    for i in range(0, 700, 37):
        sel = f0[starts[i]:starts[i] + lens[i]]
        top = np.sort(sel)[::-1][:K]
        assert b_c[i] == len(sel)
        assert b_v[i, :len(top)].tolist() == top.tolist()
    assert ycsb.batch_bucket(188) == jycsb.batch_bucket(188) == 256


def test_batcher_rejects_short_window():
    with pytest.raises(ValueError):
        ycsb.ScanTopKBatcher(np.arange(4), np.arange(4), window=64,
                             device="cpu")
