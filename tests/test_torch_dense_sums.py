"""K1 — the dense-sum kernel — and the dense GROUP BY around it.

On the CPU the port's dense_sums takes its plain version
(cockroach_tpu_torch/ops/cuda_kernels.py dense_sums_plain); it must equal
the JAX package's Pallas kernel in interpret mode bit for bit, int64
wrap-around included. The port's dense_aggregate and dense_merge must
equal the JAX ones, with the JAX kernel route on (interpret) and off.
The CUDA kernel itself runs only on a card (chip_smoke.py holds it
against the plain version there); its test here skips without one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.ops import agg as jagg
from cockroach_tpu.ops import pallas_kernels as pk
from cockroach_tpu.util.settings import PALLAS, Settings as JSettings
from cockroach_tpu_torch.coldata.carry import batch_from_arrays
from cockroach_tpu_torch.ops import agg as tagg
from cockroach_tpu_torch.ops import cuda_kernels as ck
from cockroach_tpu_torch.util.settings import KERNELS, Settings as TSettings

I64 = np.iinfo(np.int64)


def port_batch(jb):
    cols = {n: (np.asarray(c.values),
                None if c.validity is None else np.asarray(c.validity))
            for n, c in jb.columns.items()}
    return batch_from_arrays(cols, np.asarray(jb.sel), int(jb.length), "cpu")


@pytest.fixture
def jax_pallas():
    s = JSettings()
    prev = s.get(PALLAS)
    yield lambda mode: s.set(PALLAS, mode)
    s.set(PALLAS, prev)


@pytest.fixture
def port_kernels():
    s = TSettings()
    prev = s.get(KERNELS)
    yield lambda mode: s.set(KERNELS, mode)
    s.set(KERNELS, prev)


def _pallas_sums(packed, cols, d):
    out = pk.dense_sums_via_pallas(
        jnp.asarray(packed),
        [(jnp.asarray(v), None if m is None else jnp.asarray(m))
         for v, m in cols], d, interpret=True)
    return np.stack([np.asarray(o) for o in out])


def _port_sums(packed, cols, d):
    values = [torch.from_numpy(v) for v, _ in cols]
    live = [None if m is None else torch.from_numpy(m) for _, m in cols]
    return ck.dense_sums(torch.from_numpy(packed), values, live, d).numpy()


def test_plain_matches_pallas_5000_rows_37_lanes_dead_lane():
    # tests/test_pallas.py's case: code d is the dead lane
    rng = np.random.default_rng(1)
    n, d = 5000, 37
    packed = rng.integers(0, d + 1, n).astype(np.int32)
    vals = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    live = rng.random(n) > 0.3
    cols = [(vals, live), (np.ones(n, dtype=np.int64), None)]
    np.testing.assert_array_equal(_port_sums(packed, cols, d),
                                  _pallas_sums(packed, cols, d))


def test_plain_matches_pallas_int64_extremes_wrap():
    rng = np.random.default_rng(4)
    n, d = 3000, 12
    packed = rng.integers(-1, d + 1, n).astype(np.int32)  # -1 and d dead
    extremes = np.array([I64.max, I64.min, -1, 1], dtype=np.int64)
    wide = extremes[rng.integers(0, 4, n)]
    big = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    live = rng.random(n) > 0.5
    cols = [(wide, None), (big, live), (-big, ~live)]
    got = _port_sums(packed, cols, d)
    np.testing.assert_array_equal(got, _pallas_sums(packed, cols, d))
    # the sums really wrapped: exact Python ints differ from int64
    g = int(np.argmax(np.bincount(packed[(packed >= 0) & (packed < d)])))
    exact = sum(int(v) for v in wide[packed == g])
    assert exact != int(got[0, g]) or not (I64.min <= exact <= I64.max)
    assert (exact - int(got[0, g])) % (1 << 64) == 0


def test_implicit_count_column_equals_ones():
    rng = np.random.default_rng(6)
    n, d = 777, 5
    packed = torch.from_numpy(rng.integers(-2, d + 2, n).astype(np.int32))
    live = torch.from_numpy(rng.random(n) > 0.4)
    ones = torch.ones(n, dtype=torch.int64)
    got = ck.dense_sums(packed, [None, None], [None, live], d)
    want = ck.dense_sums(packed, [ones, ones], [None, live], d)
    assert torch.equal(got, want)


_P = torch.zeros(8, dtype=torch.int32)
_V = torch.arange(8, dtype=torch.int64)


@pytest.mark.parametrize("args", [
    (_P.to(torch.int64), [_V], [None], 4),                   # packed dtype
    (_P, [_V.to(torch.int32)], [None], 4),                   # value dtype
    (_P, [_V[:-1]], [None], 4),                              # value length
    (_P, [torch.arange(16, dtype=torch.int64)[::2]], [None], 4),  # strided
    (_P, [_V], [torch.ones(8, dtype=torch.int32)], 4),       # live dtype
    (_P, [_V], [None, None], 4),                             # column count
    (_P, [], [], 4),                                         # no columns
    (_P, [_V], [None], 0),                                   # no lanes
    (_P, [_V], [None], 257),                                 # too many lanes
], ids=["packed_dtype", "value_dtype", "value_len", "strided", "live_dtype",
        "n_cols", "no_cols", "zero_lanes", "many_lanes"])
def test_wrapper_rejects_shapes_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ck.dense_sums(*args)


def test_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    rng = np.random.default_rng(9)
    n, d = 100_003, 37
    dev = torch.device("cuda")
    packed = torch.from_numpy(rng.integers(-1, d + 1, n).astype(np.int32))
    v = torch.from_numpy(rng.integers(I64.min, I64.max, n, dtype=np.int64))
    m = torch.from_numpy(rng.random(n) > 0.3)
    want = ck.dense_sums(packed, [None, v], [None, m], d)
    got = ck.dense_sums(packed.to(dev), [None, v.to(dev)], [None, m.to(dev)], d)
    assert torch.equal(got.cpu(), want)


def _random_batch(rng, cap=2048):
    keys = rng.integers(0, 4, cap).astype(np.int64)
    v1 = rng.integers(-(1 << 45), 1 << 45, cap).astype(np.int64)
    v2 = rng.integers(0, 1000, cap).astype(np.int64)
    valid2 = rng.random(cap) > 0.25
    sel = rng.random(cap) > 0.1
    return jbatch.Batch(
        {"k": jbatch.Column(jnp.asarray(keys)),
         "v1": jbatch.Column(jnp.asarray(v1)),
         "v2": jbatch.Column(jnp.asarray(v2), jnp.asarray(valid2))},
        jnp.asarray(sel),
        jnp.asarray(int(sel.sum()), dtype=jnp.int32))


def _aggs(mod):
    # tests/test_pallas.py's AGGS
    A = mod.AggSpec
    return (A("sum", "v1", "s1"),
            A("sum", "v2", "s2"),
            A("count", "v2", "c2"),
            A("count_star", None, "n"),
            A("sum_hi32", "v1", "w__hi"),
            A("sum_lo32", "v1", "w__lo"),
            A("min", "v1", "mn"),
            A("max", "v1", "mx"))


def assert_same_batch(jb, tb):
    np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel))
    assert int(tb.length) == int(jb.length)
    assert sorted(tb.names()) == sorted(jb.names())
    for n in jb.names():
        jc, tc = jb.col(n), tb.col(n)
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values), err_msg=n)
        np.testing.assert_array_equal(tc.valid_mask().numpy(),
                                      np.asarray(jc.valid_mask()),
                                      err_msg=f"{n} validity")


@pytest.mark.parametrize("jax_mode", ["interpret", "off"])
@pytest.mark.parametrize("port_mode", ["auto", "off"])
def test_dense_aggregate_matches_jax(jax_pallas, port_kernels, jax_mode,
                                     port_mode):
    rng = np.random.default_rng(2)
    jb = _random_batch(rng)
    jax_pallas(jax_mode)
    port_kernels(port_mode)
    want = jagg.dense_aggregate(jb, ("k",), _aggs(jagg), (4,))
    got = tagg.dense_aggregate(port_batch(jb), ("k",), _aggs(tagg), (4,))
    assert_same_batch(want, got)


def test_dense_aggregate_counts_launches_only_on_the_kernel_route(
        port_kernels):
    rng = np.random.default_rng(3)
    tb = port_batch(_random_batch(rng, cap=256))
    before = ck.DENSE_SUMS.launches
    tagg.dense_aggregate(tb, ("k",), _aggs(tagg), (4,))
    # on the CPU the plain version runs: the kernel's count stays put
    assert ck.DENSE_SUMS.launches == before


def test_dense_merge_matches_jax(jax_pallas):
    rng = np.random.default_rng(10)
    jax_pallas("off")
    jparts, tparts = [], []
    for cap in (512, 300):
        jb = _random_batch(rng, cap)
        # keys 0..2 only in the second batch: a lane live in one partial
        if cap == 300:
            jb = jb.with_column("k", jbatch.Column(
                jnp.asarray(rng.integers(0, 3, cap).astype(np.int64))))
        jparts.append(jagg.dense_aggregate(jb, ("k",), _aggs(jagg), (4,)))
        tparts.append(tagg.dense_aggregate(port_batch(jb), ("k",),
                                           _aggs(tagg), (4,)))
    want = jagg.dense_merge(jparts[1], jparts[0], ("k",), _aggs(jagg))
    got = tagg.dense_merge(tparts[1], tparts[0], ("k",), _aggs(tagg))
    assert_same_batch(want, got)


def test_dense_aggregate_nullable_string_keys_matches_jax(jax_pallas):
    rng = np.random.default_rng(14)
    cap = 1000
    jax_pallas("interpret")
    jb = jbatch.Batch(
        {"a": jbatch.Column(jnp.asarray(rng.integers(0, 3, cap).astype(np.int32)),
                            jnp.asarray(rng.random(cap) > 0.2)),
         "b": jbatch.Column(jnp.asarray(rng.random(cap) > 0.5)),
         "v": jbatch.Column(jnp.asarray(rng.integers(-99, 99, cap)))},
        jnp.asarray(rng.random(cap) > 0.1), jnp.int32(0))
    jb = jb.with_sel(jb.sel)
    A = (jagg.AggSpec("sum", "v", "s"), jagg.AggSpec("count_star", None, "n"),
         jagg.AggSpec("avg", "v", "m"))
    B = tuple(tagg.AggSpec(a.func, a.col, a.out) for a in A)
    want = jagg.dense_aggregate(jb, ("a", "b"), A, (4, 3))
    got = tagg.dense_aggregate(port_batch(jb), ("a", "b"), B, (4, 3))
    assert_same_batch(want, got)


def test_unported_aggregations_raise():
    for fn in (tagg.hash_aggregate, tagg.ordered_aggregate,
               tagg.range_dense_aggregate):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
