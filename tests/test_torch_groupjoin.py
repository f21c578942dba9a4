"""The port's group join, int-key GROUP BY and lane bit-packing
(cockroach_tpu_torch/ops/groupjoin.py, ops/bitpack.py) against the JAX
package's, on the CPU.

The eleven cases of tests/test_groupjoin.py, each run with key64 off and
on: the same seeded numpy inputs go through the JAX function and the
port's, and every output column (values and validity), `sel`, `length`
and both deferred flags (`fallback`, `overflow`) must be equal bit for
bit; each case also keeps its per-row oracle. The bit-packing plan
(minima, widths, offsets, total bits) and the packed lanes must equal
the JAX package's bit for bit (uint64 against the port's int64 lanes),
and the round trip must give the columns back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.ops import bitpack as jbitpack
from cockroach_tpu.ops import groupjoin as jgj
from cockroach_tpu.ops.agg import AggSpec as JAggSpec
from cockroach_tpu_torch.coldata.batch import Batch, Column
from cockroach_tpu_torch.ops import bitpack as tbitpack
from cockroach_tpu_torch.ops import groupjoin as tgj
from cockroach_tpu_torch.ops.agg import AggSpec
from torch_threads import one_torch_thread  # noqa: F401

KEY64 = pytest.mark.parametrize("key64", [False, True],
                                ids=["key32", "key64"])


def _batches(cols, sel=None):
    """(JAX batch, port batch) of the same columns: each value is an
    array, or (values, validity)."""
    first = next(iter(cols.values()))
    cap = len(first[0] if isinstance(first, tuple) else first)
    sel = np.ones(cap, bool) if sel is None else np.asarray(sel, bool)
    jcols, tcols = {}, {}
    for n, v in cols.items():
        vals, valid = v if isinstance(v, tuple) else (v, None)
        vals = np.asarray(vals)
        if vals.dtype.kind == "i":
            vals = vals.astype(np.int64)
        valid = None if valid is None else np.asarray(valid, bool)
        jcols[n] = jbatch.Column(jnp.asarray(vals), None if valid is None
                                 else jnp.asarray(valid))
        tcols[n] = Column(torch.from_numpy(vals.copy()), None
                          if valid is None else torch.from_numpy(valid))
    jb = jbatch.Batch(jcols, jnp.asarray(sel),
                      jnp.asarray(int(sel.sum()), jnp.int32))
    tb = Batch(tcols, torch.from_numpy(sel),
               torch.tensor(int(sel.sum()), dtype=torch.int32))
    return jb, tb


def _bits(a) -> np.ndarray:
    """An array's bits as int64 (uint64 lanes and floats compare by their
    bit patterns)."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _assert_same_result(jres, tres):
    """Every column, sel, length and both flags, bit for bit."""
    jb, tb = jres.batch, tres.batch
    assert list(jb.columns) == list(tb.columns)
    for n, jc in jb.columns.items():
        tc = tb.columns[n]
        jv = np.asarray(jc.values)
        tv = tc.values.numpy()
        assert jv.dtype == tv.dtype, (n, jv.dtype, tv.dtype)
        np.testing.assert_array_equal(_bits(jv), _bits(tv), err_msg=n)
        assert (jc.validity is None) == (tc.validity is None), n
        if jc.validity is not None:
            np.testing.assert_array_equal(np.asarray(jc.validity),
                                          tc.validity.numpy(), err_msg=n)
    np.testing.assert_array_equal(np.asarray(jb.sel), tb.sel.numpy())
    assert int(jb.length) == int(tb.length)
    assert bool(jres.fallback) == bool(tres.fallback)
    assert bool(jres.overflow) == bool(tres.overflow)


def _rows(res, key, cols):
    """{key: (cols...)} over the selected lanes of a port result."""
    b = res.batch
    sel = b.sel.numpy()
    out = {}
    for i in np.nonzero(sel)[0]:
        out[int(b.col(key).values[i])] = tuple(
            int(b.col(c).values[i]) for c in cols)
    return out


def _both_gj(cols_p, cols_b, psel, build_cols, aggs, out_capacity,
             key64=False, wide_payload=False, probe_on="fk", build_on="k",
             key_out="fk"):
    jp, tp = _batches(cols_p, psel)
    jb, tb = _batches(cols_b)
    jres = jgj.group_join_aggregate(
        jp, jb, probe_on, build_on, key_out, jnp.int64, build_cols,
        [JAggSpec(*a) for a in aggs], out_capacity, key64=key64,
        wide_payload=wide_payload)
    tres = tgj.group_join_aggregate(
        tp, tb, probe_on, build_on, key_out, torch.int64, build_cols,
        [AggSpec(*a) for a in aggs], out_capacity, key64=key64,
        wide_payload=wide_payload)
    _assert_same_result(jres, tres)
    return tres


def _both_ik(cols, sel, key, aggs, out_capacity, key64):
    jb, tb = _batches(cols, sel)
    jres = jgj.int_key_aggregate(jb, key, [JAggSpec(*a) for a in aggs],
                                 out_capacity=out_capacity, key64=key64)
    tres = tgj.int_key_aggregate(tb, key, [AggSpec(*a) for a in aggs],
                                 out_capacity=out_capacity, key64=key64)
    _assert_same_result(jres, tres)
    return tres


# --------------------------------------------------------------- bitpack

def _pack_cols(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(-500, 10_000, 64),
        "b": (rng.integers(0, 7, 64), rng.random(64) > 0.3),
        "c": rng.random(64).astype(np.float32),
        "d": rng.random(64) > 0.5,
        "e": rng.integers(-(1 << 40), 1 << 40, 64),
        "f": (rng.integers(0, 1 << 20, 64).astype(np.int32),
              rng.random(64) > 0.5),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_bitpack_roundtrip(seed):
    """plan_pack, pack_lanes and unpack_lanes equal the JAX package's bit
    for bit, and the round trip gives the live columns back."""
    names = ["a", "b", "c", "d", "e", "f"]
    rng = np.random.default_rng(seed + 10)
    jb, tb = _batches(_pack_cols(seed), rng.random(64) > 0.2)
    jplan = jbitpack.plan_pack(jb, names)
    tplan = tbitpack.plan_pack(tb, names)
    assert (jplan.names, jplan.kinds, jplan.nullable) \
        == (tplan.names, tplan.kinds, tplan.nullable)
    for f in ("los", "widths", "offsets", "total_bits"):
        np.testing.assert_array_equal(np.asarray(getattr(jplan, f)),
                                      getattr(tplan, f).numpy(), err_msg=f)
    jpacked = jbitpack.pack_lanes(jb, jplan)
    tpacked = tbitpack.pack_lanes(tb, tplan)
    np.testing.assert_array_equal(_bits(jpacked), tpacked.numpy())
    assert bool(jbitpack.overflow_flag(jplan)) \
        == bool(tbitpack.overflow_flag(tplan))
    assert bool(jbitpack.overflow_flag(jplan, 31)) \
        == bool(tbitpack.overflow_flag(tplan, 31))
    live = tb.sel
    gate = torch.from_numpy(np.arange(64) % 3 != 0)
    for valid_and in (None, gate):
        jcols = jbitpack.unpack_lanes(
            jpacked, jplan, jb,
            None if valid_and is None else jnp.asarray(valid_and.numpy()))
        tcols = tbitpack.unpack_lanes(tpacked, tplan, tb, valid_and)
        for n in names:
            np.testing.assert_array_equal(
                _bits(jcols[n].values), _bits(tcols[n].values.numpy()))
            assert (jcols[n].validity is None) == (tcols[n].validity is None)
            if tcols[n].validity is not None:
                np.testing.assert_array_equal(
                    np.asarray(jcols[n].validity), tcols[n].validity.numpy())
    # the round trip, over columns that fit 63 bits together (all six
    # need more, which overflow_flag reports)
    assert bool(tbitpack.overflow_flag(tplan))
    fit = names[:4]
    tplan = tbitpack.plan_pack(tb, fit)
    assert not bool(tbitpack.overflow_flag(tplan))
    tcols = tbitpack.unpack_lanes(tbitpack.pack_lanes(tb, tplan), tplan, tb)
    for n in fit:
        c = tb.col(n)
        ok = live if c.validity is None else live & c.validity
        np.testing.assert_array_equal(_bits(tcols[n].values[ok].numpy()),
                                      _bits(c.values[ok].numpy()))
        if c.validity is not None:
            np.testing.assert_array_equal(tcols[n].validity[live].numpy(),
                                          c.validity[live].numpy())
    assert tbitpack.packable(tb, names)


def test_bitpack_no_columns_and_wide_widths():
    """A zero-column plan, a 64-bit span (the width's top case) and a
    plan over a batch with no live lane, against the JAX package."""
    jb, tb = _batches({"w": np.array([-(1 << 62), (1 << 62) - 1, 5]),
                       "z": np.array([3, 4, 5])}, [True, True, False])
    for names in ([], ["w"], ["z", "w"]):
        jplan = jbitpack.plan_pack(jb, names)
        tplan = tbitpack.plan_pack(tb, names)
        for f in ("los", "widths", "offsets", "total_bits"):
            np.testing.assert_array_equal(np.asarray(getattr(jplan, f)),
                                          getattr(tplan, f).numpy())
        np.testing.assert_array_equal(
            _bits(jbitpack.pack_lanes(jb, jplan)),
            tbitpack.pack_lanes(tb, tplan).numpy())
    jd, td = _batches({"z": np.array([3, 4, 5])}, [False] * 3)
    jplan, tplan = jbitpack.plan_pack(jd, ["z"]), tbitpack.plan_pack(td, ["z"])
    np.testing.assert_array_equal(np.asarray(jplan.widths),
                                  tplan.widths.numpy())


# ------------------------------------------------------------ group join

def _oracle(pk, plive, pvals, bk, blive, bcols):
    """{key: (build cols..., sum, count)} over matched probe rows."""
    bmap = {}
    for i in range(len(bk)):
        if blive[i]:
            bmap[int(bk[i])] = tuple(int(c[i]) for c in bcols)
    out = {}
    for i in range(len(pk)):
        if not plive[i]:
            continue
        k = int(pk[i])
        if k not in bmap:
            continue
        s, c = out[k][-2:] if k in out else (0, 0)
        out[k] = bmap[k] + (s + int(pvals[i]), c + 1)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@KEY64
def test_groupjoin_random_vs_oracle(seed, key64):
    rng = np.random.default_rng(seed)
    nb, np_ = 64, 256
    bk = rng.permutation(2000)[:nb] - 700          # unique, some negative
    bdate = rng.integers(8000, 14000, nb)
    bprio = rng.integers(0, 3, nb)
    pk = rng.integers(-700, 1400, np_)
    pv = rng.integers(-50, 1000, np_)
    psel = rng.random(np_) > 0.1
    res = _both_gj({"fk": pk, "v": pv},
                   {"k": bk, "date": bdate, "prio": bprio}, psel,
                   ["date", "prio"], [("sum", "v", "s"),
                                      ("count_star", None, "n")],
                   256, key64=key64)
    assert not bool(res.fallback) and not bool(res.overflow)
    want = _oracle(pk, psel, pv, bk, np.ones(nb, bool), [bdate, bprio])
    assert _rows(res, "fk", ["date", "prio", "s", "n"]) == want


@KEY64
def test_groupjoin_null_keys_and_inputs(key64):
    res = _both_gj(
        {"fk": ([1, 1, 2, 3, 9, 1], [True] * 5 + [False]),
         "v": ([5, 7, 11, 13, 17, 19],
               [True, False, True, True, True, True])},
        {"k": ([1, 2, 3, 4], [True, True, False, True]),
         "tag": [10, 20, 30, 40]}, None, ["tag"],
        [("sum", "v", "s"), ("count", "v", "nv"),
         ("count_star", None, "n")], 8, key64=key64)
    assert not bool(res.fallback)
    b = res.batch
    rows = {int(b.col("fk").values[i]):
            (int(b.col("tag").values[i]), int(b.col("s").values[i]),
             bool(b.col("s").validity[i]),
             int(b.col("nv").values[i]), int(b.col("n").values[i]))
            for i in range(b.capacity) if bool(b.sel[i])}
    # key 1: v=5 (valid), v=7 (NULL); key 3's build key is NULL; fk=9 is
    # unmatched; the last probe key is NULL
    assert rows == {1: (10, 5, True, 1, 2), 2: (20, 11, True, 1, 1)}


@KEY64
def test_groupjoin_all_null_sum_group(key64):
    res = _both_gj({"fk": [7, 7], "v": ([1, 2], [False, False])},
                   {"k": [7], "tag": [1]}, None, ["tag"],
                   [("sum", "v", "s"), ("count_star", None, "n")], 4,
                   key64=key64)
    b = res.batch
    i = int(np.argmax(b.sel.numpy()))
    assert int(b.col("n").values[i]) == 2
    assert not bool(b.col("s").validity[i])  # SUM over all-NULL is NULL


@pytest.mark.parametrize("out_cap", [0, 128])
@KEY64
def test_int_key_aggregate_vs_oracle(out_cap, key64):
    rng = np.random.default_rng(4)
    n = 200
    k = rng.integers(-40, 40, n)
    v = rng.integers(-100, 100, n)
    sel = rng.random(n) > 0.15
    res = _both_ik({"k": k, "v": v}, sel, "k",
                   [("sum", "v", "s"), ("count_star", None, "n")],
                   out_cap, key64)
    assert not bool(res.fallback) and not bool(res.overflow)
    want = {}
    for i in range(n):
        if sel[i]:
            s, c = want.get(int(k[i]), (0, 0))
            want[int(k[i])] = (s + int(v[i]), c + 1)
    assert _rows(res, "k", ["s", "n"]) == want


@KEY64
def test_int_key_aggregate_null_key_group(key64):
    res = _both_ik({"k": ([1, 1, 5, 2, 9], [True, True, False, False, True]),
                    "v": ([10, 20, 30, 40, 50],
                          [True, True, True, True, False]),
                    "f": [True, False, True, True, False]}, None, "k",
                   [("sum", "v", "s"), ("count", "v", "nv"),
                    ("sum", "f", "sf")], 8, key64)
    bt = res.batch
    rows = {}
    for i in range(bt.capacity):
        if bool(bt.sel[i]):
            key = int(bt.col("k").values[i]) if bool(
                bt.col("k").validity[i]) else None
            rows[key] = int(bt.col("s").values[i])
    # NULL keys (rows 5, 2 -> v 30 + 40) form ONE group; key 9's only
    # value is NULL, so its SUM is NULL (0)
    assert rows == {1: 30, 9: 0, None: 70}


@KEY64
def test_groupjoin_duplicate_build_keys_flag(key64):
    res = _both_gj({"fk": [1, 2], "v": [5, 6]},
                   {"k": [1, 1, 2], "tag": [10, 11, 20]}, None, ["tag"],
                   [("sum", "v", "s")], 4, key64=key64)
    assert bool(res.fallback)


@KEY64
def test_groupjoin_capacity_overflow_flag(key64):
    nb = 32
    probe = {"fk": np.arange(nb), "v": np.ones(nb, np.int64)}
    build = {"k": np.arange(nb), "tag": np.arange(nb)}
    res = _both_gj(probe, build, None, ["tag"], [("sum", "v", "s")], 8,
                   key64=key64)
    assert bool(res.overflow)
    ok = _both_gj(probe, build, None, ["tag"], [("sum", "v", "s")], 32,
                  key64=key64)
    assert not bool(ok.overflow)
    assert int(ok.batch.length) == nb


@KEY64
def test_groupjoin_wide_build_columns_no_fallback(key64):
    """Build columns of any width gather at the compacted ends: a
    2^40-spread column needs no wide mode."""
    res = _both_gj({"fk": [1, 1, 2], "v": [3, 4, 5]},
                   {"k": [1, 2], "wide": np.asarray([0, 1 << 40], np.int64)},
                   None, ["wide"], [("sum", "v", "s")], 4, key64=key64)
    assert not bool(res.fallback)
    assert _rows(res, "fk", ["wide", "s"]) == {1: (0, 7), 2: (1 << 40, 5)}


@KEY64
def test_groupjoin_wide_agg_inputs_flag_then_wide_mode(key64):
    """Aggregate inputs wider than 31 bits flag in narrow mode and pass
    with wide_payload (the u64 value operand)."""
    probe = {"fk": [1, 2, 2], "v": np.asarray([0, 1 << 40, 5], np.int64)}
    build = {"k": [1, 2], "t": [7, 8]}
    res = _both_gj(probe, build, None, ["t"], [("sum", "v", "s")], 4,
                   key64=key64)
    assert bool(res.fallback)
    res2 = _both_gj(probe, build, None, ["t"], [("sum", "v", "s")], 4,
                    key64=key64, wide_payload=True)
    assert not bool(res2.fallback)
    assert _rows(res2, "fk", ["s"]) == {1: (0,), 2: ((1 << 40) + 5,)}


@KEY64
def test_groupjoin_key_range_flag(key64):
    """Keys spanning more than 2^30 flag with u32 keys and pass with u64
    ones. A span of 2^63 wraps the int64 difference negative: the port
    flags it in both functions (ops/groupjoin.py `_span_too_wide`), where
    the JAX functions' width test passes it, so only the port's flags are
    asserted for it."""
    probe = {"fk": np.asarray([0, 1 << 33], np.int64), "v": [10, 20]}
    build = {"k": np.asarray([0, 1 << 33], np.int64), "tag": [1, 2]}
    res = _both_gj(probe, build, None, ["tag"], [("sum", "v", "s")], 4,
                   key64=key64)
    assert bool(res.fallback) == (not key64)
    if key64:
        assert _rows(res, "fk", ["s"]) == {0: (10,), 1 << 33: (20,)}
    far = {"fk": np.asarray([-(1 << 62), 1 << 62], np.int64), "v": [1, 2]}
    farb = {"k": np.asarray([-(1 << 62), 1 << 62], np.int64), "tag": [1, 2]}
    _jp, tp = _batches(far)
    _jb, tb = _batches(farb)
    gj = tgj.group_join_aggregate(
        tp, tb, "fk", "k", "fk", torch.int64, ["tag"],
        [AggSpec("sum", "v", "s")], 4, key64=key64)
    ik = tgj.int_key_aggregate(tp, "fk", [AggSpec("sum", "v", "s")],
                               out_capacity=4, key64=key64)
    assert bool(gj.fallback) and bool(ik.fallback)
