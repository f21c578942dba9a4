"""The sort-based GROUP BY of the port against the JAX package, on the CPU.

hash64 / hash_columns must equal the JAX package's uint64 hashes bit for
bit (they set the order of groups); so must the prefix scans, searches and
row matrix under them. hash_aggregate (methods hash, lex and ordered) and
the scalar aggregate must equal the JAX ones bit for bit on integer,
decimal and dictionary-code columns, validity and row order. Float
aggregates (sum/avg over float32 accumulate in a different order) are held
to rtol 1e-5, atol 1e-6: tests/test_ops.py holds float32 sums to 1e-6
absolute on values near 1, and the sums here run over a few hundred
values of magnitude ~1. The port's hashes are int64 lanes holding the
uint64 bits, so the JAX side is viewed as int64 to compare."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.ops import agg as jagg
from cockroach_tpu.ops import hash as jhash
from cockroach_tpu.ops import hashtable as jht
from cockroach_tpu.ops import prefix as jprefix
from cockroach_tpu.ops import rowmat as jrowmat
from cockroach_tpu.ops import search as jsearch
from cockroach_tpu.ops import sort as jsort
from cockroach_tpu_torch.coldata.carry import batch_from_arrays
from cockroach_tpu_torch.ops import agg as tagg
from cockroach_tpu_torch.ops import hash as thash
from cockroach_tpu_torch.ops import hashtable as tht
from cockroach_tpu_torch.ops import prefix as tprefix
from cockroach_tpu_torch.ops import rowmat as trowmat
from cockroach_tpu_torch.ops import search as tsearch
from cockroach_tpu_torch.ops import sort as tsort
from torch_threads import one_torch_thread  # noqa: F401

I64 = np.iinfo(np.int64)
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6


def port_batch(jb):
    cols = {n: (np.asarray(c.values),
                None if c.validity is None else np.asarray(c.validity))
            for n, c in jb.columns.items()}
    return batch_from_arrays(cols, np.asarray(jb.sel), int(jb.length), "cpu")


def jax_batch(cols, sel):
    return jbatch.Batch(
        {n: jbatch.Column(jnp.asarray(v),
                          None if m is None else jnp.asarray(m))
         for n, (v, m) in cols.items()},
        jnp.asarray(sel), jnp.int32(int(np.sum(sel))))


def as_i64(x):
    """A JAX uint64 array as the int64 bit pattern the port computes."""
    return np.asarray(x).view(np.int64)


def assert_same_column(jc, tc, what, exact=True):
    a, b = np.asarray(jc.values), tc.values.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if exact or a.dtype.kind != "f":
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
                                   err_msg=what)
    jv = None if jc.validity is None else np.asarray(jc.validity)
    tv = None if tc.validity is None else tc.validity.numpy()
    assert (jv is None) == (tv is None), what
    if jv is not None:
        np.testing.assert_array_equal(tv, jv, err_msg=what)


def assert_same_batch(jb, tb, what, exact_floats=False):
    np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel),
                                  err_msg=what)
    assert int(tb.length) == int(jb.length), what
    assert list(tb.columns) == list(jb.columns), what
    for n in jb.columns:
        assert_same_column(jb.col(n), tb.col(n), f"{what}: {n}",
                           exact=exact_floats)


# ------------------------------------------------------------------ hashes

def _float_payloads():
    f = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, -np.inf, 3e38,
                  1e-45, np.nan], np.float32)
    bits = f.view(np.uint32).copy()
    bits[9] = 0xFFC00001  # a negative NaN with a payload
    return bits.view(np.float32)


_HASH_INPUTS = {
    "int64_extremes": np.array([I64.min, I64.max, -1, 0, 1, 42, -42,
                                1 << 61, -(1 << 61)], np.int64),
    "int32": np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1,
                       0, 7], np.int32),
    "bool": np.array([True, False, True], np.bool_),
    "float32_zero_nan": _float_payloads(),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(_HASH_INPUTS))
def test_hash_column_bit_exact(name, seed):
    x = _HASH_INPUTS[name]
    valid = np.arange(len(x)) % 3 != 1
    for validity in (None, valid):
        want = jhash.hash_column(jnp.asarray(x), None if validity is None
                                 else jnp.asarray(validity), seed=seed)
        got = thash.hash_column(torch.from_numpy(x), None if validity is None
                                else torch.from_numpy(validity), seed=seed)
        np.testing.assert_array_equal(got.numpy(), as_i64(want))


def test_float_hash_folds_signed_zero_and_nans():
    h = thash.hash_column(torch.from_numpy(_float_payloads())).numpy()
    assert h[0] == h[1]          # -0.0 hashes as 0.0
    assert h[2] == h[9]          # every NaN hashes alike


@pytest.mark.parametrize("seed", [0, 3])
def test_hash64_and_combine_bit_exact(seed):
    x = _HASH_INPUTS["int64_extremes"]
    np.testing.assert_array_equal(
        thash.hash64(torch.from_numpy(x), seed).numpy(),
        as_i64(jhash.hash64(jnp.asarray(x), seed)))
    y = x[::-1].copy()
    want = jhash.combine(jnp.asarray(x).view(jnp.uint64),
                         jnp.asarray(y).view(jnp.uint64))
    got = thash.combine(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), as_i64(want))


@pytest.mark.parametrize("seed", [0, 3])
def test_hash_columns_bit_exact(seed):
    rng = np.random.default_rng(11)
    n = 300
    cols = {
        "a": (rng.integers(I64.min, I64.max, n, dtype=np.int64), None),
        "b": (rng.integers(-5, 5, n).astype(np.int32), rng.random(n) > 0.3),
        "c": (rng.random(n) > 0.5, None),
        "d": (rng.standard_normal(n).astype(np.float32), rng.random(n) > 0.2),
    }
    sel = rng.random(n) > 0.2
    jb = jax_batch(cols, sel)
    names = ["a", "b", "c", "d"]
    want = jhash.hash_columns(jb, names, seed=seed)
    got = thash.hash_columns(port_batch(jb), names, seed=seed)
    np.testing.assert_array_equal(got.numpy(), as_i64(want))
    mask = rng.random(n) > 0.5
    want = jhash.hash_columns(jb, names[:2], seed=seed,
                              sel_mask=jnp.asarray(mask))
    got = thash.hash_columns(port_batch(jb), names[:2], seed=seed,
                             sel_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), as_i64(want))


def test_unsigned_order_sorts_as_uint64():
    x = np.array([0, 1, I64.max, I64.min, -1, -2, 5], np.int64)
    got = torch.argsort(thash.unsigned_order(torch.from_numpy(x)),
                        stable=True).numpy()
    np.testing.assert_array_equal(got, np.argsort(x.view(np.uint64),
                                                  kind="stable"))


# ------------------------------------------------- scans, searches, rows

def test_prefix_and_search_match_jax():
    rng = np.random.default_rng(12)
    x = rng.integers(-1000, 1000, 1500).astype(np.int64)
    np.testing.assert_array_equal(
        tprefix.blocked_cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jprefix.blocked_cumsum(jnp.asarray(x))))
    b = rng.random(1500) > 0.5
    want = jprefix.blocked_cumsum(jnp.asarray(b))
    got = tprefix.blocked_cumsum(torch.from_numpy(b))
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = np.sort(rng.integers(-3, 40, 700)).astype(np.int32)
    np.testing.assert_array_equal(
        tsearch.counts_at_most(torch.from_numpy(s), 35).numpy(),
        np.asarray(jsearch.counts_at_most(jnp.asarray(s), 35)))
    np.testing.assert_array_equal(
        tsearch.run_ends(torch.from_numpy(s)).numpy(),
        np.asarray(jsearch.run_ends(jnp.asarray(s))))
    q = rng.integers(-5, 45, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tsearch.searchsorted_left_via_sort(torch.from_numpy(s),
                                           torch.from_numpy(q)).numpy(),
        np.asarray(jsearch.searchsorted_left_via_sort(jnp.asarray(s),
                                                      jnp.asarray(q))))
    np.testing.assert_array_equal(
        tsearch.blocked_assoc_min(torch.from_numpy(x)).numpy(),
        np.asarray(jsearch.blocked_assoc_min(jnp.asarray(x))))


def test_assoc_scan_matches_jax():
    rng = np.random.default_rng(13)
    v = rng.integers(-100, 100, 1100).astype(np.int64)
    f = rng.random(1100) > 0.9

    def combine(x, y):
        a, f1 = x
        b, f2 = y
        return jnp.where(f2, b, jnp.maximum(a, b)), f1 | f2

    def tcombine(x, y):
        a, f1 = x
        b, f2 = y
        return torch.where(f2, b, torch.maximum(a, b)), f1 | f2

    want = jprefix.blocked_assoc_scan(combine, (jnp.asarray(v),
                                                jnp.asarray(f)))
    got = tprefix.blocked_assoc_scan(tcombine, (torch.from_numpy(v),
                                                torch.from_numpy(f)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _mixed_cols(rng, n):
    return {
        "k": (rng.integers(0, 9, n).astype(np.int64), rng.random(n) > 0.2),
        "d": (rng.integers(0, 4, n).astype(np.int32), None),
        "f": (rng.standard_normal(n).astype(np.float32), rng.random(n) > 0.3),
        "b": (rng.random(n) > 0.5, rng.random(n) > 0.4),
        "t": (rng.random(n) > 0.5, None),
        "w": (rng.integers(I64.min, I64.max, n, dtype=np.int64), None),
    }


def test_row_matrix_matches_jax_and_round_trips():
    rng = np.random.default_rng(14)
    n = 400
    jb = jax_batch(_mixed_cols(rng, n), rng.random(n) > 0.2)
    tb = port_batch(jb)
    jmat, _jplan = jrowmat.pack_rows(jb)
    tmat, tplan = trowmat.pack_rows(tb)
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    valid_and = rng.random(n) > 0.5
    jcols, jsel = jrowmat.unpack_rows(jmat, _jplan, jnp.asarray(valid_and))
    tcols, tsel = trowmat.unpack_rows(tmat, tplan,
                                      torch.from_numpy(valid_and))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    for name in jcols:
        assert_same_column(jcols[name], tcols[name], name)
    back, sel = trowmat.unpack_rows(tmat, tplan)
    np.testing.assert_array_equal(sel.numpy(), tb.sel.numpy())
    for name, c in tb.columns.items():
        assert torch.equal(back[name].values, c.values), name


def test_row_matrix_bit_63():
    """The 64th boolean bit is int64's sign bit: it reads back intact."""
    n = 8
    cols = {f"b{i}": (np.arange(n) % (i % 3 + 2) == 0, None)
            for i in range(63)}
    sel = np.arange(n) % 2 == 0
    tb = port_batch(jax_batch(cols, sel))
    mat, plan = trowmat.pack_rows(tb)
    assert plan.bit_index("b62", "val") == 63
    back, got_sel = trowmat.unpack_rows(mat, plan)
    np.testing.assert_array_equal(got_sel.numpy(), sel)
    for name, (v, _m) in cols.items():
        np.testing.assert_array_equal(back[name].values.numpy(), v)


@pytest.mark.parametrize("method", ["lex", "hash"])
def test_sorted_groups_and_group_assignment_match_jax(method):
    rng = np.random.default_rng(15)
    n = 500
    jb = jax_batch(_mixed_cols(rng, n), rng.random(n) > 0.15)
    tb = port_batch(jb)
    keys = ["k", "d", "b"]
    want = jht.sorted_groups(jb, keys, seed=2, method=method)
    got = tht.sorted_groups(tb, keys, seed=2, method=method)
    for field in ("perm", "inv", "boundary", "gid_sorted", "num_groups",
                  "collision"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    ga_w = jht.group_assignment(jb, keys)
    ga_g = tht.group_assignment(tb, keys)
    for field in ("group_id", "leader_row", "num_groups"):
        np.testing.assert_array_equal(getattr(ga_g, field).numpy(),
                                      np.asarray(getattr(ga_w, field)),
                                      err_msg=field)


# ------------------------------------------------------------- aggregates

_AGGS = [("sum", "v"), ("count", "v"), ("count_star", None), ("min", "v"),
         ("max", "v"), ("avg", "v"), ("bool_and", "b"), ("bool_or", "b"),
         ("any_not_null", "v"), ("sum_hi32", "v"), ("sum_lo32", "v"),
         ("sum", "dec"), ("min", "code"), ("max", "day"), ("sum", "day"),
         ("any_not_null", "code"), ("sum", "f"), ("avg", "f"), ("min", "f"),
         ("max", "f"), ("count", "f")]


def _agg_input(seed=21, n=640, sorted_keys=False):
    rng = np.random.default_rng(seed)
    k1 = rng.integers(0, 12, n).astype(np.int64)
    k2 = rng.integers(0, 3, n).astype(np.int32)
    if sorted_keys:
        order = np.lexsort((k2, k1))
        k1, k2 = k1[order], k2[order]
    v = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    v[:4] = [I64.min, I64.max, I64.max, -1]   # sums wrap mod 2^64
    cols = {
        "k1": (k1, None),
        "k2": (k2, None if sorted_keys else rng.random(n) > 0.2),
        "v": (v, rng.random(n) > 0.25),
        "dec": (rng.integers(-10**9, 10**9, n).astype(np.int64), None),
        "code": (rng.integers(0, 7, n).astype(np.int32), rng.random(n) > 0.1),
        "day": (rng.integers(8000, 11000, n).astype(np.int32), None),
        "b": (rng.random(n) > 0.4, rng.random(n) > 0.3),
        "f": (rng.standard_normal(n).astype(np.float32),
              rng.random(n) > 0.2),
    }
    sel = np.ones(n, bool) if sorted_keys else rng.random(n) > 0.1
    return jax_batch(cols, sel)


def _specs(module):
    return [module.AggSpec(f, c, f"o{i}") for i, (f, c) in enumerate(_AGGS)]


@pytest.mark.parametrize("group_by", [("k1", "k2"), ("k2",), ("k1",)])
@pytest.mark.parametrize("method", ["hash", "lex", "ordered"])
def test_hash_aggregate_matches_jax(method, group_by):
    jb = _agg_input(sorted_keys=(method == "ordered"))
    for seed in (0, 5):
        want, wflag = jagg.hash_aggregate(jb, list(group_by), _specs(jagg),
                                          seed=seed, method=method,
                                          with_flag=True)
        got, gflag = tagg.hash_aggregate(port_batch(jb), list(group_by),
                                         _specs(tagg), seed=seed,
                                         method=method, with_flag=True)
        assert bool(gflag) == bool(wflag)
        assert_same_batch(want, got, f"{method} {group_by} seed {seed}")


def test_scalar_aggregate_matches_jax():
    jb = _agg_input()
    want = jagg.hash_aggregate(jb, [], _specs(jagg))
    got = tagg.hash_aggregate(port_batch(jb), [], _specs(tagg))
    assert_same_batch(want, got, "scalar")
    # every function of SUPPORTED, alone, over no live rows
    empty = jb.with_sel(jnp.zeros(jb.capacity, bool))
    for func in tagg.SUPPORTED:
        col = None if func == "count_star" else "v"
        if func in ("bool_and", "bool_or"):
            col = "b"
        w = jagg.hash_aggregate(empty, [], [jagg.AggSpec(func, col, "o")])
        g = tagg.hash_aggregate(port_batch(empty), [],
                                [tagg.AggSpec(func, col, "o")])
        assert_same_batch(w, g, f"empty {func}")


@pytest.mark.parametrize("func", tagg.SUPPORTED)
def test_scalar_agg_each_function_matches_jax(func):
    jb = _agg_input(seed=22)
    for col in (("b",) if func in ("bool_and", "bool_or") else
                (None,) if func == "count_star" else ("v", "code", "f")):
        want = jagg._scalar_agg(jagg.AggSpec(func, col, "o"), jb)
        got = tagg._scalar_agg(tagg.AggSpec(func, col, "o"), port_batch(jb))
        assert_same_column(want, got, f"{func}({col})", exact=False)


def test_ordered_aggregate_matches_jax():
    jb = _agg_input(sorted_keys=True)
    want = jagg.ordered_aggregate(jb, ["k1", "k2"], _specs(jagg))
    got = tagg.ordered_aggregate(port_batch(jb), ["k1", "k2"], _specs(tagg))
    assert_same_batch(want, got, "ordered")


def test_forced_hash_collision_flag_matches_jax(monkeypatch):
    """A constant hash on both sides: every live key shares one hash, the
    groups split, and both packages raise the collision flag alike."""
    jb = _agg_input(seed=23, n=200)
    monkeypatch.setattr(jhash, "hash_columns",
                        lambda b, names, seed=0, sel_mask=None:
                        jnp.zeros(b.capacity, jnp.uint64))
    monkeypatch.setattr(thash, "hash_columns",
                        lambda b, names, seed=0, sel_mask=None:
                        torch.zeros(b.capacity, dtype=torch.int64))
    want, wflag = jagg.hash_aggregate(jb, ["k1"], _specs(jagg),
                                      method="hash", with_flag=True)
    got, gflag = tagg.hash_aggregate(port_batch(jb), ["k1"], _specs(tagg),
                                     method="hash", with_flag=True)
    assert bool(wflag) and bool(gflag)
    assert_same_batch(want, got, "collision")


def test_range_dense_aggregate_still_raises():
    """range_dense_aggregate is ported: over _specs' batch (NULL values,
    dead lanes) it equals the JAX function lane for lane, flag
    included, for a range that holds every key and one that does not."""
    rng = np.random.default_rng(17)
    n = 300
    cols = {"k1": (rng.integers(-3, 40, n).astype(np.int64), None),
            "v": (rng.integers(-10**6, 10**6, n).astype(np.int64),
                  rng.random(n) > 0.2),
            "i": (rng.integers(-99, 99, n).astype(np.int32), None)}
    jb = jax_batch(cols, rng.random(n) > 0.15)
    specs = [("sum", "v", "s"), ("count", "v", "c"),
             ("count_star", None, "n"), ("min", "i", "mn"),
             ("max", "v", "mx"), ("sum_hi32", "v", "h"),
             ("sum_lo32", "v", "l"), ("sum", "i", "si")]
    for lo, span, flag in ((-3, 43, False), (0, 20, True)):
        want, wf = jagg.range_dense_aggregate(
            jb, "k1", lo, span, [jagg.AggSpec(*a) for a in specs])
        got, gf = tagg.range_dense_aggregate(
            port_batch(jb), "k1", lo, span, [tagg.AggSpec(*a) for a in specs])
        assert bool(wf) == bool(gf) == flag
        assert_same_batch(want, got, f"range [{lo}, {lo + span})")


# ------------------------------------------------------------------ top-K

@pytest.mark.parametrize("k", [1, 5, 40, 300])
def test_top_k_with_ties_matches_jax(k):
    rng = np.random.default_rng(31)
    n = 200
    cols = {
        "a": (rng.integers(0, 4, n).astype(np.int64), rng.random(n) > 0.2),
        "b": (rng.integers(0, 3, n).astype(np.int32), None),
        "r": (np.arange(n, dtype=np.int64), None),
    }
    jb = jax_batch(cols, rng.random(n) > 0.2)
    tb = port_batch(jb)
    for keys in ([("a", True), ("b", False)], [("b", False)],
                 [("a", False), ("b", True)]):
        want = jsort.top_k_batch(jb, [jsort.SortKey(c, d) for c, d in keys],
                                 k)
        got = tsort.top_k_batch(tb, [tsort.SortKey(c, d) for c, d in keys],
                                k)
        assert_same_batch(want, got, f"top {k} by {keys}")
    # ties keep input order: the row ids of equal keys ascend
    got = tsort.top_k_batch(tb, [tsort.SortKey("b")], k)
    live = got.sel.numpy()
    b, r = got.col("b").values.numpy()[live], got.col("r").values.numpy()[live]
    for v in np.unique(b):
        assert np.all(np.diff(r[b == v]) > 0)


@pytest.mark.parametrize("method", ["hash", "lex"])
def test_float_keys_with_subnormals_zeros_and_nans_match_jax(method):
    """The JAX package's compiled programs flush subnormals to zero, so a
    subnormal key groups with 0.0 and -0.0 there; every NaN is one
    group. The port groups alike, in the same order."""
    rng = np.random.default_rng(24)
    n = 300
    pool = _float_payloads()[[0, 1, 2, 3, 4, 8, 9]]   # 8: 1e-45
    keys = pool[rng.integers(0, len(pool), n)]
    cols = {"f": (keys, rng.random(n) > 0.1),
            "v": (rng.integers(-50, 50, n).astype(np.int64), None)}
    jb = jax_batch(cols, rng.random(n) > 0.1)
    specs = lambda m: [m.AggSpec("sum", "v", "s"),
                       m.AggSpec("count_star", None, "n")]
    want, wflag = jagg.hash_aggregate(jb, ["f"], specs(jagg), method=method,
                                      with_flag=True)
    got, gflag = tagg.hash_aggregate(port_batch(jb), ["f"], specs(tagg),
                                     method=method, with_flag=True)
    assert not bool(wflag) and not bool(gflag)
    assert int(got.length) == 5   # NULL, 0.0 (+ -0.0, 1e-45), NaN, 1.5, -2.25
    assert_same_batch(want, got, f"float keys {method}", exact_floats=True)
