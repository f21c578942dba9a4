"""The port's joins against the JAX package's, on the CPU, bit for bit:
values, validity, selection and row order of the output batch, the
deferred overflow/fallback flag and the matched-build flags.

The three build modes are held against JAX for the six join types: the
unique sort join with the payload carry ("unique", whose tracking probes
build the row matrix lazily) and with the row matrix ("unique-mat"),
ops/sortjoin.py probe_unique, and the general expand path (ops/join.py
_probe_sorted). The inputs
carry NULL keys and dead lanes on both sides, a duplicate live build key
(the unique path's fallback flag), an int key outside ±2^61 (its
range_flag), a float key and a two-column key (the hash-keyed kind). The
streaming JoinOp's restart ladder (unique -> unique-mat -> expand ->
doubled expansion) is held against the JAX JoinOp through both
collects."""

import numpy as np
import pytest

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu_torch.coldata.batch import Field, INT, Schema
from cockroach_tpu_torch.coldata.carry import batch_from_arrays
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import operators as tops
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import sortjoin as tsortjoin
from torch_threads import one_torch_thread  # noqa: F401

HOWS = ("inner", "left", "semi", "anti", "right", "outer")


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


def assert_same_batch(jb, tb, what):
    np.testing.assert_array_equal(tb.sel.numpy(), np.asarray(jb.sel),
                                  err_msg=what)
    assert int(tb.length) == int(jb.length), what
    assert list(tb.columns) == list(jb.columns), what
    for n in jb.columns:
        jc, tc = jb.col(n), tb.col(n)
        np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values),
                                      err_msg=f"{what}: {n}")
        jv = None if jc.validity is None else np.asarray(jc.validity)
        tv = None if tc.validity is None else tc.validity.numpy()
        assert (jv is None) == (tv is None), f"{what}: {n}"
        if jv is not None:
            np.testing.assert_array_equal(tv, jv, err_msg=f"{what}: {n}")


def _sides(case: str, seed: int = 0):
    """(probe, build) as JAX batches, with on-columns for `case`."""
    rng = np.random.default_rng(seed)
    nr, nl = 96, 260
    rk = rng.permutation(150)[:nr].astype(np.int64)
    rkv = rng.random(nr) > 0.1          # NULL build keys
    rsel = rng.random(nr) > 0.1         # dead build lanes
    if case == "duplicate":
        rk[7], rkv[7], rsel[7] = rk[3], True, True
        rkv[3], rsel[3] = True, True
    lk = rng.integers(0, 170, nl).astype(np.int64)
    lk[:8] = rk[3]                      # probes of the duplicated key
    if case == "range":
        rk[5], rkv[5], rsel[5] = 1 << 61, True, True
        lk[9] = 1 << 61
    build = {
        "rk": (rk, rkv),
        "rv": (rng.integers(-1000, 1000, nr).astype(np.int64), None),
        "rd": (rng.integers(0, 5, nr).astype(np.int32), rng.random(nr) > 0.2),
        "rf": (rng.standard_normal(nr).astype(np.float32), None),
        "rb": (rng.random(nr) > 0.5, rng.random(nr) > 0.3),
    }
    probe = {
        "lk": (lk, rng.random(nl) > 0.1),
        "lv": (rng.integers(-9, 9, nl).astype(np.int32), None),
        "lk2": (lk % 7, None),
    }
    build["rk2"] = (rk % 7, None)
    if case == "float":
        # subnormal keys equal 0.0 (the JAX package flushes them), and
        # -0.0 equals 0.0
        tiny = np.float32(1e-45)
        rf = rk.astype(np.float32)
        rf[rk == 0] = 500.0
        rf[10], rkv[10], rsel[10] = tiny, True, True
        lf = lk.astype(np.float32)
        lf[lk == 0] = -0.0
        lf[1] = tiny
        build["rk"] = (rf, rkv)
        probe["lk"] = (lf, probe["lk"][1])
    on = (["lk", "lk2"], ["rk", "rk2"]) if case == "two_keys" else (
        ["lk"], ["rk"])
    lsel = rng.random(nl) > 0.1
    return jax_batch(probe, lsel), jax_batch(build, rsel), on


CASES = ("plain", "duplicate", "range", "float", "two_keys")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["unique", "unique-mat", "expand"])
def test_join_matches_jax(mode, case):
    jl, jr, (lon, ron) = _sides(case)
    tl, tr = port_batch(jl), port_batch(jr)
    jbt = jjoin.prepare_build(jr, ron, seed=2, mode=mode)
    tbt = tjoin.prepare_build(tr, ron, seed=2, mode=mode)
    for how in HOWS:
        for out_cap in (None, 200):
            what = f"{mode} {case} {how} out_capacity={out_cap}"
            want = jjoin.hash_join_prepared(jl, jbt, lon, ron, how=how,
                                            out_capacity=out_cap,
                                            track_build=True)
            got = tjoin.hash_join_prepared(tl, tbt, lon, ron, how=how,
                                           out_capacity=out_cap,
                                           track_build=True)
            assert bool(got.overflow) == bool(want.overflow), what
            assert_same_batch(want.batch, got.batch, what)
            np.testing.assert_array_equal(got.matched_build.numpy(),
                                          np.asarray(want.matched_build),
                                          err_msg=what)


@pytest.mark.parametrize("case,flag", [("plain", False), ("duplicate", True),
                                       ("range", True)])
def test_unique_fallback_flag(case, flag):
    """The unique path flags a duplicate live build key and an int key
    outside ±2^61, and nothing else."""
    jl, jr, (lon, ron) = _sides(case)
    got = tjoin.hash_join(port_batch(jl), port_batch(jr), lon, ron,
                          mode="unique-mat")
    want = jjoin.hash_join(jl, jr, lon, ron, mode="unique-mat")
    assert bool(got.overflow) == bool(want.overflow) == flag


def test_prepared_builds_match_jax():
    jl, jr, (lon, ron) = _sides("plain")
    tr = port_batch(jr)
    ub = tjoin.prepare_build(tr, ron, mode="unique-mat")
    assert isinstance(ub, tsortjoin.UniqueBuild) and ub.key_kind == "int"
    want = jjoin.prepare_build(jr, ron, mode="unique-mat")
    np.testing.assert_array_equal(ub.packed.numpy(),
                                  np.asarray(want.packed).view(np.int64))
    np.testing.assert_array_equal(ub.mat.numpy(), np.asarray(want.mat))
    bt = tjoin.prepare_build(tr, ron, seed=1, mode="expand")
    wbt = jjoin.prepare_build(jr, ron, seed=1, mode="expand")
    np.testing.assert_array_equal(bt.order.numpy(), np.asarray(wbt.order))
    np.testing.assert_array_equal(bt.run_end.numpy(), np.asarray(wbt.run_end))


def test_effective_build_mode_and_unported_carry():
    """The static downgrade of both unique modes, and the payload-carry
    build ("unique"), now ported: its narrow keys, packed payload and
    range flag equal the JAX package's, and a probe through it equals
    the JAX probe."""
    names = [f"c{i}" for i in range(40)]
    for mode in ("unique", "unique-mat"):
        assert tjoin.effective_build_mode(mode, names, ["c0"]) == "expand"
        assert tjoin.effective_build_mode(mode, names[:5], ["c0"]) == mode
    jl, jr, (lon, ron) = _sides("plain")
    ub = tjoin.prepare_build(port_batch(jr), ron, mode="unique")
    want = jjoin.prepare_build(jr, ron, mode="unique")
    assert ub.mat is None and want.mat is None and ub.narrow
    np.testing.assert_array_equal(ub.packed.numpy(),
                                  np.asarray(want.packed).astype(np.int64))
    np.testing.assert_array_equal(ub.payv.numpy(),
                                  np.asarray(want.payv).view(np.int64))
    assert bool(ub.range_flag) == bool(want.range_flag) is False
    for how in ("inner", "left", "semi", "anti"):
        got = tjoin.hash_join_prepared(port_batch(jl), ub, lon, ron, how=how)
        exp = jjoin.hash_join_prepared(jl, want, lon, ron, how=how)
        assert bool(got.overflow) == bool(exp.overflow) is False
        assert_same_batch(exp.batch, got.batch, how)


def _scan_pair(cols, capacity):
    """A JAX ScanOp and a port ScanOp over the same numpy chunks."""
    names = list(cols)
    jschema = jbatch.Schema([jbatch.Field(n, jbatch.INT) for n in names])
    tschema = Schema([Field(n, INT) for n in names])
    n = len(cols[names[0]])
    chunks = [{k: v[a:a + capacity] for k, v in cols.items()}
              for a in range(0, n, capacity)]
    return (jops.ScanOp(jschema, lambda: iter(chunks), capacity),
            tops.ScanOp(tschema, lambda: iter(chunks), capacity))


@pytest.mark.parametrize("how", HOWS)
def test_streaming_join_restart_ladder_matches_jax(how):
    """Duplicate build keys: the unique path flags at the end of the
    stream, the operator restarts in expand mode (and doubles its
    expansion while the pairs overflow), and the rows equal the JAX
    JoinOp's through its own restarts."""
    rng = np.random.default_rng(41)
    cap = 64
    build = {"bk": rng.integers(0, 40, 150).astype(np.int64),
             "bv": np.arange(150, dtype=np.int64)}
    probe = {"pk": rng.integers(0, 50, 200).astype(np.int64),
             "pv": np.arange(200, dtype=np.int64)}
    jp, tp = _scan_pair(probe, cap)
    jb, tb = _scan_pair(build, cap)
    jop = jops.JoinOp(jp, jb, ["pk"], ["bk"], how=how)
    top = tops.JoinOp(tp, tb, ["pk"], ["bk"], how=how)
    want = jcollect(jop, fuse=False)
    with stats.query_stats() as col:
        got = tcollect(top, device="cpu", fuse=False)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert top.build_mode == jop.build_mode == "expand"
    assert top.expansion == jop.expansion
    # two restarts into expand (unique -> unique-mat -> expand: the
    # streaming path runs unique as unique-mat, as the JAX JoinOp's
    # does), then one per doubling of the expansion
    doublings = top.expansion.bit_length() - 1
    assert col.stages["flow.restart"].events == 2 + doublings
