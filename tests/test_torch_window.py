"""The port's window functions (cockroach_tpu_torch/ops/window.py, WindowOp
and the SQL OVER clause) against the JAX package's.

`compute_windows` runs on the same sorted numpy input in both packages,
for every one of WINDOW_FUNCS: partitions with and without ORDER BY,
ties (RANGE peers), NULL inputs, an all-NULL partition, string min/max
through the dictionary rank, lag/lead at offsets 1, 2 and past the
partition, at n = 1, 63 and 1000. Ints, decimals, counts, ranks,
lag/lead, string codes and validity are bit for bit. Float32 sums (and
the averages over them) associate as each package's cumsum does; they
are held to rtol 1e-4 (the tolerance tests/test_sql.py holds Q1's float
averages to) plus an absolute 1e-4 of the largest running prefix, since
the reference's form subtracts two running prefixes (`cs -
ex[seg_start]`), whose rounding is relative to the prefix and not to the
result. WindowOp runs over a multi-chunk scan on both tiers of `collect`,
and the SQL cases of tests/test_window.py run through both packages'
`run_sql`, the two rejections included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec.operators import ScanOp as JScanOp
from cockroach_tpu.exec.operators import WindowOp as JWindowOp
from cockroach_tpu.ops import window as jw
from cockroach_tpu.ops.sort import SortKey as JSortKey
from cockroach_tpu.sql import TPCHCatalog as JCatalog
from cockroach_tpu.sql import run_sql as jrun_sql
from cockroach_tpu.sql.bind import BindError as JBindError
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.coldata import batch as tbatch
from cockroach_tpu_torch.coldata.carry import batch_from_arrays
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec.operators import ScanOp as TScanOp
from cockroach_tpu_torch.exec.operators import WindowOp as TWindowOp
from cockroach_tpu_torch.ops import window as tw
from cockroach_tpu_torch.ops.sort import SortKey as TSortKey
from cockroach_tpu_torch.sql import plan as tplan
from cockroach_tpu_torch.sql.bind import BindError as TBindError
from cockroach_tpu_torch.sql.bind import run_sql as trun_sql
from cockroach_tpu_torch.workload.tpch import TPCH as TTPCH
from torch_threads import one_torch_thread  # noqa: F401

FLOAT_RTOL = 1e-4
STRINGS = np.array(["pear", "apple", "fig", "kiwi", "banana", "date"],
                   dtype=object)


def _schemas():
    def fields(mod):
        return [mod.Field("p", mod.INT, nullable=True),
                mod.Field("o", mod.INT),
                mod.Field("v", mod.INT, nullable=True),
                mod.Field("f", mod.FLOAT, nullable=True),
                mod.Field("d", mod.DECIMAL(2), nullable=True),
                mod.Field("s", mod.STRING, dict_ref="s", nullable=True)]

    return (jbatch.Schema(fields(jbatch), {"s": STRINGS}),
            tbatch.Schema(fields(tbatch), {"s": STRINGS}))


def _sorted_input(n: int, seed: int, with_order: bool):
    """Columns sorted by (p, o) with padding lanes past n: partition 0 has
    every v, f, d and s NULL (all-NULL partition); o repeats (peers)."""
    rng = np.random.default_rng(seed)
    cap = n + 5
    p = np.sort(rng.integers(0, max(n // 9, 1) + 1, n))
    o = rng.integers(0, 4, n)
    order = np.lexsort((o, p)) if with_order else np.argsort(p, kind="stable")
    p, o = p[order], o[order]
    valid = rng.random(n) > 0.25
    valid[p == 0] = False
    p_valid = np.ones(n, bool)
    if n > 3:
        # a NULL partition key sorts first (NULLS FIRST): lane 0 only
        p_valid[0] = False
    cols = {
        "p": (p.astype(np.int64), p_valid),
        "o": (o.astype(np.int64), None),
        "v": (rng.integers(-50, 50, n).astype(np.int64), valid),
        "f": ((rng.random(n) * 200 - 100).astype(np.float32), valid.copy()),
        "d": (rng.integers(-10**6, 10**6, n).astype(np.int64), valid.copy()),
        "s": (rng.integers(0, len(STRINGS), n).astype(np.int32),
              valid.copy()),
    }
    padded = {}
    for name, (vals, m) in cols.items():
        pv = np.zeros(cap, vals.dtype)
        pv[:n] = vals
        pm = None
        if m is not None:
            pm = np.zeros(cap, bool)
            pm[:n] = m
        padded[name] = (pv, pm)
    sel = np.arange(cap) < n
    return padded, sel, n


def _jax_batch(cols, sel, n):
    jc = {k: jbatch.Column(jnp.asarray(v),
                           None if m is None else jnp.asarray(m))
          for k, (v, m) in cols.items()}
    return jbatch.Batch(jc, jnp.asarray(sel), jnp.asarray(n, jnp.int32))


def _specs(mod, with_order):
    S = mod.WindowSpec
    specs = [S("row_number", None, "rn"), S("rank", None, "rk"),
             S("dense_rank", None, "drk"), S("count", None, "cstar"),
             S("lag", "v", "lag1"), S("lag", "d", "lag2", 2),
             S("lead", "v", "lead1"), S("lead", "s", "lead2", 2),
             S("lag", "v", "lagfar", 1001),
             S("first_value", "v", "fv"), S("last_value", "s", "lv"),
             S("sum", "v", "sv"), S("sum", "d", "sd"), S("sum", "f", "sf"),
             S("count", "v", "cv"), S("avg", "v", "av"),
             S("avg", "f", "af"), S("min", "v", "mnv"),
             S("max", "d", "mxd"), S("min", "f", "mnf"),
             S("max", "f", "mxf"), S("min", "s", "mns"),
             S("max", "s", "mxs")]
    return specs


FLOAT_OUTS = {"sf", "af"}


def _assert_windows(jout, tout, cols, sel):
    live = np.asarray(sel)
    scale = max(float(np.abs(np.cumsum(cols["f"][0].astype(np.float64))
                             ).max(initial=0.0)), 1.0)
    for name, jc in jout.items():
        tc = tout[name]
        jv, tv = np.asarray(jc.values)[live], tc.values.numpy()[live]
        jm = (np.ones(live.sum(), bool) if jc.validity is None
              else np.asarray(jc.validity)[live])
        tm = (np.ones(live.sum(), bool) if tc.validity is None
              else tc.validity.numpy()[live])
        np.testing.assert_array_equal(tm, jm, err_msg=name)
        assert tv.dtype == jv.dtype, name
        if name in FLOAT_OUTS:
            np.testing.assert_allclose(tv[tm], jv[jm], rtol=FLOAT_RTOL,
                                       atol=FLOAT_RTOL * scale,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(tv, jv, err_msg=name)


@pytest.mark.parametrize("n", [1, 63, 1000])
@pytest.mark.parametrize("with_order", [True, False])
def test_compute_windows_matches_jax(n, with_order):
    js, ts = _schemas()
    cols, sel, length = _sorted_input(n, seed=n, with_order=with_order)
    jb = _jax_batch(cols, sel, length)
    tb = batch_from_arrays(cols, sel, length, "cpu")
    jorder = [JSortKey("o")] if with_order else []
    torder = [TSortKey("o")] if with_order else []
    jspecs, tspecs = _specs(jw, with_order), _specs(tw, with_order)
    jout = jax.jit(lambda b: jw.compute_windows(
        b, ("p",), tuple(jorder), tuple(jspecs), js))(jb)
    tout = tw.compute_windows(tb, ("p",), tuple(torder), tuple(tspecs), ts)
    _assert_windows(jout, tout, cols, sel)


def test_compute_windows_without_partition_matches_jax():
    js, ts = _schemas()
    cols, sel, length = _sorted_input(63, seed=7, with_order=True)
    # one partition: order by o alone
    order = np.argsort(cols["o"][0][:length], kind="stable")
    for k, (v, m) in list(cols.items()):
        v = v.copy()
        v[:length] = v[:length][order]
        if m is not None:
            m = m.copy()
            m[:length] = m[:length][order]
        cols[k] = (v, m)
    jb = _jax_batch(cols, sel, length)
    tb = batch_from_arrays(cols, sel, length, "cpu")
    jout = jax.jit(lambda b: jw.compute_windows(
        b, (), (JSortKey("o"),), tuple(_specs(jw, True)), js))(jb)
    tout = tw.compute_windows(tb, (), (TSortKey("o"),),
                              tuple(_specs(tw, True)), ts)
    _assert_windows(jout, tout, cols, sel)


@pytest.mark.parametrize("n", [1, 2, 5, 63, 64, 65, 1000])
def test_segmented_minmax_scan_is_exact(n):
    """The log-step scan equals the JAX associative scan bit for bit,
    NaN lanes included, at sizes that are not powers of two."""
    rng = np.random.default_rng(n)
    vals = (rng.random(n) * 10 - 5).astype(np.float32)
    vals[rng.random(n) < 0.1] = np.nan
    starts = rng.random(n) < 0.2
    starts[0] = True
    for jop, top in ((jnp.minimum, torch.minimum),
                     (jnp.maximum, torch.maximum)):
        want = np.asarray(jax.jit(lambda v, s: jw._seg_scan_minmax(
            v, s, jop))(jnp.asarray(vals), jnp.asarray(starts)))
        got = tw._seg_scan_minmax(torch.from_numpy(vals),
                                  torch.from_numpy(starts), top).numpy()
        np.testing.assert_array_equal(got, want)
        ints = rng.integers(-100, 100, n)
        want = np.asarray(jw._seg_scan_minmax(jnp.asarray(ints),
                                              jnp.asarray(starts), jop))
        got = tw._seg_scan_minmax(torch.from_numpy(ints),
                                  torch.from_numpy(starts), top).numpy()
        np.testing.assert_array_equal(got, want)


def _scans(cols, capacity):
    def source(mod, scan_cls):
        schema = mod.Schema([mod.Field(k, mod.INT) for k in cols])

        def chunks():
            yield {k: np.asarray(v, dtype=np.int64) for k, v in cols.items()}

        return scan_cls(schema, chunks, capacity)

    return source(jbatch, JScanOp), source(tbatch, TScanOp)


@pytest.mark.parametrize("fuse", [True, False])
def test_window_op_multi_chunk_matches_jax(fuse):
    """WindowOp over a scan of 300 rows in 32-row chunks (partitions span
    chunks), on both tiers of collect."""
    rng = np.random.default_rng(1)
    n = 300
    cols = {"p": rng.integers(0, 3, n), "o": rng.integers(0, 50, n),
            "v": rng.integers(0, 10, n)}
    jsrc, tsrc = _scans(cols, 32)
    jspecs = [jw.WindowSpec(f, c, o) for f, c, o in (
        ("sum", "v", "rsum"), ("rank", None, "rk"), ("max", "v", "mx"),
        ("lead", "v", "ld"), ("avg", "v", "av"))]
    tspecs = [tw.WindowSpec(s.func, s.col, s.out) for s in jspecs]
    want = jcollect(JWindowOp(jsrc, ["p"], [JSortKey("o")], jspecs))
    got = tcollect(TWindowOp(tsrc, ["p"], [TSortKey("o")], tspecs),
                   device="cpu", fuse=fuse)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def cats():
    return JCatalog(JTPCH(sf=0.01)), tplan.TPCHCatalog(TTPCH(sf=0.01))


WINDOW_SQL = [
    "select n_regionkey, n_nationkey, "
    "row_number() over (partition by n_regionkey "
    "                   order by n_nationkey) as rn, "
    "sum(n_nationkey) over (partition by n_regionkey "
    "                       order by n_nationkey) as rs "
    "from nation",
    "select n_nationkey, "
    "lag(n_nationkey, 2) over (order by n_nationkey) as l2, "
    "lead(n_nationkey, 1) over (order by n_nationkey) as f1 "
    "from nation",
    "select n_name, max(n_name) over (partition by n_regionkey) as mx, "
    "min(n_name) over (partition by n_regionkey) as mn, "
    "count(*) over (partition by n_regionkey) as c from nation",
]


@pytest.mark.parametrize("sql", WINDOW_SQL)
def test_sql_window_matches_jax(cats, sql):
    jcat, tcat = cats
    want = jrun_sql(sql, jcat, capacity=64)
    got = trun_sql(sql, tcat, capacity=64, device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("sql", [
    "select count(distinct n_regionkey) over "
    "(partition by n_regionkey) from nation",
    "select n_regionkey, row_number() over (order by n_regionkey) "
    "from nation group by n_regionkey",
])
def test_sql_window_rejections_match_jax(cats, sql):
    jcat, tcat = cats
    with pytest.raises(JBindError) as je:
        jrun_sql(sql, jcat, capacity=64)
    with pytest.raises(TBindError) as te:
        trun_sql(sql, tcat, capacity=64, device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.cuda
def test_window_sql_on_card(cats):
    """The window queries on a CUDA device, on both tiers, equal the CPU
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _jcat, tcat = cats
    for sql in WINDOW_SQL:
        want = trun_sql(sql, tcat, capacity=64, device="cpu")
        got = trun_sql(sql, tcat, capacity=64, device="cuda")
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
