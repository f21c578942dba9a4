"""The port's out-of-core paths (cockroach_tpu_torch/exec/spill.py and the
grace and external routes of exec/operators.py) on the CPU, forced by
small workmem budgets.

- The cases of tests/test_spill.py, on the port: the grace join against
  the in-memory join (every join type), the grace GROUP BY, the external
  sort, Q18 at SF 0.01 under 16 KiB per operator against q18_oracle, the
  device-sorted runs and their one host merge, the per-partition retry
  that spares a flow restart, the disk tier behind a 4 KiB host budget,
  the GracePartitioner round trip, the join's overflow flag and the
  DiskQueueFile round trip.
- Against the JAX package on the same numpy input: GracePartitioner's
  partitions row for row, in order, at levels 0 and 1; the DiskQueueFile
  bytes; the external sort's output; the grace join (inner, left, semi,
  anti) and the grace GROUP BY equal to the JAX package's spill output
  in its row order (the partitioning is the same, so the partitions
  replay in the same order) and to its in-memory output as row
  multisets. The JAX flows run once, in a module-scoped fixture, at a
  budget where the JAX grace join partitions once.
- The ladder's spill rung: a RESOURCE error in the streaming tier steps
  down to the spill rung, whose clamp sends Q3's joins through the grace
  join and is undone afterwards; a probe stream that dies mid-partition
  releases the host-spill accounting.

Every test ends with the host-spill monitor at 0 and no spill file left.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cockroach_tpu.coldata import batch as jbatch
from cockroach_tpu.exec import collect as jcollect
from cockroach_tpu.exec import operators as jops
from cockroach_tpu.exec import spill as jspill
from cockroach_tpu.ops.agg import AggSpec as JAggSpec
from cockroach_tpu.ops.sort import SortKey as JSortKey
from cockroach_tpu_torch.coldata.batch import Batch, Column, Field, INT, Schema
from cockroach_tpu_torch.exec import collect as tcollect
from cockroach_tpu_torch.exec import operators as tops
from cockroach_tpu_torch.exec import spill as tspill
from cockroach_tpu_torch.exec import stats
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.join import hash_join
from cockroach_tpu_torch.ops.sort import SortKey
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util.mon import BytesMonitor
from cockroach_tpu_torch.util.settings import Settings
from torch_threads import one_torch_thread  # noqa: F401

HOWS = ("inner", "left", "semi", "anti", "right", "outer")
JAX_HOWS = ("inner", "left", "semi", "anti")
# a budget of 256 build rows (16 bytes each): the 400-row build spills at
# its fifth 64-row batch, and every partition fits one replay, so the
# grace join partitions once
ONE_LEVEL = 256 * 16


def _scan(mod, data, capacity):
    """A ScanOp of `mod` (the JAX or the port's operators) over int64
    columns in one chunk."""
    if mod is jops:
        schema = jbatch.Schema([jbatch.Field(n, jbatch.INT) for n in data])
    else:
        schema = Schema([Field(n, INT) for n in data])
    return mod.ScanOp(schema, lambda: iter([data]), capacity)


def _spill_files():
    return glob.glob(os.path.join(tspill._spill_dir(), "part-*.bin"))


@pytest.fixture
def flow_stats():
    with stats.query_stats() as col:
        yield col
    assert tspill.host_spill_monitor().used == 0
    assert _spill_files() == []


def _events(col, name):
    s = col.stages.get(name)
    return s.events if s else 0


def _rows(res, names):
    return sorted(zip(*(np.asarray(res[n]).tolist() for n in names)))


def _ordered(res, names):
    return list(zip(*(np.asarray(res[n]).tolist() for n in names)))


def _join_data(seed=0):
    rng = np.random.default_rng(seed)
    probe = {"pk": rng.integers(0, 200, 600).astype(np.int64)}
    build = {"bk": rng.integers(0, 200, 400).astype(np.int64),
             "bv": np.arange(400, dtype=np.int64)}
    return probe, build


def _join(mod, how, workmem=None, seed=0):
    probe, build = _join_data(seed)
    kw = {} if workmem is None else {"workmem": workmem}
    return mod.JoinOp(_scan(mod, probe, 64), _scan(mod, build, 64), ["pk"],
                      ["bk"], how=how, **kw)


def _names(how):
    return ["pk"] if how in ("semi", "anti") else ["pk", "bk", "bv"]


def _agg_data():
    rng = np.random.default_rng(1)
    return {"k": rng.integers(0, 700, 2000).astype(np.int64),
            "v": rng.integers(0, 100, 2000).astype(np.int64)}


def _agg(mod, workmem=None):
    A = JAggSpec if mod is jops else AggSpec
    kw = {} if workmem is None else {"workmem": workmem}
    return mod.HashAggOp(_scan(mod, _agg_data(), 128), ["k"],
                         [A("sum", "v", "s"), A("count_star", None, "n"),
                          A("min", "v", "mn")], **kw)


def _sort_data():
    rng = np.random.default_rng(2)
    return {"a": rng.integers(0, 50, 3000).astype(np.int64),
            "b": rng.integers(0, 1000, 3000).astype(np.int64),
            "r": np.arange(3000, dtype=np.int64)}


def _sort(mod, workmem=None):
    K = JSortKey if mod is jops else SortKey
    kw = {} if workmem is None else {"workmem": workmem}
    return mod.SortOp(_scan(mod, _sort_data(), 256),
                      [K("a"), K("b", descending=True)], **kw)


@pytest.fixture(scope="module")
def jax_results():
    """Each JAX flow of the comparisons, run once: the grace join of each
    join type and its in-memory join, the grace and in-memory GROUP BY,
    the external sort."""
    out = {}
    for how in JAX_HOWS:
        out[("join", how)] = jcollect(_join(jops, how, ONE_LEVEL),
                                      fuse=False)
        out[("join_mem", how)] = jcollect(_join(jops, how), fuse=False)
    out["agg"] = jcollect(_agg(jops, 1 << 12), fuse=False)
    out["agg_mem"] = jcollect(_agg(jops), fuse=False)
    out["sort"] = jcollect(_sort(jops, 256 * 24), fuse=False)
    return out


# ------------------------------------------------------ tests/test_spill.py

@pytest.mark.parametrize("how", HOWS)
def test_grace_join_matches_in_memory(how, flow_stats):
    """The JAX test's budget, a single 64-row batch: the grace join
    recurses to its deepest level and equals the in-memory join."""
    want = tcollect(_join(tops, how), device="cpu")
    got = tcollect(_join(tops, how, workmem=64 * 16), device="cpu")
    assert _events(flow_stats, "join.grace_spill") >= 1
    assert flow_stats.stages["spill.write"].rows > 0
    names = [n for n in _names(how) if n in got]
    assert _rows(got, names) == _rows(want, names)


@pytest.mark.parametrize("how", JAX_HOWS)
def test_grace_join_matches_jax(how, jax_results, flow_stats):
    got = tcollect(_join(tops, how, ONE_LEVEL), device="cpu", fuse=False)
    assert _events(flow_stats, "join.grace_spill") == 1
    names = _names(how)
    # the same partitions, replayed in the same order: JAX's row order
    assert _ordered(got, names) == _ordered(jax_results[("join", how)],
                                            names)
    assert _rows(got, names) == _rows(jax_results[("join_mem", how)], names)


def test_grace_join_semi_anti(flow_stats):
    rng = np.random.default_rng(3)
    probe = {"pk": rng.integers(0, 100, 500).astype(np.int64)}
    build = {"bk": rng.integers(0, 50, 300).astype(np.int64)}
    for how in ("semi", "anti"):
        want = tcollect(tops.JoinOp(_scan(tops, probe, 64),
                                    _scan(tops, build, 64), ["pk"], ["bk"],
                                    how=how), device="cpu")
        got = tcollect(tops.JoinOp(_scan(tops, probe, 64),
                                   _scan(tops, build, 64), ["pk"], ["bk"],
                                   how=how, workmem=64 * 16), device="cpu")
        assert sorted(got["pk"].tolist()) == sorted(want["pk"].tolist())
    assert _events(flow_stats, "join.grace_spill") >= 2


def test_grace_agg_matches_in_memory_and_jax(jax_results, flow_stats):
    names = ["k", "s", "n", "mn"]
    want = tcollect(_agg(tops), device="cpu")
    got = tcollect(_agg(tops, workmem=1 << 12), device="cpu")  # 4 KiB
    assert _events(flow_stats, "agg.grace_spill") >= 1
    assert _rows(got, names) == _rows(want, names)
    assert _ordered(got, names) == _ordered(jax_results["agg"], names)
    assert _rows(got, names) == _rows(jax_results["agg_mem"], names)


def test_external_sort_matches_in_memory_and_jax(jax_results, flow_stats):
    want = tcollect(_sort(tops), device="cpu")
    got = tcollect(_sort(tops, workmem=256 * 24), device="cpu")
    assert _events(flow_stats, "sort.external_spill") >= 1
    for c in ("a", "b", "r"):
        np.testing.assert_array_equal(got[c], want[c])
        np.testing.assert_array_equal(got[c], jax_results["sort"][c])
    assert (np.diff(got["a"]) >= 0).all()


def test_q18_with_forced_spill(flow_stats):
    """Q18 at SF 0.01 under 16 KiB per operator, through collect's
    default ladder (the fused tier declines on its workmem rule), equals
    q18_oracle."""
    from cockroach_tpu_torch.util.settings import WORKMEM
    from cockroach_tpu_torch.workload import tpch as ttpch
    from cockroach_tpu_torch.workload import tpch_queries as tq

    gen = ttpch.TPCH(sf=0.01)
    settings = Settings()
    old = settings.get(WORKMEM)
    settings.set(WORKMEM, 1 << 14)
    try:
        flow = tq.q18(gen, threshold=50, capacity=1024)
        got = tcollect(flow, device="cpu")
    finally:
        settings.set(WORKMEM, old)
    assert _events(flow_stats, "agg.grace_spill") >= 1
    assert _events(flow_stats, "fused.fallback_unsupported") >= 1
    o18 = tq.q18_oracle(gen, threshold=50)
    got_rows = list(zip(got["o_orderkey"].tolist(),
                        got["sum_qty"].tolist()))
    assert got_rows == [(ok, q) for cn, ck, ok, od, tp, q in o18]


def test_external_sort_merges_device_sorted_runs(flow_stats):
    n = 5000
    rng = np.random.default_rng(4)
    data = {"a": rng.integers(0, 8, n).astype(np.int64),
            "b": rng.integers(-100, 100, n).astype(np.int64),
            "pay": np.arange(n, dtype=np.int64)}  # pins stability
    keys = [SortKey("a", descending=True), SortKey("b")]
    got = tcollect(tops.SortOp(_scan(tops, data, 128), keys,
                               workmem=128 * 24), device="cpu", fuse=False)
    assert _events(flow_stats, "sort.device_run") >= 2
    assert _events(flow_stats, "sort.host_merge") == 1
    order = np.lexsort((np.arange(n), data["b"], -data["a"]))
    for c in ("a", "b", "pay"):
        np.testing.assert_array_equal(got[c], data[c][order])


def test_grace_agg_partition_retry_no_flow_restart(flow_stats):
    n = 12000
    data = {"k": np.arange(n, dtype=np.int64),
            "v": np.ones(n, dtype=np.int64)}
    agg = tops.HashAggOp(_scan(tops, data, 512), ["k"],
                         [AggSpec("sum", "v", "s")], workmem=900)
    got = tcollect(agg, device="cpu", fuse=False)
    assert _events(flow_stats, "agg.grace_spill") >= 1
    assert _events(flow_stats, "agg.grace_partition_retry") >= 1
    assert _events(flow_stats, "flow.restart") == 0
    assert agg.expansion == 1
    assert sorted(got["k"].tolist()) == list(range(n))
    assert (got["s"] == 1).all()


def test_disk_tier_behind_host_ram(flow_stats, monkeypatch):
    want = tcollect(_join(tops, "inner"), device="cpu")
    monkeypatch.setattr(tspill, "_host_spill_monitor",
                        BytesMonitor("host-spill", budget=4 << 10))
    got = tcollect(_join(tops, "inner", workmem=64 * 16), device="cpu")
    assert tspill.host_spill_monitor().used == 0
    assert flow_stats.stages["spill.disk_write"].rows > 0
    assert flow_stats.stages["spill.disk_read"].rows > 0
    names = ["pk", "bk", "bv"]
    assert _rows(got, names) == _rows(want, names)


def _partitions(gp):
    """Each partition's rows as (values, validity) column dicts."""
    out = []
    for part in gp.partitions:
        blocks = list(part._all_blocks())
        cols = {}
        for name in (blocks[0].values if blocks else ()):
            cols[name] = np.concatenate([b.values[name] for b in blocks])
            cols["v_" + name] = np.concatenate([
                np.ones(b.n_rows, bool) if b.validity[name] is None
                else b.validity[name] for b in blocks])
        out.append(cols)
    return out


@pytest.mark.parametrize("level", [0, 1])
def test_grace_partitioner_matches_jax(level, flow_stats):
    """Every row lands in the JAX partitioner's partition, in its order
    (NULL keys, dead lanes and a two-column key included)."""
    rng = np.random.default_rng(5)
    cap, n_batches = 256, 3
    jgp = jspill.GracePartitioner(["k", "j"], num_partitions=8, level=level)
    tgp = tspill.GracePartitioner(["k", "j"], num_partitions=8, level=level)
    try:
        for _ in range(n_batches):
            k = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
            kv = rng.random(cap) > 0.1
            j = rng.integers(0, 9, cap).astype(np.int32)
            v = np.arange(cap, dtype=np.int64)
            sel = rng.random(cap) > 0.2
            jgp.consume(jbatch.Batch(
                {"k": jbatch.Column(jnp.asarray(k), jnp.asarray(kv)),
                 "j": jbatch.Column(jnp.asarray(j)),
                 "v": jbatch.Column(jnp.asarray(v))},
                jnp.asarray(sel), jnp.int32(int(sel.sum()))))
            tgp.consume(Batch(
                {"k": Column(torch.from_numpy(k), torch.from_numpy(kv)),
                 "j": Column(torch.from_numpy(j)),
                 "v": Column(torch.from_numpy(v))},
                torch.from_numpy(sel),
                torch.tensor(int(sel.sum()), dtype=torch.int32)))
        want, got = _partitions(jgp), _partitions(tgp)
        assert [p.n_rows for p in tgp.partitions] \
            == [p.n_rows for p in jgp.partitions]
        assert sum(1 for p in tgp.partitions if p.n_rows) > 4
        for w, g in zip(want, got):
            assert sorted(w) == sorted(g)
            for name in w:
                np.testing.assert_array_equal(g[name], w[name], name)
    finally:
        jgp.close()
        tgp.close()


def test_grace_partitioner_spill_replay_roundtrip(flow_stats):
    rng = np.random.default_rng(6)
    n = 900
    data = {"k": rng.integers(0, 50, n).astype(np.int64),
            "v": np.arange(n, dtype=np.int64)}
    scan = _scan(tops, data, 64)
    gp = tspill.GracePartitioner(["k"], num_partitions=4)
    gp.consume_stream(scan.batches(torch.device("cpu")))
    assert tspill.host_spill_monitor().used > 0
    assert sum(p.n_rows for p in gp.partitions) == n
    seen, keys_by_part = [], []
    for part in gp.partitions:
        part_keys = set()
        src = tspill.BlockSource(part, scan.schema, 64)
        for b in src.batches(torch.device("cpu")):
            sel = b.sel.numpy()
            ks = b.col("k").values.numpy()[sel]
            vs = b.col("v").values.numpy()[sel]
            seen.extend(zip(ks.tolist(), vs.tolist()))
            part_keys.update(ks.tolist())
        keys_by_part.append(part_keys)
    assert sorted(seen) == sorted(zip(data["k"].tolist(),
                                      data["v"].tolist()))
    for i in range(len(keys_by_part)):
        for j in range(i + 1, len(keys_by_part)):
            assert not (keys_by_part[i] & keys_by_part[j])
    gp.close()


def test_join_result_overflow_flag():
    probe = Batch.from_columns(
        {"a": Column(torch.zeros(32, dtype=torch.int64)),
         "pv": Column(torch.arange(32, dtype=torch.int64))})
    build = Batch.from_columns(
        {"b": Column(torch.zeros(32, dtype=torch.int64)),
         "bv": Column(torch.arange(32, dtype=torch.int64))})
    res = hash_join(probe, build, ["a"], ["b"], how="inner",
                    out_capacity=64)
    assert bool(res.overflow)
    assert int(res.batch.sel.sum()) <= 64
    res = hash_join(probe, build, ["a"], ["b"], how="inner",
                    out_capacity=2048)
    assert not bool(res.overflow)
    sel = res.batch.sel.numpy()
    pairs = set(zip(res.batch.col("pv").values.numpy()[sel].tolist(),
                    res.batch.col("bv").values.numpy()[sel].tolist()))
    assert pairs == {(p, b) for p in range(32) for b in range(32)}


def test_disk_queue_roundtrip_blocks():
    """The port's DiskQueueFile round trip, and its bytes equal the JAX
    package's file of the same blocks."""
    blocks = [
        (3, {"a": np.asarray([1, 2, 3], np.int64),
             "b": np.asarray([0.5, 1.5, 2.5], np.float32)},
         {"a": np.asarray([True, False, True]), "b": None}),
        (2, {"a": np.asarray([9, 8], np.int64),
             "b": np.asarray([7.0, 6.0], np.float32)},
         {"a": None, "b": None}),
    ]
    tf, jf = tspill.DiskQueueFile(), jspill.DiskQueueFile()
    for n, v, m in blocks:
        tf.append(tspill.SpilledBlock(n, v, m))
        jf.append(jspill.SpilledBlock(n, v, m))
    out = list(tf.replay())
    list(jf.replay())
    with open(tf.path, "rb") as a, open(jf.path, "rb") as b:
        assert a.read() == b.read()
    assert len(out) == 2
    np.testing.assert_array_equal(out[0].values["a"], [1, 2, 3])
    np.testing.assert_array_equal(out[0].validity["a"], [True, False, True])
    assert out[0].validity["b"] is None
    np.testing.assert_array_equal(out[1].values["b"],
                                  np.asarray([7.0, 6.0], np.float32))
    tf.close()
    jf.close()
    assert not os.path.exists(tf.path)


# ------------------------------------------------------------- the ladder

class _OomUntilClamped(tops.Operator):
    """Raises a device-OOM error until the ladder's spill rung clamps
    workmem (tests/test_resilience.py's stub, on the port's exceptions)."""

    def __init__(self, inner):
        self.child = inner
        self.schema = inner.schema
        self.workmem = 1 << 30

    def batches(self, device):
        if self.workmem > 64 << 20:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
        yield from self.child.batches(device)


def test_ladder_degrades_to_spill_tier_on_oom(flow_stats):
    """Q3 whose streaming tier runs out of device memory: the spill rung
    clamps every workmem to sql.resilience.spill_workmem_bytes (here
    16 KiB, so the joins go through the grace join), completes with the
    oracle's rows, and restores every workmem afterwards."""
    from cockroach_tpu_torch.workload import tpch as ttpch
    from cockroach_tpu_torch.workload import tpch_queries as tq

    tcircuit.reset_all()
    gen = ttpch.TPCH(sf=0.01)
    op = _OomUntilClamped(tq.q3(gen, 1 << 12))
    before = {id(o): o.workmem for o in tops.walk_operators(op)
              if hasattr(o, "workmem")}
    settings = Settings()
    settings.set(tops.SPILL_TIER_WORKMEM, 1 << 14)
    try:
        res = tcollect(op, device="cpu")
    finally:
        settings.set(tops.SPILL_TIER_WORKMEM, 32 << 20)
        tcircuit.reset_all()
    assert _events(flow_stats, "resilience.degrade.streaming") == 1
    assert _events(flow_stats, "join.grace_spill") >= 1
    rows = list(zip(res["l_orderkey"].tolist(), res["revenue"].tolist(),
                    res["o_orderdate"].tolist(),
                    res["o_shippriority"].tolist()))
    assert rows == tq.q3_oracle_columnar(gen)
    assert {id(o): o.workmem for o in tops.walk_operators(op)
            if hasattr(o, "workmem")} == before


def test_ladder_last_tier_failure_propagates():
    class _AlwaysOom(tops.Operator):
        schema = Schema([Field("k", INT)])
        workmem = 1 << 10  # already below the clamp: the spill rung fails

        def batches(self, device):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
            yield  # pragma: no cover

    tcircuit.reset_all()
    try:
        with stats.query_stats() as col, pytest.raises(
                torch.cuda.OutOfMemoryError):
            tcollect(_AlwaysOom(), device="cpu", fuse=False)
    finally:
        tcircuit.reset_all()
    assert _events(col, "resilience.degrade.streaming") == 1


def test_grace_join_abort_releases_spill_accounting():
    build = {"bk": np.arange(400, dtype=np.int64) % 200,
             "bv": np.arange(400, dtype=np.int64)}
    pschema = Schema([Field("pk", INT)])

    def probe_chunks():
        yield {"pk": np.arange(64, dtype=np.int64) % 200}
        raise ValueError("probe stream died")

    probe = tops.ScanOp(pschema, probe_chunks, 64)
    join = tops.JoinOp(probe, _scan(tops, build, 64), ["pk"], ["bk"],
                       workmem=64 * 16)
    before = tspill.host_spill_monitor().used
    with pytest.raises(ValueError):
        tcollect(join, device="cpu", fuse=False)
    assert tspill.host_spill_monitor().used == before
    assert _spill_files() == []


# ------------------------------------------------------------- on a card

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["join", "agg", "sort"])
def test_out_of_core_on_cuda_matches_cpu(path):
    """The grace join, the grace GROUP BY and the external sort on a CUDA
    device equal their CPU runs row for row, and release every spilled
    byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    make = {"join": lambda: _join(tops, "inner", ONE_LEVEL),
            "agg": lambda: _agg(tops, 1 << 12),
            "sort": lambda: _sort(tops, 256 * 24)}[path]
    want = tcollect(make(), device="cpu", fuse=False)
    with stats.query_stats() as col:
        got = tcollect(make(), device="cuda", fuse=False)
    stage = {"join": "join.grace_spill", "agg": "agg.grace_spill",
             "sort": "sort.external_spill"}[path]
    assert _events(col, stage) >= 1
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], name)
    assert tspill.host_spill_monitor().used == 0
