"""The card's cases of the serving slice, held to the port's own CPU
results (this file imports no JAX, so it collects on a machine without
it): each serving runner on CUDA gives the CPU runner's rows bit for bit,
the batched vector ranking equals the per-statement VecDistance path on
the card, and statements that capture CUDA graphs run beside serving
dispatches, replays and readbacks on other threads without a capture
error or a serving fallback. Each test skips without a card;
`python -m pytest -m cuda tests/test_torch_serving_cuda.py` runs them on
one."""

import threading

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec import fused as tf
from cockroach_tpu_torch.sql import serving
from cockroach_tpu_torch.sql.session import Session, SessionCatalog
from cockroach_tpu_torch.storage.engine import PyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util.hlc import HLC, ManualClock
from cockroach_tpu_torch.util.settings import Settings
from torch_threads import one_torch_thread  # noqa: F401


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def serving_settings():
    s = Settings()
    keys = (serving.SERVING_ENABLED, serving.COALESCE_WINDOW_MS,
            serving.MAX_BATCH)
    prev = {k: s.get(k) for k in keys}
    q = serving.serving_queue()
    with q._runners_mu:
        q._runners.clear()
    yield s
    for k, v in prev.items():
        s.set(k, v)


def _table(rng, n, sparse):
    pks = (np.sort(rng.choice(10 * n, n, replace=False)) if sparse
           else np.arange(3, 3 + n))
    cols = {"a": rng.integers(-40, 40, n), "b": rng.integers(-2**62, 2**62, n)}
    valids = {"a": rng.random(n) > 0.2, "b": np.ones(n, bool)}
    return pks.astype(np.int64), cols, valids


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_runners_equal_cpu_on_cuda(sparse):
    _need_card()
    rng = np.random.default_rng(3)
    pks, cols, valids = _table(rng, 700, sparse)
    los = rng.integers(0, int(pks[-1]), 5)
    his = los + rng.integers(0, 300, 5)
    lims = np.array([128, 3, 0, 512, 7])
    for b in (1, 3, 5):
        args = (los[:b], his[:b], lims[:b])
        for make in (
                lambda d: tf.ServingScanRunner(pks, cols, valids, 512,
                                               device=d),
                lambda d: tf.ServingTopKRunner(pks, cols, valids, cols["a"],
                                               valids["a"], True, 512,
                                               device=d),
                lambda d: tf.ServingTopKRunner(pks, cols, valids, cols["a"],
                                               valids["a"], False, 512,
                                               device=d)):
            want, got = make("cpu").run(*args), make("cuda").run(*args)
            for i in range(b):
                c = int(want[2][i])
                assert int(got[2][i]) == c
                assert np.array_equal(want[0][i][:, :c], got[0][i][:, :c])
                assert np.array_equal(want[1][i][:, :c], got[1][i][:, :c])
        aggs = (("count_star", None), ("count", "a"), ("sum", "b"),
                ("avg", "a"), ("min", "a"), ("max", "b"))
        names = ("c", "ca", "sb", "aa", "mn", "mx")
        w = tf.ServingAggRunner(pks, cols, valids, aggs, names, 512,
                                device="cpu").run(los[:b], his[:b])
        g = tf.ServingAggRunner(pks, cols, valids, aggs, names, 512,
                                device="cuda").run(los[:b], his[:b])
        for x, y in zip(w[0] + w[1], g[0] + g[1]):
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.uint8), y.view(np.uint8))


def _vector_catalog(dev, n=3000, d=64):
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store = MVCCStore(engine=PyEngine(), clock=HLC(ManualClock(1000)),
                      device=dev)
    cat = SessionCatalog(store)
    s = Session(cat, capacity=1 << 10, device=dev)
    s.execute(f"create table e (id int primary key, v vector({d}))")
    for a in range(0, n, 500):
        s.execute("insert into e values " + ", ".join(
            "(%d, '[%s]')" % (i, ",".join(repr(float(x)) for x in vecs[i]))
            for i in range(a, min(a + 500, n))))
    return cat, vecs


@pytest.mark.cuda
def test_vector_runner_equals_per_statement_on_cuda(serving_settings):
    _need_card()
    cat, vecs = _vector_catalog("cuda")
    qs = (vecs[:12] + 0.01).astype(np.float32)
    texts = ["select id from e order by v <-> '[%s]' limit 10"
             % ",".join(repr(float(x)) for x in q) for q in qs]
    serving_settings.set(serving.SERVING_ENABLED, False)
    s = Session(cat, capacity=1 << 10, device="cuda")
    want = [np.asarray(s.execute(t)[1]["id"]).tolist() for t in texts]
    spec = serving.match_batchable(serving.P.parse(texts[0]), cat, 1 << 10)
    runner = tf.build_serving_batch_runner(cat, 1 << 10, spec,
                                           device="cuda")
    specs = [serving.match_batchable(serving.P.parse(t), cat, 1 << 10)
             for t in texts]
    for b in (1, 3, 12):
        got = runner.serve(specs[:b])
        assert [p["id"].tolist() for p in got] == want[:b]


@pytest.mark.cuda
def test_captures_beside_serving_on_cuda(serving_settings):
    """Four sessions serve coalesced range scans while a fifth runs
    statements that each capture a new graph: every capture completes,
    every serving member gets its rows, no member falls back."""
    _need_card()
    store = MVCCStore(engine=PyEngine(), clock=HLC(ManualClock(1000)),
                      device="cuda")
    cat = SessionCatalog(store)
    s = Session(cat, capacity=256, device="cuda")
    s.execute("create table t (pk int primary key, v int)")
    s.execute("create table g (k int, v int)")
    s.execute("insert into t values " + ", ".join(
        "(%d, %d)" % (pk, 37 * pk % 1009) for pk in range(512)))
    s.execute("insert into g values " + ", ".join(
        "(%d, %d)" % (i % 7, i) for i in range(512)))
    serving_settings.set(serving.COALESCE_WINDOW_MS, 2.0)
    queries = ["select pk, v from t where pk >= %d and pk < %d order by pk"
               % (lo, lo + 30) for lo in range(0, 400, 50)]
    want = {}
    for q in queries:
        s.execute(q)
        _k, p, _s = s.execute(q)
        want[q] = (p["pk"].tolist(), p["v"].tolist())
    before = serving.serving_queue().snapshot()
    failures, modes = [], []
    stop = threading.Event()

    def member(tid):
        sess = Session(cat, capacity=256, device="cuda")
        i = 0
        while not stop.is_set() and i < 400:
            q = queries[(tid + i) % len(queries)]
            try:
                _k, p, _s = sess.execute(q)
                if (p["pk"].tolist(), p["v"].tolist()) != want[q]:
                    failures.append((q, "rows"))
            except Exception as e:  # noqa: BLE001
                failures.append((q, repr(e)))
            i += 1

    def captures():
        sess = Session(cat, capacity=256, device="cuda")
        for i in range(5):
            q = ("select k, sum(v) as s from g where v >= %d group by k "
                 "order by k" % (i * 10))
            try:
                _k, p, _s = sess.execute(q)
                runner = sess._prepared[q].op._fused_runner
                modes.append(runner.last.get("mode"))
                exp = {}
                for x in range(i * 10, 512):
                    exp[x % 7] = exp.get(x % 7, 0) + x
                if p["s"].tolist() != [exp[k] for k in sorted(exp)]:
                    failures.append((q, "rows"))
            except Exception as e:  # noqa: BLE001
                failures.append((q, repr(e)))
        stop.set()

    threads = [threading.Thread(target=member, args=(t,)) for t in range(4)]
    cap = threading.Thread(target=captures)
    for t in threads:
        t.start()
    cap.start()
    cap.join(120)
    stop.set()
    for t in threads:
        t.join(120)
    assert not failures, failures[:3]
    assert modes == ["capture"] * 5
    d = serving.serving_queue().snapshot()
    assert d["fallbacks"] == before["fallbacks"]
    assert d["batched_dispatch_total"] > before["batched_dispatch_total"]
