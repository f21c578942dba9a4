"""The port's vector search against the JAX package's.

The same numpy vectors and queries go through both packages' searchers
(ops/vector.py) and both packages' sessions (VECTOR columns, `<->` and
`<=>`, ORDER BY <distance> LIMIT k on the exact and the ANN arm). The
comparison keeps ties in mind, since each package sums d float32 lanes
in its own order and the last bit may differ: distances agree within
rtol 1e-5, and ids are equal wherever the two candidates' distances
(float64 numpy) differ by more than that. k-means is compared on
well-separated blobs, and ANN search over a JAX index carried into the
port (coldata/carry.py `carry_vector_index`), so cluster membership is
the same. Batched search equals per-query search bit for bit within the
port (its own contract). Each case of tests/test_vector.py has its
counterpart here; the COUNT(DISTINCT) cases run over a table with a
VECTOR column. The card's twins are in
tests/test_torch_stream_vector_cuda.py, which imports no JAX."""

import numpy as np
import pytest
import torch

import cockroach_tpu.ops.vector as jv
import cockroach_tpu.sql.bind as j_bind
import cockroach_tpu.sql.session as j_session
import cockroach_tpu.storage.engine as j_engine
import cockroach_tpu.storage.mvcc as j_mvcc
import cockroach_tpu.util.hlc as j_hlc
import cockroach_tpu.util.settings as j_settings
import cockroach_tpu_torch.ops.vector as tv
import cockroach_tpu_torch.sql.bind as t_bind
import cockroach_tpu_torch.sql.session as t_session
import cockroach_tpu_torch.storage.engine as t_engine
import cockroach_tpu_torch.storage.mvcc as t_mvcc
import cockroach_tpu_torch.util.hlc as t_hlc
import cockroach_tpu_torch.util.settings as t_settings
from cockroach_tpu_torch.coldata.carry import carry_vector_index
from cockroach_tpu_torch.exec import stats as tstats
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _clustered(n, d, n_clusters, rng, noise=0.1):
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign]
            + noise * rng.normal(size=(n, d))).astype(np.float32)


def _vtxt(v):
    return "[" + ",".join(f"{x:.6f}" for x in np.asarray(v)) + "]"


def _oracle(vecs, q, metric="l2"):
    """float64 numpy distances of every row to q."""
    v = vecs.astype(np.float64)
    q = np.asarray(q, np.float64)
    if metric == "l2":
        return np.linalg.norm(v - q, axis=1)
    dot = v @ q
    return 1.0 - dot / np.maximum(np.linalg.norm(v, axis=1)
                                  * np.linalg.norm(q), 1e-30)


def _ids_tie_equal(a, b, dist):
    """Equal id lists, up to swaps between candidates whose distances
    (`dist[id]`, float64) lie within RTOL of each other."""
    a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        if x == y:
            continue
        dx, dy = dist[x], dist[y]
        assert abs(dx - dy) <= RTOL * max(abs(dx), abs(dy), 1e-12), \
            (a, b, x, y, dx, dy)


def _rows_tie_equal(ja, ta, jd, td, vecs, qs, metric="l2"):
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=1e-6)
    for i, q in enumerate(qs):
        _ids_tie_equal(ja[i], ta[i], _oracle(vecs, q, metric))


# ---- distances and the exact searcher --------------------------------------

@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_distances_against_jax(metric):
    rng = np.random.default_rng(10)
    v = rng.normal(size=(200, 16)).astype(np.float32)
    v[3] = 0.0  # the cosine epsilon guard
    q = rng.normal(size=16).astype(np.float32)
    w = rng.normal(size=(200, 16)).astype(np.float32)
    jf, tf = jv.distance_fn(metric), tv.distance_fn(metric)
    for a, b in ((v, q), (v, w)):
        j = np.asarray(jf(a, b))
        t = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert t.dtype == np.float32 and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-6)
    if metric == "cos":
        assert tf(torch.from_numpy(v[3:4]),
                  torch.from_numpy(q)).item() == 1.0
    with pytest.raises(ValueError):
        tv.distance_fn("dot")


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_exact_searcher_against_jax(metric):
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    qs = rng.normal(size=(7, 12)).astype(np.float32)
    je = jv.ExactSearcher(vecs, metric, k=10)
    te = tv.ExactSearcher(vecs, metric, k=10, device="cpu")
    ja, jd = je.search_batch(qs)
    ta, td = te.search_batch(qs)
    assert ta.dtype == np.int32 and td.dtype == np.float32
    _rows_tie_equal(ja, ta, jd, td, vecs, qs, metric)
    assert te.nbytes() == je.nbytes()


def test_exact_search_matches_numpy_oracle():
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    q = rng.normal(size=12).astype(np.float32)
    ids, dists = tv.ExactSearcher(vecs, "l2", k=10, device="cpu").search(q)
    d = np.linalg.norm(vecs - q, axis=1)
    oracle = np.argsort(d, kind="stable")[:10]
    assert ids.tolist() == oracle.tolist()
    np.testing.assert_allclose(dists, d[oracle], atol=1e-5)


@pytest.mark.parametrize("chunk_bytes", [tv.CHUNK_BYTES, 1])
def test_batched_topk_bit_identical_to_per_query(monkeypatch, chunk_bytes):
    """The port's own contract, also with one query per chunk."""
    monkeypatch.setattr(tv, "CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(500, 16)).astype(np.float32)
    qs = rng.normal(size=(9, 16)).astype(np.float32)
    for metric in ("l2", "cos"):
        ex = tv.ExactSearcher(vecs, metric, k=7, device="cpu")
        bids, bdists = ex.search_batch(qs, batch_size=4)
        assert ex.dispatches == 3 and ex.occupancy() == 1.0
        for i, q in enumerate(qs):
            ids, dists = ex.search(q)
            assert np.array_equal(bids[i], ids), (metric, i)
            assert np.array_equal(bdists[i].view(np.int32),
                                  dists.view(np.int32)), (metric, i)


def test_ann_batched_matches_per_query():
    rng = np.random.default_rng(1)
    vecs = _clustered(1000, 8, 10, rng)
    qs = vecs[rng.integers(0, 1000, 6)] + 0.01
    idx = tv.VectorIndex.build(vecs, "l2", n_clusters=10, device="cpu")
    bids, bdists = idx.search_batch(qs, k=5, nprobe=3, batch_size=4)
    for i, q in enumerate(qs):
        ids, dists = idx.search(q, k=5, nprobe=3)
        assert np.array_equal(bids[i], ids), i
        assert np.array_equal(bdists[i].view(np.int32),
                              dists.view(np.int32)), i


# ---- k-means and the clustered index --------------------------------------

def _blobs(n, d, c, rng, spread=20.0, noise=0.05):
    centers = (spread * rng.normal(size=(c, d))).astype(np.float32)
    # members in blob order, so the strided init seeds one per blob
    assign = np.repeat(np.arange(c), n // c)
    return (centers[assign]
            + noise * rng.normal(size=(len(assign), d))).astype(np.float32)


def test_kmeans_against_jax_on_separated_blobs():
    rng = np.random.default_rng(4)
    vecs = _blobs(640, 8, 16, rng)
    jc, ja = jv._kmeans_jit(vecs, 16, 8)
    tc, ta = tv.kmeans(torch.from_numpy(vecs), 16, 8)
    assert ta.dtype == torch.int32 and tc.dtype == torch.float32
    assert np.array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=1e-5)


def test_kmeans_empty_cluster_keeps_its_centroid():
    """Eight identical points and four clusters: the strided init seeds
    all four on the same point, argmin sends every point to cluster 0,
    and the three empty clusters keep their centroids."""
    vecs = np.ones((8, 3), np.float32)
    vecs[4:] = 2.0
    jc, ja = jv._kmeans_jit(vecs, 4, 8)
    tc, ta = tv.kmeans(torch.from_numpy(vecs), 4, 8)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())


def test_index_build_against_jax():
    rng = np.random.default_rng(5)
    vecs = _blobs(512, 8, 8, rng)
    ji = jv.VectorIndex.build(vecs, "l2", n_clusters=8)
    ti = tv.VectorIndex.build(vecs, "l2", n_clusters=8, device="cpu")
    assert (ti.n_clusters, ti.m, ti.dim, ti.n) == (ji.n_clusters, ji.m,
                                                   ji.dim, ji.n)
    assert np.array_equal(np.asarray(ji.member_ids),
                          ti.member_ids.numpy())
    assert np.array_equal(np.asarray(ji.member_valid),
                          ti.member_valid.numpy())
    assert np.array_equal(np.asarray(ji.member_vecs),
                          ti.member_vecs.numpy())
    assert ti.nbytes() == ji.nbytes()


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_ann_over_carried_jax_index(metric):
    rng = np.random.default_rng(13)
    vecs = _clustered(1200, 8, 12, rng)
    qs = (vecs[rng.integers(0, 1200, 9)]
          + 0.02 * rng.normal(size=(9, 8))).astype(np.float32)
    ji = jv.VectorIndex.build(vecs, metric, n_clusters=12)
    ti = carry_vector_index(ji, "cpu")
    assert ti.member_ids.dtype == torch.int32
    assert ti.member_vecs.shape == tuple(np.asarray(ji.member_vecs).shape)
    for k, nprobe in ((5, 2), (10, 4), (3, 12)):
        ja, jd = ji.search_batch(qs, k=k, nprobe=nprobe)
        ta, td = ti.search_batch(qs, k=k, nprobe=nprobe)
        _rows_tie_equal(ja, ta, jd, td, vecs, qs, metric)
    # append on both, then search again
    extra = _clustered(60, 8, 12, rng)
    ji.append(extra)
    ti.append(extra)
    assert (ti.n, ti.appended, ti.m) == (ji.n, ji.appended, ji.m)
    assert np.array_equal(np.asarray(ji.member_ids), ti.member_ids.numpy())
    assert ti.drift() == ji.drift()
    allv = np.concatenate([vecs, extra])
    ja, jd = ji.search_batch(qs, k=10, nprobe=3)
    ta, td = ti.search_batch(qs, k=10, nprobe=3)
    _rows_tie_equal(ja, ta, jd, td, allv, qs, metric)


def test_ann_pads_short_results():
    """Fewer candidates than k: padded slots are id -1 at +inf, as in
    the JAX index."""
    # clusters {0, 1, 3} and {2}: 4-lane member buckets
    vecs = np.array([[0, 0], [0, 1], [100, 100], [0, 2]], np.float32)
    ji = jv.VectorIndex.build(vecs, "l2", n_clusters=2)
    ti = carry_vector_index(ji, "cpu")
    ja, jd = ji.search(vecs[2], k=3, nprobe=1)
    ta, td = ti.search(vecs[2], k=3, nprobe=1)
    assert ta.tolist() == [2, -1, -1]
    assert np.array_equal(np.asarray(ja), ta)
    assert np.array_equal(np.isinf(np.asarray(jd)), np.isinf(td))
    assert (ta == -1).any()


def test_ann_recall_on_clustered_set():
    rng = np.random.default_rng(3)
    vecs = _clustered(2000, 16, 16, rng)
    qs = (vecs[rng.integers(0, 2000, 16)]
          + 0.02 * rng.normal(size=(16, 16))).astype(np.float32)
    ex = tv.ExactSearcher(vecs, "l2", k=10, device="cpu")
    idx = tv.VectorIndex.build(vecs, "l2", n_clusters=16, device="cpu")
    exact_ids, _ = ex.search_batch(qs, batch_size=16)
    ann_ids, _ = idx.search_batch(qs, k=10, nprobe=4, batch_size=16)
    got = tv.recall_at_k(ann_ids, exact_ids)
    assert got >= 0.9
    je = jv.ExactSearcher(vecs, "l2", k=10)
    assert jv.recall_at_k(ann_ids, np.asarray(je.search_batch(qs)[0])) \
        == got
    assert tv.recall_at_k(ann_ids[0], exact_ids[0]) == \
        jv.recall_at_k(ann_ids[0], exact_ids[0])


def test_parse_vector_literal():
    for text in ("[1.0, 2.5,-3]", " [ 4 ] ", "[1e-3,2E2]"):
        assert tv.parse_vector_literal(text) == \
            jv.parse_vector_literal(text)
    assert tv.parse_vector_literal("[1.0, 2.5,-3]") == (1.0, 2.5, -3.0)
    for bad in ("1,2,3", "[1, x]", "[]"):
        with pytest.raises(ValueError):
            tv.parse_vector_literal(bad)
        with pytest.raises(ValueError):
            jv.parse_vector_literal(bad)


def test_searchers_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError):
        tv.ExactSearcher(v)
    with pytest.raises(RuntimeError):
        tv.VectorIndex.build(v)


# ---- SQL layer: each statement on both packages ----------------------------

def _sessions():
    js = j_session.Session(j_session.SessionCatalog(j_mvcc.MVCCStore(
        engine=j_engine.PyEngine(), clock=j_hlc.HLC(j_hlc.ManualClock(
            1000)))), capacity=256)
    ts = t_session.Session(t_session.SessionCatalog(t_mvcc.MVCCStore(
        engine=t_engine.PyEngine(), clock=t_hlc.HLC(t_hlc.ManualClock(
            1000)))), capacity=256, device="cpu")
    return js, ts


def _both(sessions, sql):
    return [s.execute(sql) for s in sessions]


def _ids(res, col="id"):
    return np.asarray(res[1][col]).tolist()


def _load_docs(sessions, vecs, groups=3):
    for s in sessions:
        s.execute("create table docs (id int primary key, grp int, "
                  f"emb vector({vecs.shape[1]}))")
        s.execute("insert into docs values " + ", ".join(
            f"({i}, {i % groups}, '{_vtxt(vecs[i])}')"
            for i in range(len(vecs))))


def _set_ann(on: bool):
    j_settings.Settings().set("sql.vector.ann_topk", on)
    t_settings.Settings().set("sql.vector.ann_topk", on)


def test_filtered_vector_search_vs_oracle():
    sessions = _sessions()
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(60, 6)).astype(np.float32)
    _load_docs(sessions, vecs)
    q = vecs[11]
    d = np.linalg.norm(vecs.astype(np.float64) - q, axis=1)

    jr, tr = _both(sessions, f"select id from docs order by emb <-> "
                             f"'{_vtxt(q)}' limit 5")
    oracle = np.argsort(d, kind="stable")[:5]
    _ids_tie_equal(_ids(tr), oracle, d)
    _ids_tie_equal(_ids(tr), _ids(jr), d)

    jr, tr = _both(sessions, f"select id from docs where grp = 2 "
                             f"order by emb <-> '{_vtxt(q)}' limit 4")
    mask = (np.arange(60) % 3) == 2
    o = np.arange(60)[mask][np.argsort(d[mask], kind="stable")[:4]]
    _ids_tie_equal(_ids(tr), o, d)
    _ids_tie_equal(_ids(tr), _ids(jr), d)

    jr, tr = _both(sessions, f"select id, emb <-> '{_vtxt(q)}' as dist "
                             f"from docs order by emb <-> '{_vtxt(q)}' "
                             f"limit 3")
    np.testing.assert_allclose(np.asarray(tr[1]["dist"]),
                               np.sort(d, kind="stable")[:3], atol=1e-5)
    np.testing.assert_allclose(np.asarray(tr[1]["dist"]),
                               np.asarray(jr[1]["dist"]), rtol=RTOL)
    _ids_tie_equal(_ids(tr), _ids(jr), d)


def test_cosine_operator():
    sessions = _sessions()
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(40, 5)).astype(np.float32)
    _load_docs(sessions, vecs)
    q = vecs[3]
    jr, tr = _both(sessions, f"select id from docs order by emb <=> "
                             f"'{_vtxt(q)}' limit 5")
    d = _oracle(vecs, q, "cos")
    _ids_tie_equal(_ids(tr), np.argsort(d, kind="stable")[:5], d)
    _ids_tie_equal(_ids(tr), _ids(jr), d)


def test_vector_roundtrip_and_null():
    sessions = _sessions()
    for s in sessions:
        s.execute("create table t (id int primary key, emb vector(3))")
        s.execute("insert into t values (1, '[1.5,-2.25,3.0]'), "
                  "(2, null)")
    jr, tr = _both(sessions, "select emb from t where id = 1")
    np.testing.assert_allclose(np.asarray(tr[1]["emb"])[0],
                               [1.5, -2.25, 3.0])
    assert np.array_equal(np.asarray(tr[1]["emb"]),
                          np.asarray(jr[1]["emb"]))
    for sql, want in (("select id from t where emb is null", [2]),
                      ("select id from t order by emb <-> '[0,0,0]' "
                       "limit 2", [1, 2]),
                      ("select id from t order by emb <-> '[0,0,0]' "
                       "limit 1", [1])):
        jr, tr = _both(sessions, sql)
        assert _ids(tr) == _ids(jr) == want, sql


def test_dimension_mismatch_rejected():
    for s in _sessions():
        s.execute("create table t (id int primary key, emb vector(3))")
        with pytest.raises(Exception):
            s.execute("insert into t values (1, '[1,2]')")
        s.execute("insert into t values (1, '[1,2,3]')")
        bind_error = (t_bind.BindError if isinstance(s, t_session.Session)
                      else j_bind.BindError)
        with pytest.raises(bind_error) as err:
            s.execute("select id from t order by emb <-> '[1,2]' limit 1")
        assert "dimension mismatch" in str(err.value)
        with pytest.raises(bind_error):
            s.execute("select id from t order by emb <-> 'nope' limit 1")
        with pytest.raises(bind_error):
            s.execute("select id <-> '[1,2,3]' as d from t")


def test_write_invalidates_cached_vector_image():
    sessions = _sessions()
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(30, 4)).astype(np.float32)
    _load_docs(sessions, vecs)
    q = vecs[9]
    sql = f"select id from docs order by emb <-> '{_vtxt(q)}' limit 2"
    jr, tr = _both(sessions, sql)
    first = _ids(tr)
    assert first[0] == 9 and first == _ids(jr)
    jr, tr = _both(sessions, sql)
    assert _ids(tr) == first == _ids(jr)
    _both(sessions, f"update docs set emb = '{_vtxt(q)}' where id = 21")
    jr, tr = _both(sessions, sql)
    assert set(_ids(tr)) == {9, 21} == set(_ids(jr))
    _both(sessions, "delete from docs where id = 9")
    jr, tr = _both(sessions, sql)
    assert 9 not in _ids(tr)
    assert _ids(tr) == _ids(jr)


def test_ann_path_through_session():
    sessions = _sessions()
    rng = np.random.default_rng(7)
    vecs = _clustered(200, 8, 8, rng)
    _load_docs(sessions, vecs)
    q = vecs[17]
    sql = f"select id from docs order by emb <-> '{_vtxt(q)}' limit 5"
    jr, tr = _both(sessions, sql)
    exact = _ids(tr)
    assert exact == _ids(jr)
    _set_ann(True)
    try:
        jx, tx = _both(sessions, "explain " + sql)
        assert any("ann nprobe=" in ln for ln in tx[1])
        assert [ln.split("  [")[0] for ln in tx[1] if "top-k" in ln] == \
            [ln.split("  [")[0] for ln in jx[1] if "top-k" in ln]
        jr, tr = _both(sessions, sql)
        ann = _ids(tr)
    finally:
        _set_ann(False)
    assert ann[0] == exact[0] == 17
    assert len(set(ann) & set(exact)) >= 3
    assert ann == _ids(jr)
    jx, tx = _both(sessions, f"explain select id from docs where grp = 1 "
                             f"order by emb <-> '{_vtxt(q)}' limit 3")
    assert not any("ann" in ln for ln in tx[1] if "top-k" in ln)


def test_ann_operator_index_appends_below_drift():
    """VectorANNOp over a session table: the first ANN query builds the
    index; an INSERT of 5% more rows appends to it (below
    DRIFT_REBUILD) and the next query finds the new rows; a write that
    reorders rows rebuilds."""
    _, ts = _sessions()
    rng = np.random.default_rng(8)
    vecs = _clustered(200, 8, 8, rng)
    _load_docs([ts], vecs)
    _set_ann(True)
    try:
        new = vecs[:10] + 0.001
        q = new[4]
        sql = f"select id from docs order by emb <-> '{_vtxt(q)}' limit 3"
        col = tstats.enable()
        try:
            first = _ids(ts.execute(sql))
        finally:
            tstats.disable()
        assert col.stages["vector.index_build"].events == 1
        ts.execute("insert into docs values " + ", ".join(
            f"({200 + i}, 0, '{_vtxt(v)}')" for i, v in enumerate(new)))
        col = tstats.enable()
        try:
            got = _ids(ts.execute(sql))
        finally:
            tstats.disable()
        assert "vector.index_build" not in col.stages
        assert col.stages["vector.index_append"].events == 1
        assert got[0] == 204 and first[0] == 4
    finally:
        _set_ann(False)


def test_explain_renders_vector_topk():
    sessions = _sessions()
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(20, 4)).astype(np.float32)
    _load_docs(sessions, vecs)
    jr, tr = _both(sessions, "explain select id from docs order by emb "
                             "<-> '[1,0,0,0]' limit 7")
    assert tr[0] == "explain"
    txt = "\n".join(tr[1])
    assert "vector top-k [exact] emb <-> [4-dim] k=7" in txt
    assert "vector top-k [exact] emb <-> [4-dim] k=7" in "\n".join(jr[1])


def test_count_distinct_vs_oracle():
    sessions = _sessions()
    vals = [(i % 4, i % 7) for i in range(50)]
    for s in sessions:
        s.execute("create table t (g int, v int, emb vector(2))")
        s.execute("insert into t values " + ", ".join(
            f"({g}, {v}, '[{g}.5,{v}]')" for g, v in vals))
    jr, tr = _both(sessions, "select count(distinct v) as n from t")
    assert _ids(tr, "n") == _ids(jr, "n") == [7]
    jr, tr = _both(sessions, "select g, count(distinct v) as n from t "
                             "group by g order by g")
    oracle = {}
    for g, v in vals:
        oracle.setdefault(g, set()).add(v)
    assert _ids(tr, "g") == _ids(jr, "g") == sorted(oracle)
    assert _ids(tr, "n") == _ids(jr, "n") == [
        len(oracle[g]) for g in sorted(oracle)]


def test_count_distinct_null_and_errors():
    sessions = _sessions()
    for s in sessions:
        s.execute("create table t (g int, v int, emb vector(2))")
        s.execute("insert into t values (0, 1, '[0,1]'), (0, 1, null), "
                  "(0, null, '[1,1]'), (1, 2, '[2,2]')")
    jr, tr = _both(sessions, "select count(distinct v) as n from t")
    assert _ids(tr, "n") == _ids(jr, "n") == [2]
    for sql in ("select count(distinct v), sum(v) from t",
                "select count(distinct v), count(distinct g) from t",
                "select sum(distinct v) from t"):
        errs = []
        for s, err in zip(sessions, (j_bind.BindError, t_bind.BindError)):
            with pytest.raises(err) as e:
                s.execute(sql)
            errs.append(str(e.value))
        assert errs[0] == errs[1], sql
