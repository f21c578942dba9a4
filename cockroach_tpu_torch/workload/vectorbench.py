"""Vector-search benchmark: exact vs clustered-ANN top-K on device.

Counterpart of cockroach_tpu/workload/vectorbench.py; `run` takes the
device the searchers run on (CUDA unless the caller passes one). The
searchers return host arrays, so each timed call includes its readback.

The workload is the pgvector-style serving shape: N stored embeddings,
a stream of query vectors, `ORDER BY emb <-> $1 LIMIT k`. Two engines
answer it (ops/vector.py): the exact brute-force searcher (distance +
top-K over every row, the correctness oracle and the predicate-filtered
path) and the clustered-ANN index (k-means centroids + nprobe-probed
members — the CREATE VECTOR INDEX analog).

`run()` emits the bench JSON `vector` block: recall@k of ANN against
exact, per-query p50/p99 latency for both engines, batched queries/s
(one batched search for a whole query batch), and the exact->ANN
speedup on the same data. Dataset is clustered Gaussian blobs so ANN
recall is meaningful (uniform data makes every probe equally bad).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np


def make_dataset(n: int, d: int, n_clusters: int, rng,
                 noise: float = 0.15):
    """Clustered unit-ish vectors: `n_clusters` Gaussian blobs on the
    sphere. Returns (vectors, blob assignment)."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    vecs = centers[assign] + noise * rng.normal(size=(n, d)).astype(
        np.float32)
    return vecs.astype(np.float32), assign


def make_queries(vecs: np.ndarray, n_queries: int, rng,
                 noise: float = 0.05) -> np.ndarray:
    """Queries near stored points (the serving distribution: look-alikes,
    not uniform noise)."""
    picks = rng.integers(0, len(vecs), n_queries)
    qs = vecs[picks] + noise * rng.normal(
        size=(n_queries, vecs.shape[1])).astype(np.float32)
    return qs.astype(np.float32)


def _per_query_ms(search_one, qs: np.ndarray, runs: int):
    """Median-of-runs per-query latencies -> (p50_ms, p99_ms)."""
    lat = []
    for q in qs:
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            search_one(q)
            ts.append(time.perf_counter() - t0)
        lat.append(statistics.median(ts) * 1e3)
    lat.sort()
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    return round(p50, 3), round(p99, 3)


def run(n: int = 100_000, d: int = 64, n_queries: int = 64,
        k: int = 10, n_clusters: int = 64, nprobe: int = 8,
        runs: int = 3, metric: str = "l2", seed: int = 0,
        log=lambda _m: None, device=None) -> Dict:
    """-> the bench JSON `vector` block."""
    from cockroach_tpu_torch.ops.vector import (
        ExactSearcher, VectorIndex, recall_at_k,
    )

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    vecs, _assign = make_dataset(n, d, n_clusters, rng)
    qs = make_queries(vecs, n_queries, rng)
    t_gen = time.perf_counter() - t0

    exact = ExactSearcher(vecs, metric, k, device=device)
    t0 = time.perf_counter()
    index = VectorIndex.build(vecs, metric, n_clusters=n_clusters,
                              device=exact.device)
    exact.search(qs[0])          # compile + device transfer off the clock
    index.search(qs[0], k, nprobe)
    t_build = time.perf_counter() - t0

    # recall@k over the whole query set (batched: one dispatch each)
    exact_ids, _ = exact.search_batch(qs, batch_size=n_queries)
    ann_ids, _ = index.search_batch(qs, k=k, nprobe=nprobe,
                                    batch_size=n_queries)
    recall = recall_at_k(ann_ids, exact_ids)

    # per-query latency: the single-dispatch serving path
    ex_p50, ex_p99 = _per_query_ms(exact.search, qs, runs)
    an_p50, an_p99 = _per_query_ms(
        lambda q: index.search(q, k, nprobe), qs, runs)

    # batched throughput: B queries in one batched search
    bt = []
    for _ in range(max(1, runs)):
        t0 = time.perf_counter()
        exact.search_batch(qs, batch_size=n_queries)
        bt.append(time.perf_counter() - t0)
    t_exact_batch = statistics.median(bt)
    bt = []
    for _ in range(max(1, runs)):
        t0 = time.perf_counter()
        index.search_batch(qs, k=k, nprobe=nprobe,
                           batch_size=n_queries)
        bt.append(time.perf_counter() - t0)
    t_ann_batch = statistics.median(bt)

    blk = {
        "n": n, "d": d, "k": k, "metric": metric,
        "n_clusters": index.n_clusters, "nprobe": nprobe,
        "recall_at_k": round(float(recall), 4),
        "exact_p50_ms": ex_p50, "exact_p99_ms": ex_p99,
        "ann_p50_ms": an_p50, "ann_p99_ms": an_p99,
        "ann_speedup_p50": round(ex_p50 / max(an_p50, 1e-9), 2),
        "exact_queries_per_sec": round(n_queries / t_exact_batch),
        "ann_queries_per_sec": round(n_queries / t_ann_batch),
        "ann_batch_speedup": round(t_exact_batch / t_ann_batch, 2),
        "index_build_s": round(t_build, 2),
        "index_mb": round(index.nbytes() / 1e6, 1),
        "datagen_s": round(t_gen, 2),
    }
    log(f"vector: n={n} d={d} k={k} recall@{k}={blk['recall_at_k']} "
        f"exact p50={ex_p50}ms ann p50={an_p50}ms "
        f"({blk['ann_speedup_p50']}x), batched "
        f"{blk['exact_queries_per_sec']:,}/{blk['ann_queries_per_sec']:,}"
        f" q/s (exact/ann)")
    return blk
