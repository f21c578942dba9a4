"""Vector similarity: distances, exact top-K, clustered ANN.

Counterpart of cockroach_tpu/ops/vector.py. Brute-force similarity
search is a distance pass feeding a top-K; the planner composes it with
filters (sql/plan.py lowers ORDER BY dist LIMIT k) and this module owns
the math, as torch ops on the device the caller gives (CUDA unless it
passes one).

Two search paths:

- `ExactSearcher`: distances against every row, then the sort-and-slice
  top-K (a stable argsort, so ties break toward the lower row id, the
  order the SQL top-K produces).
- `VectorIndex`: clustered ANN (IVF-flat). k-means (eight Lloyd steps
  from a deterministic strided init, no RNG, so builds are reproducible)
  assigns rows to C centroids; members are grouped into a dense
  (C, m, d) tensor padded to the pow2 at or above the largest cluster. A
  query probes the `nprobe` nearest centroids and ranks only their
  members exactly: the recall/latency dial.

Metrics: "l2" (`<->`, Euclidean) and "cos" (`<=>`, 1 - cosine
similarity), pgvector operator semantics.

Departures from the JAX module, each keeping its contract:
  - Batched search equals per-query search bit for bit. JAX gets this
    from `vmap` of one function. Here one function (`_rank`) ranks a
    batch, and `search` gives it a batch of one: each query's distances
    are reduced over the same contiguous d lanes whatever the batch
    holds.
  - A batch is not padded to a pow2 bucket (nothing is compiled per
    shape), and it runs in chunks of queries sized to a fixed byte
    budget (`CHUNK_BYTES` of broadcast differences), so n 100,000 by d
    64 by 256 queries never materializes 6.5 GB. A chunk holds whole
    queries, so it changes no query's reduction. `slots_dispatched`
    counts the real queries; occupancy is 1.
  - JAX's `jnp.lexsort((ids, d))` is two stable sorts, ids first.
  - k-means' two products (`x @ c.T`, `onehot.T @ x`) are float32
    matmuls with TF32 off (cockroach_tpu_torch/__init__.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cockroach_tpu_torch import resolve_device

_EPS = 1e-30

# bytes of broadcast (queries, rows, d) float32 differences one chunk of
# a batched search may hold
CHUNK_BYTES = 256 << 20


# --- distances --------------------------------------------------------------

def l2_distance(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Euclidean distance along the last axis; broadcasts (n,d) vs (d,),
    (m,1,d) vs (m,n,d) or rowwise. Shared by the expression evaluator
    (ops/expr.py VecDistance) and the searchers below, so the exact SQL
    path and the searchers agree bit for bit."""
    diff = v.to(torch.float32) - q.to(torch.float32)
    return torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 0.0))


def cosine_distance(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity (pgvector `<=>`); zero vectors get distance
    1 (similarity 0) through the epsilon guard."""
    vf = v.to(torch.float32)
    qf = q.to(torch.float32)
    dot = (vf * qf).sum(-1)
    nv = torch.sqrt((vf * vf).sum(-1))
    nq = torch.sqrt((qf * qf).sum(-1))
    return 1.0 - dot / torch.clamp_min(nv * nq, _EPS)


def distance_fn(metric: str):
    if metric == "l2":
        return l2_distance
    if metric == "cos":
        return cosine_distance
    raise ValueError(f"unknown vector metric {metric!r}")


def _pairwise_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n,d) x (C,d) -> (n,C) squared distances in matmul form
    (||x||^2 - 2 x.c + ||c||^2), for k-means assignment, where only the
    argmin matters."""
    x2 = (x * x).sum(1)[:, None]
    c2 = (c * c).sum(1)[None, :]
    return torch.clamp_min(x2 - 2.0 * (x @ c.T) + c2, 0.0)


def pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _chunk_queries(rows: int, dim: int) -> int:
    """Queries per chunk: as many as keep (queries, rows, dim) float32
    differences within CHUNK_BYTES, at least one."""
    return max(1, CHUNK_BYTES // max(1, rows * dim * 4))


def _stable_topk(d: torch.Tensor, k: int) -> torch.Tensor:
    """(m, n) distances -> (m, min(k, n)) positions of the k smallest,
    ties toward the lower position (jnp.argsort is stable)."""
    return torch.argsort(d, dim=1, stable=True)[:, :k]


def _as_queries(qs, dim: int, device) -> torch.Tensor:
    q = torch.as_tensor(np.asarray(qs, dtype=np.float32)).to(device)
    return q.reshape(-1, dim)


# --- exact brute-force search -----------------------------------------------

class ExactSearcher:
    """Exact top-k over a device-resident (n, d) vector image, on
    `device` (CUDA unless the caller passes one)."""

    def __init__(self, vecs: np.ndarray, metric: str = "l2", k: int = 10,
                 device=None):
        vecs = np.asarray(vecs, dtype=np.float32)
        if vecs.ndim != 2:
            raise ValueError(f"vectors must be (n, d), got {vecs.shape}")
        self.device = resolve_device(device)
        self.n, self.dim = vecs.shape
        self.metric, self.k = metric, k
        self.vecs = torch.from_numpy(vecs).to(self.device)
        self._dist = distance_fn(metric)
        self.ops_submitted = 0
        self.slots_dispatched = 0
        self.dispatches = 0

    def nbytes(self) -> int:
        return int(self.n * self.dim * 4)

    def occupancy(self) -> float:
        return (self.ops_submitted / self.slots_dispatched
                if self.slots_dispatched else 0.0)

    def _rank(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(m, d) device queries -> (ids (m,k) int32, dists (m,k))."""
        ids, ds = [], []
        step = _chunk_queries(self.n, self.dim)
        for a in range(0, len(q), step):
            d = self._dist(self.vecs[None, :, :], q[a:a + step, None, :])
            idx = _stable_topk(d, self.k)
            ids.append(idx.to(torch.int32))
            ds.append(torch.gather(d, 1, idx))
        return torch.cat(ids), torch.cat(ds)

    def search(self, q) -> Tuple[np.ndarray, np.ndarray]:
        """One query -> (ids (k,), dists (k,)) numpy: the batched ranking
        on a batch of one."""
        ids, d = self._rank(_as_queries(q, self.dim, self.device))
        return ids[0].cpu().numpy(), d[0].cpu().numpy()

    def search_batch(self, qs, batch_size: int = 256):
        """(m, d) queries -> (ids (m,k), dists (m,k)), one readback per
        batch of `batch_size`; bit-identical to `search`."""
        from cockroach_tpu_torch.exec import stats

        q = _as_queries(qs, self.dim, self.device)
        ids_out, d_out = [], []
        for a in range(0, len(q), batch_size):
            ids, d = self._rank(q[a:a + batch_size])
            n_real = len(ids)
            ids_out.append(ids.cpu().numpy())
            d_out.append(d.cpu().numpy())
            self.ops_submitted += n_real
            self.slots_dispatched += n_real
            self.dispatches += 1
            stats.add("vector.exact_batch", rows=n_real * self.k, events=1)
        if not ids_out:
            return (np.empty((0, self.k), np.int32),
                    np.empty((0, self.k), np.float32))
        return np.concatenate(ids_out), np.concatenate(d_out)


# --- clustered ANN ----------------------------------------------------------

def kmeans(vecs, n_clusters: int, iters: int = 8, device=None):
    """Lloyd's k-means with the deterministic strided init (points at
    n/C strides seed the centroids; no RNG, reproducible builds).
    Returns (centroids (C, d) float32, assignment (n,) int32) on the
    device. Empty clusters keep their previous centroid."""
    dev = resolve_device(device) if not isinstance(vecs, torch.Tensor) \
        else vecs.device
    x = torch.as_tensor(vecs, dtype=torch.float32).to(dev)
    n = x.shape[0]
    init = (torch.arange(n_clusters, device=dev) * n) // n_clusters
    cents = x[init]
    clusters = torch.arange(n_clusters, device=dev)
    for _ in range(iters):
        assign = torch.argmin(_pairwise_sq_l2(x, cents), dim=1)
        onehot = (assign[:, None] == clusters[None, :]).to(torch.float32)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        cents = torch.where((counts > 0)[:, None], new, cents)
    assign = torch.argmin(_pairwise_sq_l2(x, cents), dim=1)
    return cents, assign.to(torch.int32)


class VectorIndex:
    """IVF-flat clustered index: centroids (C, d) and members grouped
    into a dense (C, m, d) tensor (m = pow2 >= max cluster size, dead
    lanes masked), all on one device. `search(q, k, nprobe)` probes the
    nprobe nearest clusters and ranks only their members exactly."""

    def __init__(self, centroids, member_ids, member_vecs, member_valid,
                 metric: str, n: int):
        self.centroids = centroids        # (C, d) float32
        self.member_ids = member_ids      # (C, m) int32
        self.member_vecs = member_vecs    # (C, m, d) float32
        self.member_valid = member_valid  # (C, m) bool
        self.device = centroids.device
        self.metric = metric
        self.n = n
        self.n_clusters, self.m = member_ids.shape
        self.dim = centroids.shape[1]
        self.appended = 0  # rows added since the last full k-means build
        self.ops_submitted = 0
        self.slots_dispatched = 0
        self.dispatches = 0

    @classmethod
    def build(cls, vecs: np.ndarray, metric: str = "l2",
              n_clusters: Optional[int] = None, iters: int = 8,
              device=None) -> "VectorIndex":
        dev = resolve_device(device)
        vecs = np.asarray(vecs, dtype=np.float32)
        n, d = vecs.shape
        if n_clusters is None:
            # ~sqrt(n) clusters, pow2
            n_clusters = max(1, pow2_at_least(max(1, int(np.sqrt(n)) // 2)))
        n_clusters = min(n_clusters, n)
        cents, assign = kmeans(torch.from_numpy(vecs).to(dev), n_clusters,
                               iters)
        assign_np = assign.cpu().numpy()
        order = np.argsort(assign_np, kind="stable")
        counts = np.bincount(assign_np, minlength=n_clusters)
        m = pow2_at_least(max(1, int(counts.max()) if n else 1))
        member_ids = np.zeros((n_clusters, m), np.int32)
        member_vecs = np.zeros((n_clusters, m, d), np.float32)
        member_valid = np.zeros((n_clusters, m), np.bool_)
        off = 0
        for c in range(n_clusters):
            cnt = int(counts[c])
            rows = order[off:off + cnt]
            member_ids[c, :cnt] = rows
            member_vecs[c, :cnt] = vecs[rows]
            member_valid[c, :cnt] = True
            off += cnt
        return cls(cents, torch.from_numpy(member_ids).to(dev),
                   torch.from_numpy(member_vecs).to(dev),
                   torch.from_numpy(member_valid).to(dev), metric, n)

    def nbytes(self) -> int:
        return int(self.centroids.numel() * 4 + self.member_ids.numel() * 4
                   + self.member_vecs.numel() * 4
                   + self.member_valid.numel())

    def drift(self) -> float:
        """Fraction of rows added since the last k-means build; past a
        threshold (~0.25) the centroids no longer describe the data and
        the caller should rebuild rather than keep appending."""
        return self.appended / float(self.n) if self.n else 0.0

    def append(self, vecs: np.ndarray, start_id: Optional[int] = None
               ) -> None:
        """Index new rows incrementally: each vector joins its nearest
        existing centroid's member list (the centroids stay fixed; that
        is the drift `drift()` measures), growing the member bucket to
        the next pow2 when a cluster fills. Ids default to the append
        position (start_id .. start_id + len - 1), the row ids a rebuild
        over the extended image would assign. Host-side surgery and one
        transfer, as in the JAX module."""
        vecs = np.asarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"append expects (n, {self.dim}), got {vecs.shape}")
        if not len(vecs):
            return
        if start_id is None:
            start_id = self.n
        cents = self.centroids.cpu().numpy()
        d2 = (np.sum(vecs * vecs, axis=1)[:, None]
              - 2.0 * (vecs @ cents.T)
              + np.sum(cents * cents, axis=1)[None, :])
        assign = np.argmin(d2, axis=1)
        ids = self.member_ids.cpu().numpy().copy()
        mvecs = self.member_vecs.cpu().numpy().copy()
        valid = self.member_valid.cpu().numpy().copy()
        counts = valid.sum(axis=1).astype(np.int64)
        need = counts + np.bincount(assign, minlength=self.n_clusters)
        m_new = pow2_at_least(max(self.m, int(need.max())))
        if m_new > self.m:
            pad = m_new - self.m
            ids = np.pad(ids, ((0, 0), (0, pad)))
            mvecs = np.pad(mvecs, ((0, 0), (0, pad), (0, 0)))
            valid = np.pad(valid, ((0, 0), (0, pad)))
            self.m = m_new
        for j, c in enumerate(assign):
            slot = int(counts[c])
            ids[c, slot] = start_id + j
            mvecs[c, slot] = vecs[j]
            valid[c, slot] = True
            counts[c] += 1
        dev = self.device
        self.member_ids = torch.from_numpy(ids).to(dev)
        self.member_vecs = torch.from_numpy(mvecs).to(dev)
        self.member_valid = torch.from_numpy(valid).to(dev)
        self.n += len(vecs)
        self.appended += len(vecs)

    def occupancy(self) -> float:
        return (self.ops_submitted / self.slots_dispatched
                if self.slots_dispatched else 0.0)

    def _rank(self, q: torch.Tensor, k: int, nprobe: int):
        """(b, d) device queries -> (ids (b,k) int32, dists (b,k));
        padded slots are id -1 with +inf distance when fewer than k
        candidates were probed."""
        nprobe = min(nprobe, self.n_clusters)
        dist = distance_fn(self.metric)
        ids_out, d_out = [], []
        step = _chunk_queries(nprobe * self.m, self.dim)
        for a in range(0, len(q), step):
            qc = q[a:a + step]
            b = len(qc)
            cd = dist(self.centroids[None, :, :], qc[:, None, :])  # (b, C)
            probe = torch.argsort(cd, dim=1, stable=True)[:, :nprobe]
            cand = self.member_vecs[probe].reshape(b, -1, self.dim)
            cand_ids = self.member_ids[probe].reshape(b, -1)
            cand_ok = self.member_valid[probe].reshape(b, -1)
            d = dist(cand, qc[:, None, :])
            d = torch.where(cand_ok, d, torch.full_like(d, float("inf")))
            # jnp.lexsort((cand_ids, d)): by distance, ties by row id, as
            # two stable sorts (row id first) so ANN ordering matches the
            # exact path's
            o1 = torch.argsort(cand_ids, dim=1, stable=True)
            o2 = torch.argsort(torch.gather(d, 1, o1), dim=1, stable=True)
            sl = torch.gather(o1, 1, o2)[:, :k]
            ok = torch.gather(cand_ok, 1, sl)
            ids_out.append(torch.where(ok, torch.gather(cand_ids, 1, sl),
                                       torch.full_like(sl, -1)
                                       .to(cand_ids.dtype)))
            d_out.append(torch.gather(d, 1, sl))
        return torch.cat(ids_out), torch.cat(d_out)

    def search(self, q, k: int = 10, nprobe: int = 4):
        """One query -> (ids (k,), dists (k,)): the batched ranking on a
        batch of one."""
        ids, d = self._rank(_as_queries(q, self.dim, self.device), k,
                            nprobe)
        return ids[0].cpu().numpy(), d[0].cpu().numpy()

    def search_batch(self, qs, k: int = 10, nprobe: int = 4,
                     batch_size: int = 256):
        """(m_q, d) queries -> (ids (m_q,k), dists (m_q,k)), one readback
        per batch of `batch_size`; bit-identical to `search`."""
        from cockroach_tpu_torch.exec import stats

        q = _as_queries(qs, self.dim, self.device)
        ids_out, d_out = [], []
        for a in range(0, len(q), batch_size):
            ids, d = self._rank(q[a:a + batch_size], k, nprobe)
            n_real = len(ids)
            ids_out.append(ids.cpu().numpy())
            d_out.append(d.cpu().numpy())
            self.ops_submitted += n_real
            self.slots_dispatched += n_real
            self.dispatches += 1
            stats.add("vector.ann_batch", rows=n_real * k, events=1)
        if not ids_out:
            return (np.empty((0, k), np.int32),
                    np.empty((0, k), np.float32))
        return np.concatenate(ids_out), np.concatenate(d_out)


def recall_at_k(ann_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean fraction of exact top-k ids recovered by the ANN ids
    (rowwise set overlap; the standard recall@k)."""
    ann_ids = np.asarray(ann_ids)
    exact_ids = np.asarray(exact_ids)
    if ann_ids.ndim == 1:
        ann_ids, exact_ids = ann_ids[None, :], exact_ids[None, :]
    hits = sum(len(set(a.tolist()) & set(e.tolist()))
               for a, e in zip(ann_ids, exact_ids))
    return hits / float(exact_ids.shape[0] * exact_ids.shape[1])


def parse_vector_literal(text: str) -> Tuple[float, ...]:
    """'[1.0, 2.0, ...]' (pgvector text format) -> float tuple.
    Raises ValueError on malformed input."""
    s = text.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise ValueError(f"malformed vector literal {text!r}")
    body = s[1:-1].strip()
    if not body:
        raise ValueError("empty vector literal")
    return tuple(float(p) for p in body.split(","))
