"""YCSB workload over the MVCC store — north-star config #5.

Counterpart of cockroach_tpu/workload/ycsb.py. Reference:
pkg/workload/ycsb/ycsb.go (workload E at :212,:300 — 95% SCAN / 5%
INSERT, scan length uniform in [1, 100], zipfian key choice, 10 value
fields). The reference's fields are 100-byte strings; here a row is 10
int64 fields — the fixed-width codec the native scanner decodes
column-major (storage/mvcc.py), which is also how strings ride device
lanes (dictionary codes).

Two measurement modes:
  - `run_e`: the classic operational mix — per-op MVCC range scans on the
    CPU engine (the reference path being matched: storage.MVCCScanToCols
    per Scan request);
  - `scan_topk_flow`: the device analog — one large MVCC range scan
    streamed through ScanOp into a device top-K (col_mvcc.go:391 feeding
    colexec's topKSorter, sorttopk.go:88).

`ScanTopKBatcher` runs the scan+top-K micro-queries on the device one
call per op or in pow2-padded batches; where the JAX batcher jits one
program per op and a `jax.vmap` of it per batch, the port calls
ops/sort.py `range_top_k` on scalars, or on (B,) range tensors as one
(B, window) gather and one sort along dim 1. Both give the same values
bit for bit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util.hlc import Timestamp

TABLE_ID = 100
N_FIELDS = 10
MAX_SCAN_LEN = 100
ZIPF_THETA = 0.99


class Zipf:
    """Zipfian key picker over [0, n) (Gray et al., the YCSB generator).
    Vectorized inverse-CDF sampling against a precomputed zeta table."""

    def __init__(self, n: int, theta: float = ZIPF_THETA,
                 rng: Optional[np.random.Generator] = None):
        self.n = n
        self.rng = rng or np.random.default_rng(0)
        ranks = np.arange(1, n + 1, dtype=np.float64)
        weights = 1.0 / np.power(ranks, theta)
        self.cdf = np.cumsum(weights)
        self.cdf /= self.cdf[-1]

    def draw(self, size: int) -> np.ndarray:
        u = self.rng.random(size)
        return np.searchsorted(self.cdf, u).astype(np.int64)


def fnv_scramble(keys: np.ndarray, n: int) -> np.ndarray:
    """Scrambled-zipfian: spread the hot head across the keyspace (the
    reference uses FNV-64 scrambling, ycsb.go zipfGenerator)."""
    h = keys.astype(np.uint64) * np.uint64(0x100000001B3)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(n)).astype(np.int64)


def load(store: MVCCStore, n_records: int,
         rng: Optional[np.random.Generator] = None) -> None:
    rng = rng or np.random.default_rng(1)
    fields = rng.integers(0, 1 << 40, (n_records, N_FIELDS))
    for pk in range(n_records):
        store.put(TABLE_ID, pk, [int(x) for x in fields[pk]])


def run_e(store: MVCCStore, n_ops: int, n_records: int,
          rng: Optional[np.random.Generator] = None,
          scrambled: bool = True):
    """Workload E: 95% range scans / 5% inserts. Returns (ops/sec,
    rows_scanned). Scans read through the MVCC engine's columnar scanner
    exactly like a SQL range scan."""
    rng = rng or np.random.default_rng(2)
    zipf = Zipf(n_records, rng=rng)
    starts = zipf.draw(n_ops)
    if scrambled:
        starts = fnv_scramble(starts, n_records)
    lens = rng.integers(1, MAX_SCAN_LEN + 1, n_ops)
    is_insert = rng.random(n_ops) < 0.05
    ins_fields = rng.integers(0, 1 << 40, (n_ops, N_FIELDS))
    next_pk = n_records
    rows = 0
    t0 = time.perf_counter()
    for i in range(n_ops):
        if is_insert[i]:
            store.put(TABLE_ID, next_pk,
                      [int(x) for x in ins_fields[i]])
            next_pk += 1
        else:
            res = store.engine.scan_to_cols(
                _key(int(starts[i])), _key(int(starts[i]) + int(lens[i])),
                store.clock.now(), N_FIELDS, int(lens[i]))
            rows += res.rows
    dt = time.perf_counter() - t0
    return n_ops / dt, rows


def _key(pk: int) -> bytes:
    from cockroach_tpu_torch.storage.mvcc import encode_key

    return encode_key(TABLE_ID, pk)


def schema():
    from cockroach_tpu_torch.coldata.batch import INT, Field, Schema

    return Schema([Field(f"field{i}", INT) for i in range(N_FIELDS)])


def scan_topk_flow(store: MVCCStore, capacity: int = 1 << 17,
                   k: int = 100, ts: Optional[Timestamp] = None):
    """MVCC full-range scan -> device top-K over field0 (the device path
    of config #5). Returns the flow root for exec.collect()."""
    from cockroach_tpu_torch.exec.operators import TopKOp
    from cockroach_tpu_torch.ops.sort import SortKey

    scan = store.scan_op(TABLE_ID, schema(), capacity, ts=ts)
    # the row estimate the placement pass reads: entry count ~ records
    try:
        scan.est_rows = int(store.engine.stats().get("entries", 0))
    except Exception:
        pass
    return TopKOp(scan, [SortKey("field0", descending=True)], k)


def batch_bucket(n_ops: int) -> int:
    """Pow2 padding bucket for an op batch, so B concurrent ops land on
    ~log2(max batch) shapes instead of one per exact size."""
    b = 1
    while b < n_ops:
        b *= 2
    return b


class ScanTopKBatcher:
    """Inference-style request batching for YCSB-E scan+top-K
    micro-queries (the serving-stack shape: coalesce concurrent requests
    into one device dispatch).

    The table's sort column (field0) and its sorted primary keys live on
    the device; each op is `range_top_k` (ops/sort.py) over a per-op
    [start, start+len) key range. `run_unbatched` makes one call per op
    — the B-host-dispatch baseline; `run` pads each group of ops to a
    pow2 bucket and runs it as ONE batched call. Both compute the same
    function, so their per-op results are bit-identical."""

    def __init__(self, values: np.ndarray, pks: np.ndarray, k: int = 10,
                 window: int = 128, device=None):
        from cockroach_tpu_torch import resolve_device
        from cockroach_tpu_torch.ops.sort import range_top_k

        if window < MAX_SCAN_LEN:
            raise ValueError("window must cover MAX_SCAN_LEN")
        self.k, self.window = k, window
        self.device = resolve_device(device)
        pks_np = np.asarray(pks, dtype=np.int64)
        self.values = torch.from_numpy(
            np.asarray(values, dtype=np.int64).copy()).to(self.device)
        self.pks = torch.from_numpy(pks_np.copy()).to(self.device)
        vals, keys = self.values, self.pks
        # contiguous keys (the YCSB loader's) make the range search
        # arithmetic instead of a binary search over the key column
        pk0 = (int(pks_np[0]) if len(pks_np) and np.array_equal(
            pks_np, pks_np[0] + np.arange(len(pks_np))) else None)

        def call(lo, hi):
            return range_top_k(vals, keys, lo, hi, k=k, window=window,
                               pk0=pk0)

        self._call = call
        self.ops_submitted = 0
        self.slots_dispatched = 0
        self.dispatches = 0

    @classmethod
    def from_store(cls, store: MVCCStore, capacity: int = 1 << 17,
                   k: int = 10, window: int = 128) -> "ScanTopKBatcher":
        """Snapshot field0 out of the MVCC store onto the store's device.
        YCSB primary keys are contiguous (the loader and workload E's
        inserts both append sequentially), so pk == row index over the
        scan stream."""
        chunks = [c["f0"] for c in
                  store.scan_chunks(TABLE_ID, N_FIELDS, capacity)]
        vals = (np.concatenate(chunks) if chunks
                else np.zeros(0, dtype=np.int64))
        return cls(vals, np.arange(len(vals), dtype=np.int64), k=k,
                   window=window, device=store.device)

    def occupancy(self) -> float:
        """TRUE occupancy: real ops per dispatched batch lane (1.0 =
        every lane did work). Padded lanes count as DISPATCHED, never as
        occupied — a batch that flushes below its pow2 bucket reports
        n_real/bucket, not n_real/batch_size and not 1.0."""
        return (self.ops_submitted / self.slots_dispatched
                if self.slots_dispatched else 0.0)

    def run_unbatched(self, starts, lens):
        """One device call PER op. Returns (values (n,k), counts (n,))
        as numpy arrays."""
        from cockroach_tpu_torch.exec import stats

        lo = np.asarray(starts, dtype=np.int64)
        hi = lo + np.asarray(lens, dtype=np.int64)
        out_v = np.empty((len(lo), self.k), dtype=np.int64)
        out_c = np.empty(len(lo), dtype=np.int32)
        for i in range(len(lo)):
            v, _valid, c = self._call(int(lo[i]), int(hi[i]))
            out_v[i], out_c[i] = v.cpu().numpy(), int(c)
        stats.add("ycsb.op_unbatched", rows=int(out_c.sum()),
                  events=len(lo))
        return out_v, out_c

    def run(self, starts, lens, batch_size: int = 256):
        """Coalesce ops into pow2-padded batches of up to `batch_size`:
        each batch is ONE device call. Bit-identical to run_unbatched.
        Returns (values (n,k), counts (n,))."""
        from cockroach_tpu_torch.exec import stats

        lo = np.asarray(starts, dtype=np.int64)
        hi = lo + np.asarray(lens, dtype=np.int64)
        vs, cs = [], []
        for a in range(0, len(lo), batch_size):
            blo, bhi = lo[a:a + batch_size], hi[a:a + batch_size]
            n_real = len(blo)
            bucket = batch_bucket(n_real)
            if bucket > n_real:
                # empty ops ([0, 0) matches nothing) pad to the bucket
                pad = np.zeros(bucket - n_real, dtype=np.int64)
                blo = np.concatenate([blo, pad])
                bhi = np.concatenate([bhi, pad])
            v, _valid, c = self._call(torch.from_numpy(blo),
                                      torch.from_numpy(bhi))
            vs.append(v.cpu().numpy()[:n_real])
            cs.append(c.cpu().numpy()[:n_real])
            self.ops_submitted += n_real
            # slots = the pow2 bucket ACTUALLY dispatched: a partial
            # flush counts its real padding (n_real/bucket occupancy)
            self.slots_dispatched += bucket
            self.dispatches += 1
            stats.add("ycsb.op_batch", rows=int(cs[-1].sum()), events=1)
            # lane accounting for consumers reconstructing occupancy
            # from the stats channel: events = real ops, rows =
            # dispatched lanes
            stats.add("ycsb.batch_lanes", rows=bucket, events=n_real)
        if not vs:
            return (np.empty((0, self.k), dtype=np.int64),
                    np.empty(0, dtype=np.int32))
        return np.concatenate(vs), np.concatenate(cs)
