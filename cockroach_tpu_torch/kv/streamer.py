"""kvstreamer-lite: batched, budget-bounded, out-of-order point lookups.

Counterpart of cockroach_tpu/kv/streamer.py, host only (no device
work), with the port's storage/mvcc.py under it.

Reference: pkg/kv/kvclient/kvstreamer/streamer.go:218 — the Streamer
turns a lookup join's stream of point gets into large, budget-bounded,
out-of-order batches so the KV layer amortizes per-request costs. Here
the amortization lever is the COLUMNAR SCANNER: sorted rowids coalesce
into dense spans (gaps below `gap_limit` ride along and are discarded),
each span becomes one engine scan_to_cols call — the C++ scanner decodes
~5M rows/s while per-row MVCCStore.get pays Python + ctypes per key.
Spans are processed in any order (out-of-order delivery) and each scan
request is bounded by `budget_bytes` of result rows, resuming like the
DistSender's resume spans.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from cockroach_tpu_torch.storage.mvcc import MVCCStore, encode_key


class Streamer:
    def __init__(self, store: MVCCStore, budget_bytes: int = 4 << 20,
                 gap_limit: int = 256):
        self.store = store
        self.budget_bytes = budget_bytes
        self.gap_limit = gap_limit

    def _spans(self, rowids: np.ndarray) -> List[Tuple[int, int]]:
        """Coalesce sorted unique rowids into [lo, hi] spans whose
        internal gaps are below gap_limit (scanning a small gap is far
        cheaper than splitting the request)."""
        spans: List[Tuple[int, int]] = []
        lo = prev = int(rowids[0])
        for r in rowids[1:]:
            r = int(r)
            if r - prev > self.gap_limit:
                spans.append((lo, prev))
                lo = r
            prev = r
        spans.append((lo, prev))
        return spans

    def multi_get_cols(self, table_id: int, rowids: Sequence[int],
                       ncols: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (pks ascending, cols (ncols, n)) for every requested rowid
        that exists. One columnar scan per coalesced span,
        budget-bounded with resume (out-of-order across spans); result
        assembly is fully vectorized (no per-row Python)."""
        ids = np.unique(np.asarray(rowids, dtype=np.int64))
        if ids.size == 0:
            return (np.zeros(0, np.int64),
                    np.zeros((ncols, 0), np.int64))
        row_bytes = 8 * (ncols + 1)
        max_rows = max(self.budget_bytes // row_bytes, 64)
        ts = self.store.clock.now()
        eng = self.store.engine
        pk_parts: List[np.ndarray] = []
        col_parts: List[np.ndarray] = []
        for lo, hi in self._spans(ids):
            start = encode_key(table_id, lo)
            end = encode_key(table_id, hi + 1)
            while True:
                res = eng.scan_to_cols(start, end, ts, ncols, max_rows,
                                       with_pks=True)
                if res.rows == 0:
                    break
                pks = res.pks
                keep = np.isin(pks, ids)
                pk_parts.append(pks[keep])
                col_parts.append(
                    np.ascontiguousarray(res.cols[:, :res.rows][:, keep]))
                if not res.more:
                    break
                start = res.resume_key
        if not pk_parts:
            return (np.zeros(0, np.int64),
                    np.zeros((ncols, 0), np.int64))
        return (np.concatenate(pk_parts),
                np.concatenate(col_parts, axis=1))

    def multi_get(self, table_id: int, rowids: Sequence[int],
                  ncols: int) -> Dict[int, np.ndarray]:
        """Dict convenience wrapper over multi_get_cols."""
        pks, cols = self.multi_get_cols(table_id, rowids, ncols)
        return {int(pk): cols[:, i] for i, pk in enumerate(pks)}
