"""KV client: transactions over the MVCC store (M4 slice).

Counterpart of cockroach_tpu/kv/txn.py, host only (no device work),
with the port's storage/mvcc.py under it.

Reference: pkg/kv/txn.go:73 (kv.Txn), kvclient/kvcoord/txn_coord_sender.go
(interceptor stack), pkg/kv/kvserver/concurrency (lock table). The
reference is pessimistic (write intents + lock table + pushed txns); this
single-node slice implements serializable transactions with write
buffering + commit-time validation — the same outcome surface (reads at a
snapshot, write-write and read-write conflicts abort with a retryable
error, atomic multi-key commits) with the machinery a single process
needs. The interceptor-stack seams (pipeliner, refresher, parallel
committer) and the distributed lock table arrive with replication (M7).

Why validation instead of intents here: intents exist so OTHER NODES can
discover conflicts; in a single-node store a commit-time check under the
store mutex is equivalent and keeps the C++ engine value format free of
provisional state. kvnemesis-style randomized serializability checking
(pkg/kv/kvnemesis/validator.go:49) backs the claim in tests.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from cockroach_tpu_torch.storage.mvcc import MVCCStore, encode_key
from cockroach_tpu_torch.util.hlc import Timestamp


class TxnRetryError(Exception):
    """Serializability conflict: the transaction must retry (the analog of
    kvpb.TransactionRetryError; kv.Txn.exec retries these)."""


class DB:
    """Transaction coordinator over one MVCCStore (kv.DB analog)."""

    def __init__(self, store: Optional[MVCCStore] = None):
        self.store = store or MVCCStore()
        # single-node commit mutex: the concurrency-manager seam
        # (kvserver/concurrency); a real lock table replaces this in M7
        self._commit_mu = threading.Lock()

    def txn(self) -> "Txn":
        return Txn(self)

    def run(self, fn, max_retries: int = 16):
        """Run `fn(txn)` with automatic retry on serializability conflicts
        (kv.DB.Txn's retry loop; ErrAutoRetryLimitExhausted analog)."""
        for _ in range(max_retries):
            txn = self.txn()
            try:
                out = fn(txn)
                txn.commit()
                return out
            except TxnRetryError:
                continue
        raise TxnRetryError("retry limit exhausted")


class Txn:
    """A serializable transaction: snapshot reads at start_ts, buffered
    writes, commit-time validation of both sets."""

    def __init__(self, db: DB):
        self.db = db
        # serialize start against in-flight commits: a txn starting while
        # a commit applies its writes would otherwise observe a partial
        # write set (the single-node stand-in for intent visibility rules)
        with db._commit_mu:
            self.start_ts = db.store.clock.now()
        self.commit_ts: Optional[Timestamp] = None
        self._writes: Dict[Tuple[int, int], Optional[List[int]]] = {}
        self._reads: Dict[Tuple[int, int], Optional[Timestamp]] = {}
        self._scans: List[Tuple[int, int, Optional[int]]] = []
        self._done = False

    # -- operations --------------------------------------------------------

    def get(self, table_id: int, pk: int) -> Optional[List[int]]:
        assert not self._done
        key = (table_id, pk)
        if key in self._writes:       # read-your-writes
            return self._writes[key]
        hit = self.db.store.get(table_id, pk, ts=self.start_ts)
        self._reads[key] = hit[1] if hit else None
        return hit[0] if hit else None

    def put(self, table_id: int, pk: int, fields: Sequence[int]) -> None:
        assert not self._done
        self._writes[(table_id, pk)] = list(fields)

    def delete(self, table_id: int, pk: int) -> None:
        assert not self._done
        self._writes[(table_id, pk)] = None

    def buffered_pks(self, table_id: int) -> List[int]:
        """Primary keys this txn has buffered writes for (inserts visible
        to the txn's own statements; deletes excluded)."""
        return [pk for (t, pk), v in self._writes.items()
                if t == table_id and v is not None]

    def scan_pks(self, table_id: int, start_pk: int = 0,
                 end_pk: Optional[int] = None) -> List[int]:
        """Visible primary keys at the snapshot (tracked for phantom
        protection: the commit validates the whole scanned range)."""
        assert not self._done
        from cockroach_tpu_torch.storage.mvcc import decode_key

        end = (encode_key(table_id + 1, 0) if end_pk is None
               else encode_key(table_id, end_pk))
        keys = self.db.store.engine.scan_keys(
            encode_key(table_id, start_pk), end, self.start_ts)
        pks = [decode_key(k)[1] for k in keys]
        # membership is validated at commit (phantom protection); values
        # are validated per-key only if get() actually read them
        self._scans.append((table_id, start_pk, end_pk, tuple(pks)))
        return pks

    # -- commit ------------------------------------------------------------

    def _validate(self) -> None:
        """Serializability check at commit: every read must still return
        the version it saw, and no key in a scanned range (or the write
        set) may have a newer version than start_ts — the span-refresher's
        job (txn_interceptor_span_refresher.go), done eagerly."""
        store = self.db.store
        for (t, pk), seen_ts in self._reads.items():
            hit = store.get(t, pk, ts=Timestamp.MAX)
            now_ts = hit[1] if hit else None
            if now_ts != seen_ts:
                raise TxnRetryError(f"read key {(t, pk)} changed")
        for (t, s_pk, e_pk, seen_pks) in self._scans:
            from cockroach_tpu_torch.storage.mvcc import decode_key

            end = (encode_key(t + 1, 0) if e_pk is None
                   else encode_key(t, e_pk))
            now = tuple(decode_key(k)[1] for k in store.engine.scan_keys(
                encode_key(t, s_pk), end, Timestamp.MAX))
            if now != seen_pks:
                raise TxnRetryError("scanned range changed (phantom)")
        for (t, pk) in self._writes:
            hit = store.get(t, pk, ts=Timestamp.MAX)
            if hit and hit[1] > self.start_ts:
                raise TxnRetryError(f"write-write conflict on {(t, pk)}")

    def commit(self) -> Timestamp:
        assert not self._done
        self._done = True
        if not self._writes:
            self.commit_ts = self.start_ts
            return self.commit_ts
        # the store's write window: a changefeed or view horizon taken
        # meanwhile waits until every version below is written
        with self.db._commit_mu, self.db.store.write_window():
            self._validate()
            ts = self.db.store.clock.now()
            for (t, pk), fields in self._writes.items():
                if fields is None:
                    self.db.store.delete(t, pk, ts=ts)
                else:
                    self.db.store.put(t, pk, fields, ts=ts)
            self.commit_ts = ts
            return ts

    def rollback(self) -> None:
        self._done = True
        self._writes.clear()
