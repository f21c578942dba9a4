"""KV layer: serializable transactions over the MVCC store.

Counterpart of cockroach_tpu/kv/, for `DB`, `Txn` and `TxnRetryError`
(kv/txn.py) and the batched point lookups of kv/streamer.py. The JAX
package's `kv/__init__.py` also reaches the replication stack lazily
(`RaftNode`, `Cluster`, `DistSender`); those wait for ROADMAP.md queue
1, item 8e.

Reference: pkg/kv (DB/Txn, txn.go:73).
"""

from cockroach_tpu_torch.kv.txn import DB, Txn, TxnRetryError

__all__ = ["DB", "Txn", "TxnRetryError"]
