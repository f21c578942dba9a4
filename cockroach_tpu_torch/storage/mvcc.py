"""MVCC store API + the columnar scan seam into the execution engine.

Counterpart of cockroach_tpu/storage/mvcc.py. Reference:
pkg/storage/mvcc.go (MVCCPut :1919, MVCCGet :1397, MVCCScan :5030,
MVCCDelete), pkg/storage/col_mvcc.go:391 (MVCCScanToCols: the columnar
scanner running inside the KV server) and the mvcc_history datadriven
test harness (pkg/storage/mvcc_history_test.go).

`MVCCStore` wraps an engine (C++ native or Python model) with:
  - typed tables: a table maps a uint64 primary key to N int64 fields
    (the fixed-width row codec the native scanner decodes column-major;
    richer types ride the same int64 lanes exactly like the device Batch:
    decimals scaled, dates as days, strings as dictionary codes);
  - HLC-timestamped puts/gets/deletes and snapshot scans;
  - `scan_op(...)`: an exec.ScanOp streaming packed chunks STRAIGHT from
    the native scanner — MVCC range scan -> columnar chunk -> one
    host->device transfer, the north star's scan path.

`MVCCStore(device=...)` names the device of the resident tier
(storage/resident.py): the host-only operations never touch it, and a
table that attaches resolves it with `resolve_device`, so the tier runs
on CUDA unless the caller passes device="cpu". The resident read is a
`scan.resident` trace span (and stats timer) and a fallback to the host
walk a `scan.resident_fallback` record (and stats event), as in the JAX
package.

The datadriven runner (`run_datadriven`) executes the mvcc_history-style
command corpus in tests/testdata/mvcc/.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cockroach_tpu_torch.storage.engine import open_engine
from cockroach_tpu_torch.util.hlc import HLC, Timestamp


def encode_key(table_id: int, pk: int) -> bytes:
    """/Table/<id>/<pk> — big-endian so byte order == numeric order
    (reference keyspace layout, pkg/keys/doc.go:16)."""
    return struct.pack(">HQ", table_id, pk)


def decode_key(key: bytes) -> tuple:
    t, pk = struct.unpack(">HQ", key)
    return t, pk


def encode_row(fields: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(fields)}q", *fields)


def decode_row(val: bytes) -> List[int]:
    n = len(val) // 8
    return list(struct.unpack(f"<{n}q", val[:n * 8]))


class MVCCStore:
    """Single-node MVCC store over a storage engine + an HLC clock."""

    def __init__(self, engine=None, clock: Optional[HLC] = None,
                 device=None):
        self.engine = engine if engine is not None else open_engine()
        self.clock = clock or HLC()
        # the resident tier's device (None: CUDA, resolved on attach)
        self.device = device
        # held by a write from taking its timestamp until its versions
        # are in the engine (`write_window`)
        self._write_mu = threading.RLock()

    def write_window(self):
        """The lock a write holds from taking its timestamp until its
        versions are in the engine: `put`, `delete`, `ingest_table` and
        kv/txn.py's commit, which writes every version of a transaction
        at one timestamp. A reader that takes the clock under it (the
        changefeed's and a materialized view's horizon) knows that every
        version at or below its reading is already in the engine and
        that every later write takes a larger timestamp. The JAX store
        has no such lock, so a poll that runs while a transaction applies
        its versions can close its window over versions not yet written
        and never see them; the port departs from it here."""
        return self._write_mu

    # -- scan-image cache seam --------------------------------------------

    def table_version(self, table_id: int) -> int:
        """Per-table write version (engine counter); part of the content
        identity the cross-query scan-image cache keys on."""
        getter = getattr(self.engine, "table_version", None)
        return int(getter(table_id)) if getter is not None else 0

    def scan_cache_prefix(self, table_id: int) -> tuple:
        """Key prefix identifying this table in the process-wide
        ScanImageCache — shared by key construction (sql/plan.py
        MVCCCatalog) and write-path invalidation below."""
        return ("mvcc", id(self.engine), int(table_id))

    def _invalidate_scan_cache(self, table_id: int) -> None:
        """Writes rotate the version (so future keys differ) AND eagerly
        drop the now-stale device images — a rotated key would otherwise
        hold HBM until LRU pressure. The resident-pin entry is spared:
        the device-resident version arrays (storage/resident.py) absorb
        writes through the delta path, never through invalidation —
        evicting their budget pin here would detach the table on every
        write, which is exactly the restacking this layer removes."""
        from cockroach_tpu_torch.exec.scan_cache import scan_image_cache

        scan_image_cache().invalidate(self.scan_cache_prefix(table_id),
                                      keep_tag="resident-pin")

    def make_resident(self, table_id: int, ncols: int) -> bool:
        """Pin this table's version arrays on device now (idempotent);
        False when the table cannot go resident (over budget, pk/ts
        outside the packable range) — scans then stay on the host tier."""
        from cockroach_tpu_torch.storage import resident as _resident

        return _resident.attach(self, table_id, ncols) is not None

    # -- row ops -----------------------------------------------------------

    def put(self, table_id: int, pk: int, fields: Sequence[int],
            ts: Optional[Timestamp] = None) -> Timestamp:
        with self._write_mu:
            ts = ts or self.clock.now()
            self.engine.put(encode_key(table_id, pk), ts,
                            encode_row(fields))
        from cockroach_tpu_torch.storage import resident as _resident

        _resident.on_put(self, table_id, pk, ts, fields)
        self._invalidate_scan_cache(table_id)
        return ts

    def delete(self, table_id: int, pk: int,
               ts: Optional[Timestamp] = None) -> Timestamp:
        with self._write_mu:
            ts = ts or self.clock.now()
            self.engine.delete(encode_key(table_id, pk), ts)
        from cockroach_tpu_torch.storage import resident as _resident

        _resident.on_delete(self, table_id, pk, ts)
        self._invalidate_scan_cache(table_id)
        return ts

    def get(self, table_id: int, pk: int,
            ts: Optional[Timestamp] = None):
        ts = ts or self.clock.now()
        hit = self.engine.get(encode_key(table_id, pk), ts)
        if hit is None:
            return None
        val, vts = hit
        return decode_row(val), vts

    def sync(self) -> None:
        """Durability barrier: fsync the engine WAL, so every write above
        survives kill -9. The commit-acknowledgment point for durable
        engines (no-op on ephemeral ones)."""
        self.engine.sync()

    def fingerprint(self, table_id: Optional[int] = None,
                    ts: Optional[Timestamp] = None) -> int:
        """CRC32C over every MVCC version with version-ts <= `ts` (None =
        all), newest-first per key, tombstones included, of one table —
        or the whole keyspace when table_id is None. Two stores agree on
        a fingerprint iff they hold bit-identical visible history: the
        post-crash-recovery verification primitive (the reference's
        storage-level consistency-checker fingerprint role)."""
        from cockroach_tpu_torch.storage.engine import engine_fingerprint

        if table_id is None:
            start, end = b"", b""
        else:
            start = encode_key(table_id, 0)
            end = encode_key(table_id + 1, 0)
        return engine_fingerprint(self.engine, ts=ts, start=start, end=end)

    def ingest_table(self, table_id: int, pks, cols: Dict[str, np.ndarray],
                     ts: Optional[Timestamp] = None) -> Timestamp:
        """Bulk-load a whole table (column arrays in schema order) as one
        sorted engine run — the AddSSTable ingest path
        (batcheval/cmd_add_sstable.go), used by workload loads and
        RESTORE. ~100x faster than per-row put()."""
        pks = np.asarray(pks, dtype=np.int64)
        col_list = list(cols.values())
        with self._write_mu:
            ts = ts or self.clock.now()
            self.engine.ingest(table_id, pks, col_list, ts)
        from cockroach_tpu_torch.storage import resident as _resident

        _resident.on_ingest(self, table_id, pks, col_list, ts)
        self._invalidate_scan_cache(table_id)
        return ts

    # -- scan path ---------------------------------------------------------

    def scan_chunks(self, table_id: int, ncols: int, capacity: int,
                    ts: Optional[Timestamp] = None,
                    start_pk: int = 0,
                    end_pk: Optional[int] = None,
                    col_names: Optional[Sequence[str]] = None,
                    ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream the newest-visible rows of a table as column chunks of
        up to `capacity` rows — the feed for exec.ScanOp.

        Degradation ladder: when the table is device-resident
        (storage/resident.py, auto-attached under storage.resident_scan)
        visibility resolves on the device and the host walk below
        is the backstop tier. It serves the read, with a
        `scan.resident_fallback` stat, when the table cannot serve
        (ResidentUnavailable: budget eviction, a refused pin, timestamp
        pack overflow, a pk on the sentinel, a detached table; the table
        detaches), when device memory runs out, and when a transient
        fault outlasts the retry seam. Any other error (a failed launch,
        an illegal address: util/retry.py's TERMINAL) propagates; the
        JAX store falls back on every error."""
        ts = ts or self.clock.now()
        names = list(col_names) if col_names else [
            f"f{i}" for i in range(ncols)]
        image = self.resident_columns(table_id, ncols, ts, start_pk, end_pk)
        if image is not None:
            pks, vals = image
            for off in range(0, int(pks.shape[0]), capacity):
                chunk = vals[:, off:off + capacity]
                yield {names[i]: chunk[i] for i in range(ncols)}
            return
        start = encode_key(table_id, start_pk)
        end = (encode_key(table_id + 1, 0) if end_pk is None
               else encode_key(table_id, end_pk))
        while True:
            res = self.engine.scan_to_cols(start, end, ts, ncols, capacity)
            if res.rows:
                yield {names[i]: res.cols[i] for i in range(ncols)}
            if not res.more:
                return
            start = res.resume_key

    def resident_columns(self, table_id: int, ncols: int, ts,
                         start_pk: int = 0, end_pk: Optional[int] = None):
        """The resident tier's (pks, vals (ncols, k)) on the host for the
        rows visible at `ts` in [start_pk, end_pk), materialized whole
        under the retry seam (so a failure falls back cleanly, never
        mid-stream), or None when the host walk serves the read: the
        table is not resident, cannot serve (ResidentUnavailable: it
        detaches), or failed with an error util/retry.py does not call
        TERMINAL (device memory, a transient fault past the retries); a
        TERMINAL error propagates. scan_chunks' tier and sql/session.py
        SessionCatalog's. `ts` may be a callable (a clock's `now`): it is
        then read once per attempt and only when the resident tier
        serves, so a host-walk read takes the same clock readings as the
        JAX catalog's."""
        from cockroach_tpu_torch.exec import stats
        from cockroach_tpu_torch.storage import resident as _resident
        from cockroach_tpu_torch.util import retry
        from cockroach_tpu_torch.util import tracing as _tracing
        from cockroach_tpu_torch.util.fault import maybe_fail

        rt = _resident.maybe_attach(self, table_id, ncols)
        if rt is None:
            return None

        def materialize():
            maybe_fail("scan.resident")
            return rt.scan_columns(ts() if callable(ts) else ts, start_pk,
                                   end_pk)

        try:
            with _tracing.child_span("scan.resident", table=table_id), \
                    stats.timed("scan.resident"):
                pks, vals = retry.with_retry(materialize,
                                             name="scan.resident")
        except _resident.ResidentUnavailable as e:
            stats.add("scan.resident_fallback")
            _tracing.record("scan.resident_fallback",
                            error=type(e).__name__)
            _resident.detach(self, table_id)
            return None
        except Exception as e:  # noqa: BLE001 — the classifier decides
            if retry.classify(e) == retry.TERMINAL:
                raise
            stats.add("scan.resident_fallback")
            _tracing.record("scan.resident_fallback",
                            error=type(e).__name__)
            return None
        stats.add("scan.resident_rows", rows=int(pks.shape[0]))
        return pks, vals

    def scan_op(self, table_id: int, schema, capacity: int,
                ts: Optional[Timestamp] = None, resident: bool = False):
        """exec.ScanOp over this table: MVCC scan -> packed chunk ->
        device. `schema` is a coldata Schema whose fields (all riding
        int64 lanes host-side) name the table's columns in order."""
        from cockroach_tpu_torch.exec.operators import ScanOp

        names = [f.name for f in schema]
        ts = ts or self.clock.now()

        def chunks():
            return self.scan_chunks(table_id, len(names), capacity, ts=ts,
                                    col_names=names)

        # content-identity key: the version pins the snapshot this op's
        # fixed ts observes (any later write bumps it, so a new scan_op
        # over changed data can never borrow this image). When the table
        # is device-resident the key carries the (generation, version,
        # timestamp bucket) triple instead: reads at-or-after the newest
        # version (pending deltas included) share one bucket, so warm
        # re-reads after a write burst share one rematerialized image,
        # and the "resident" tag exempts it from write-path invalidation.
        from cockroach_tpu_torch.storage import resident as _resident

        rt = _resident.lookup(self, table_id)
        if rt is not None:
            base, bucket = rt.read_bucket(ts)
            key = self.scan_cache_prefix(table_id) + (
                "resident", rt.generation, base,
                self.table_version(table_id), bucket, int(capacity),
                tuple(names))
        else:
            key = self.scan_cache_prefix(table_id) + (
                self.table_version(table_id), int(capacity), tuple(names))
        op = ScanOp(schema, chunks, capacity, resident=resident,
                    cache_key=key)
        # distributed ingest (parallel/ingest.py) shards the resident
        # visibility image per pk range when it can reach the store: the
        # handle pins the same read timestamp the chunk stream observes
        op._mvcc_src = (self, table_id, ts, tuple(range(len(names))))
        return op


# ---------------------------------------------------------------- datadriven

def run_datadriven(text: str, store: Optional[MVCCStore] = None) -> str:
    """Execute an mvcc_history-style script; returns the output transcript.

    Commands (one per line; `# comment` and blank lines skipped):
        put   k=<int> ts=<wall>[,<logical>] v=<int>,<int>,...
        del   k=<int> ts=<wall>
        get   k=<int> ts=<wall>
        scan  ts=<wall> [start=<int>] [end=<int>] [max=<int>] [ncols=<int>]
        flush
        stats

    The output of each reading command is appended to the transcript in a
    stable text form, mirroring how the reference's datadriven corpus pins
    MVCC semantics (storage/mvcc_history_test.go + testdata goldens).
    """
    store = store or MVCCStore()
    out: List[str] = []
    table = 1

    def parse_ts(arg: str) -> Timestamp:
        if "," in arg:
            w, l = arg.split(",")
            return Timestamp(int(w), int(l))
        return Timestamp(int(arg), 0)

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cmd, args = parts[0], dict(p.split("=", 1) for p in parts[1:])
        if cmd == "put":
            ts = parse_ts(args["ts"])
            fields = [int(x) for x in args["v"].split(",")]
            store.put(table, int(args["k"]), fields, ts=ts)
            out.append(f"put k={args['k']} @{ts}")
        elif cmd == "del":
            ts = parse_ts(args["ts"])
            store.delete(table, int(args["k"]), ts=ts)
            out.append(f"del k={args['k']} @{ts}")
        elif cmd == "get":
            ts = parse_ts(args["ts"])
            hit = store.get(table, int(args["k"]), ts=ts)
            if hit is None:
                out.append(f"get k={args['k']} -> <no version>")
            else:
                fields, vts = hit
                out.append(
                    f"get k={args['k']} -> "
                    f"{','.join(map(str, fields))} @{vts}")
        elif cmd == "scan":
            ts = parse_ts(args["ts"])
            ncols = int(args.get("ncols", "2"))
            start = int(args.get("start", "0"))
            end = int(args["end"]) if "end" in args else None
            limit = int(args["max"]) if "max" in args else None
            rows: List[str] = []
            end_key = (encode_key(table, end) if end is not None
                       else encode_key(table + 1, 0))
            pks = store.engine.scan_keys(
                encode_key(table, start), end_key, ts,
                max_rows=limit if limit is not None else 1 << 62)
            chunks = store.scan_chunks(table, ncols, 1 << 16, ts=ts,
                                       start_pk=start, end_pk=end)
            i = 0
            done = False
            for c in chunks:
                n = len(next(iter(c.values())))
                for r in range(n):
                    if limit is not None and i + r >= limit:
                        done = True
                        break
                    pk = decode_key(pks[i + r])[1]
                    vals = ",".join(str(c[f"f{j}"][r]) for j in range(ncols))
                    rows.append(f"  {pk} -> {vals}")
                i = min(i + n, limit) if limit is not None else i + n
                if done:
                    break
            out.append(f"scan @{ts}: {i} rows")
            out.extend(rows)
        elif cmd == "flush":
            store.engine.flush()
            out.append("flush")
        elif cmd == "stats":
            # entries only: run/memtable layout is an engine detail and the
            # transcript is differential-compared across engines
            out.append(f"stats entries={store.engine.stats()['entries']}")
        else:
            raise ValueError(f"unknown datadriven command {cmd!r}")
    return "\n".join(out)
