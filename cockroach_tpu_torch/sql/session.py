"""Session: statement dispatch (DDL, DML, transactions, SET/SHOW,
SELECT/EXPLAIN) over a catalog, read-only or storage-backed.

Counterpart of cockroach_tpu/sql/session.py: `Session`, `SQLError`,
`map_execution_error`, `TableDescriptor`, `SessionCatalog`,
`_TxnReadCatalog` and `DESC_TABLE`. Reference: sql/conn_executor.go
(execCmd dispatching statement kinds), sql/catalog/descs (descriptors
persisted in a system table), the row writers (sql/row) and session
vars (sql/vars.go).

Storage mapping (the JAX package's, byte for byte): a table descriptor
(id, columns, types, growing string dictionaries, next rowid, row count,
secondary indexes, column states) is a JSON value in the descriptor
keyspace 0xFFE0; rows are fixed-width int64 tuples keyed by an int64
primary key (an INT PRIMARY KEY column, else a hidden rowid), with a
trailing NULL bitmap slot. Mutations run through kv/txn.py (serializable,
validated at commit); CREATE INDEX and ALTER TABLE backfill as
server/jobs.py jobs, checkpointed by primary key.

Over any other catalog (the TPC-H one) DDL and DML raise the JAX
package's read-only message. SELECT and EXPLAIN [ANALYZE] run through
sql/explain.py `execute_with_plan` on the session's `device` (CUDA
unless the caller passes one); each statement records into sqlstats,
and an engine error is mapped to its SQLSTATE.

The statement lifecycle (`execute`, as in the JAX session): every
statement registers in the process-wide query registry
(server/registry.py), whose entry is its CancelContext, armed with the
effective `statement_timeout` (the session variable, else the cluster
setting `sql.defaults.statement_timeout`); a work statement then takes a
session admission slot (util/admission.py; the control heads SET, SHOW,
CANCEL and the transaction statements are exempt; a shed is 53300); a
cancel or a deadline anywhere surfaces as 57014 with the session
reusable; the statement runs under a `session.execute` root span when
`sql.trace.enabled` is on; the slow-query log and the execution
insights (sql/insights.py) observe it. `cancel_query` cancels the
in-flight statement from another thread; SHOW QUERIES | SESSIONS | JOBS
read sql/vtable.py's providers; CANCEL QUERY <id> reaches the local
registry (42704 on a miss).

A session's scans are resident (sql/plan_compile.py compile_plan): a
table's image, once made, stays in the scan-image cache. A SELECT's
built operator tree is kept in a prepared cache keyed on the exact text
and validated on every hit against each scanned table's
`scan_cache_key`, which a write rotates; a hit counts `sql.prepared_hit`
and collects the kept tree, which on CUDA is one replay of its CUDA
graph. DDL, ANALYZE and SET clear the cache; the sessions of one
SessionCatalog share it (`shared_prepared`). An IndexScan's ScanOp has
no cache key, so its plan is not kept, as in the JAX package. Inside an
open transaction a SELECT reads through `_TxnReadCatalog` and skips the
cache. The port also keeps prepared entries over the TPC-H catalog,
whose key is a pure function of the generator's scale factor and seed.

Departures from the JAX module:
  - `SessionCatalog.table_chunks`'s host walk takes each chunk's primary
    keys from the scanner (`scan_to_cols(with_pks=True)`) where the JAX
    walk lists the keys first (`scan_keys`) and unpacks each in Python;
    `index_chunks` reorders one `Streamer.multi_get_cols` per chunk where
    the JAX one builds a dict of rows; the chunks are the same;
  - the resident tier serves a session table under the port's narrower
    fallback rule (storage/mvcc.py `MVCCStore.resident_columns`, which
    `scan_chunks` shares): the host walk takes
    the read when the table cannot serve (ResidentUnavailable; the
    table detaches), when device memory runs out, and when a transient
    fault outlasts the retries; any other error propagates, where the
    JAX catalog falls back on every error.

Materialized views (sql/matview.py; CREATE, DROP, REFRESH and SELECT *
FROM <view>) keep their group state on the session's device;
changefeeds (sql/changefeed.py; CREATE CHANGEFEED as a job on the
catalog's jobs registry, EXPERIMENTAL CHANGEFEED as a "stream" of
envelope lines) and PAUSE/RESUME/CANCEL JOB are host work, as in the
JAX session.

The serving seams (sql/serving.py): a prepared SELECT in one of the
serving queue's batch classes carries a BatchSpec; its warm hit skips
per-statement admission, registers in the `serving-batched` phase and
is served by a batched dispatch shared with other sessions
(`maybe_submit`), on the session's device; a batch that declines runs
the statement serially. `execute_spec` is pgwire's EXECUTE fast path (a
bound statement matched at Bind). `serving_image_key` and
`resident_serving` key and build the scan class's runner over a
device-resident table, whose key survives writes; a prepared entry whose
plan went stale over such a table comes back serving-only
(`_serving_still_warm`).

Not ported yet (each raises a BindError naming its ROADMAP.md queue 1
item, or the JAX package's message):
  - 8e's `route_cancel`: CANCEL QUERY of an id another node owns;
  - 8e, the plan vault (`_invalidate_vault`) and the pre-warm job
    (`_prepared_store`'s compile-at-prepare note).
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import json
import struct
import threading
import time
from collections import OrderedDict
from decimal import ROUND_HALF_UP, Decimal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cockroach_tpu_torch.coldata.batch import (
    BOOL, ColType, DATE, DECIMAL, FLOAT, Field, INT, Kind, STRING, Schema,
    VECTOR,
)
from cockroach_tpu_torch.kv.txn import DB, TxnRetryError
from cockroach_tpu_torch.sql import parser as P
from cockroach_tpu_torch.sql.bind import BindError
from cockroach_tpu_torch.sql.plan import Catalog
from cockroach_tpu_torch.storage.mvcc import MVCCStore, encode_key
from cockroach_tpu_torch.util import admission as _admission
from cockroach_tpu_torch.util.hlc import Timestamp
from cockroach_tpu_torch.util.settings import Settings

DESC_TABLE = 0xFFE0  # descriptor system keyspace (system.descriptor)

SLOW_QUERY_LATENCY = Settings.register(
    "sql.log.slow_query_latency",
    0.0,
    "statements slower than this (seconds) log a structured SQL_EXEC "
    "slow_query event; 0 disables",
)

SLOW_QUERY_INTERVAL = Settings.register(
    "sql.log.slow_query_interval",
    0.0,
    "minimum seconds between slow_query events for the same statement "
    "fingerprint (rate limit, so high-rate batched workloads can't "
    "flood SQL_EXEC); 0 logs every occurrence",
)

STATEMENT_TIMEOUT = Settings.register(
    "sql.defaults.statement_timeout",
    0.0,
    "default per-statement execution deadline in seconds (overridable "
    "per session via SET statement_timeout); a statement exceeding it "
    "aborts with SQLSTATE 57014 query_canceled; 0 disables",
)

# slow-query rate-limit state: fingerprint -> last log time (monotonic).
# Process-wide, like the log channel it protects.
_slow_log_mu = threading.Lock()
_slow_log_last: Dict[str, float] = {}
_session_ids = itertools.count(1)


class SQLError(Exception):
    """An execution error carrying a PostgreSQL SQLSTATE code, so a
    client can branch on the class (40001 -> client retry loop, 53xxx ->
    resource alarm) instead of string-matching Python tracebacks."""

    def __init__(self, pgcode: str, msg: str):
        super().__init__(msg)
        self.pgcode = pgcode


def map_execution_error(e: BaseException) -> Optional[SQLError]:
    """Translate engine-internal failures to SQL errors: a cancelled
    statement (a cancel from another thread, CANCEL QUERY,
    statement_timeout) becomes 57014 query_canceled, with the session
    left usable; memory-budget trips become 53200 out_of_memory; an
    exhausted restart budget becomes 40001 serialization_failure (the
    statement is safe for the client to retry). Anything else keeps its
    Python identity (BindError et al. are already user-facing). The
    port's retry loop re-raises its last error where the JAX package's
    raises RetriesExhausted."""
    from cockroach_tpu_torch.exec.operators import FlowRestart
    from cockroach_tpu_torch.util.cancel import QueryCancelled
    from cockroach_tpu_torch.util.mon import BudgetExceededError

    if isinstance(e, QueryCancelled):
        return SQLError("57014", f"query canceled: {e}")
    if isinstance(e, BudgetExceededError):
        return SQLError("53200", f"out of memory: {e}")
    if isinstance(e, FlowRestart):
        return SQLError(
            "40001",
            f"restart statement: flow restart budget exhausted ({e})")
    return None


# ---------------------------------------------------------- descriptors --

def _type_of(name: str) -> ColType:
    if name.startswith("decimal("):
        return DECIMAL(int(name[8:-1]))
    if name.startswith("vector("):
        return VECTOR(int(name[7:-1]))
    return {"int": INT, "float": FLOAT, "date": DATE,
            "string": STRING, "bool": BOOL}[name]


def _type_name(ty: ColType) -> str:
    if ty.kind is Kind.DECIMAL:
        return f"decimal({ty.scale})"
    if ty.kind is Kind.VECTOR:
        return f"vector({ty.dim})"
    return {Kind.INT: "int", Kind.FLOAT: "float", Kind.DATE: "date",
            Kind.STRING: "string", Kind.BOOL: "bool"}[ty.kind]


def _slots_of(tname: str) -> int:
    """Physical int64 slots a value column occupies in the row codec:
    VECTOR(d) packs d float32 bit patterns into d slots (the low 32 bits
    of each slot carry one lane)."""
    return int(tname[7:-1]) if tname.startswith("vector(") else 1


def _slots_to_f32(rows: np.ndarray) -> np.ndarray:
    """(n, d) int64 slot matrix -> (n, d) float32 (low-32-bit bitcast)."""
    return np.ascontiguousarray(rows.astype(np.uint32)).view(np.float32)


def _parse_vector_literal(text: str) -> Tuple[float, ...]:
    """'[1.0, 2.0, ...]' (pgvector text format) -> float tuple; the JAX
    package's ops/vector.py `parse_vector_literal`. Raises ValueError on
    malformed input."""
    s = text.strip()
    if not (s.startswith("[") and s.endswith("]")):
        raise ValueError(f"malformed vector literal {text!r}")
    body = s[1:-1].strip()
    if not body:
        raise ValueError("empty vector literal")
    return tuple(float(p) for p in body.split(","))


class TableDescriptor:
    def __init__(self, table_id: int, name: str,
                 columns: List[Tuple[str, str]], pk: Optional[str],
                 dicts: Optional[Dict[str, List[str]]] = None,
                 next_rowid: int = 1, row_count: int = 0,
                 indexes: Optional[Dict[str, int]] = None,
                 notnull: Optional[List[str]] = None,
                 dropped: Optional[List[str]] = None,
                 backfilling: Optional[str] = None):
        self.table_id = table_id
        self.name = name
        # secondary indexes: indexed column -> index table id. Entries
        # live at pk64 = (value+2^31) << 32 | rowid; fields = [rowid,
        # value]. NULL values have no index entry.
        self.indexes: Dict[str, int] = dict(indexes or {})
        self.columns = columns  # [(name, type_name)] — stored order
        self.pk = pk            # None = hidden rowid
        self.notnull = list(notnull or [])  # declared NOT NULL columns
        # schema-change states: columns keep their PHYSICAL slot forever;
        # dropped = slots whose column was dropped; backfilling = an
        # added column not yet public (its job running)
        self.dropped = list(dropped or [])
        self.backfilling = backfilling
        self.dicts = dicts or {c: [] for c, t in columns if t == "string"}
        self.next_rowid = next_rowid
        self.row_count = row_count  # stats estimate for join ordering

    def encode(self) -> bytes:
        return json.dumps({
            "table_id": self.table_id, "name": self.name,
            "columns": self.columns, "pk": self.pk, "dicts": self.dicts,
            "next_rowid": self.next_rowid,
            "row_count": self.row_count,
            "indexes": self.indexes,
            "notnull": self.notnull,
            "dropped": self.dropped,
            "backfilling": self.backfilling}, sort_keys=True).encode()

    @staticmethod
    def decode(b: bytes) -> "TableDescriptor":
        d = json.loads(b.decode())
        return TableDescriptor(d["table_id"], d["name"],
                               [tuple(c) for c in d["columns"]],
                               d["pk"], d["dicts"], d["next_rowid"],
                               d.get("row_count", 0),
                               d.get("indexes", {}),
                               d.get("notnull", []),
                               d.get("dropped", []),
                               d.get("backfilling"))

    def nullable(self, cname: str) -> bool:
        return cname != self.pk and cname not in self.notnull

    def visible(self, cname: str) -> bool:
        return cname not in self.dropped and cname != self.backfilling

    def visible_columns(self) -> List[Tuple[str, str]]:
        return [(c, t) for c, t in self.columns if self.visible(c)]

    def schema(self) -> Schema:
        fields = []
        dicts = {}
        for cname, tname in self.visible_columns():
            ty = _type_of(tname)
            ref = None
            if ty.kind is Kind.STRING:
                ref = f"{self.name}.{cname}"
                dicts[ref] = np.asarray(self.dicts[cname], dtype=object)
            fields.append(Field(cname, ty, dict_ref=ref,
                                nullable=self.nullable(cname)))
        return Schema(fields, dicts)

    def value_columns(self) -> List[Tuple[str, str]]:
        """Columns stored in the row value (the pk rides the key). The
        row codec appends one hidden int64 field, the NULL bitmap (bit i
        = value column i is NULL). A VECTOR(d) column occupies d
        consecutive slots but ONE bitmap bit."""
        return [(c, t) for c, t in self.columns if c != self.pk]

    def value_slots(self) -> int:
        """Total physical int64 slots before the NULL bitmap."""
        return sum(_slots_of(t) for _, t in self.value_columns())

    def slot_offset(self, i: int) -> int:
        """First physical slot of value column i."""
        return sum(_slots_of(t)
                   for _, t in self.value_columns()[:i])

    def field_value(self, fields, i: int):
        """Value column i of a stored row, or None when its NULL bit is
        set (rows written before the bitmap existed have no mask)."""
        nv = self.value_slots()
        mask = fields[nv] if len(fields) > nv else 0
        return None if (mask >> i) & 1 else fields[self.slot_offset(i)]

    def decode_chunk(self, pks: np.ndarray, slots: np.ndarray,
                     wanted: Sequence[str]) -> Dict[str, np.ndarray]:
        """A chunk of the `wanted` columns (with their `__valid` lanes)
        from the positional slot codec: `slots` is (value_slots() + 1,
        rows), the last row the NULL bitmap; `pks` the rows' keys. Shared
        by the host walk, the resident tier, the index lookups and the
        transaction's reads, so all give the same chunks."""
        mask = slots[self.value_slots()]
        out: Dict[str, np.ndarray] = {}
        off = 0
        for i, (n, t) in enumerate(self.value_columns()):
            s = _slots_of(t)
            if s == 1:
                out[n] = slots[off]
            else:  # VECTOR(d): d slot rows -> (rows, d) float32
                out[n] = _slots_to_f32(np.ascontiguousarray(
                    slots[off:off + s].T))
            off += s
            if self.nullable(n):
                out[n + "__valid"] = ((mask >> i) & 1) == 0
        if self.pk is not None:
            out[self.pk] = np.asarray(pks, dtype=np.int64)
        chunk = {n: out[n] for n in wanted}
        for n in wanted:
            if n + "__valid" in out:
                chunk[n + "__valid"] = out[n + "__valid"]
        return chunk


def _rows_to_slots(rows: Sequence[Sequence[int]], n_fields: int
                   ) -> np.ndarray:
    """(n_fields, len(rows)) int64 from stored field lists; a short row
    (written before a column was added) reads zeros past its end."""
    out = np.zeros((n_fields, len(rows)), dtype=np.int64)
    for j, f in enumerate(rows):
        k = min(len(f), n_fields)
        out[:k, j] = f[:k]
    return out


def _index_pk(value: int, rowid: int) -> int:
    """Index-entry key: (value+2^31) << 32 | rowid — big-endian u64 order
    == (value, rowid) order. Raises BindError outside 32-bit bounds (the
    engine key codec is (table u16, pk u64))."""
    biased = value + (1 << 31)
    if not (0 <= biased < (1 << 32)):
        raise BindError(f"indexed value {value} outside 32-bit range")
    if not (0 <= rowid < (1 << 32)):
        raise BindError(f"rowid {rowid} outside 32-bit index range")
    return (biased << 32) | rowid


class SessionCatalog(Catalog):
    """Mutable catalog over one MVCCStore; descriptors persisted.

    One catalog is shared by every session over it: descriptor mutations
    (create/drop/save, id allocation) serialize under `_mu`, and DML
    serializes under the same lock (Session._run_dml holds it), because
    mutations update shared descriptor state in place (string
    dictionaries grow, `next_rowid` bumps). Reads (descriptor lookups,
    scans) take no lock: a dict get is atomic and the engine has its
    own lock."""

    def __init__(self, store: MVCCStore):
        self.store = store
        # RLock: create() calls _next_id() and save() under the lock
        self._mu = threading.RLock()
        self._descs: Dict[str, TableDescriptor] = {}
        # the prepared-statement cache shared by EVERY session of this
        # catalog; Session adopts the (dict, lock) pair wholesale
        self.shared_prepared = (OrderedDict(), threading.Lock())
        self._load_all()

    # ------------------------------------------------------ descriptors --

    def _key(self, table_id: int) -> bytes:
        return struct.pack(">HQ", DESC_TABLE, table_id)

    def _load_all(self):
        start = struct.pack(">HQ", DESC_TABLE, 0)
        end = struct.pack(">HQ", DESC_TABLE + 1, 0)
        for k in self.store.engine.scan_keys(start, end, Timestamp.MAX):
            hit = self.store.engine.get(k, Timestamp.MAX)
            if hit and hit[0]:
                desc = TableDescriptor.decode(hit[0])
                self._descs[desc.name] = desc

    def save(self, desc: TableDescriptor):
        with self._mu:
            self._descs[desc.name] = desc
            self.store.engine.put(self._key(desc.table_id),
                                  self.store.clock.now(), desc.encode())

    def drop(self, name: str):
        with self._mu:
            desc = self._descs.pop(name)
            # delete the table's DATA too: table ids are reused by
            # create(), and surviving rows would resurrect under the
            # next table's schema
            ts = self.store.clock.now()
            for tid in [desc.table_id] + list(desc.indexes.values()):
                start = struct.pack(">HQ", tid, 0)
                end = struct.pack(">HQ", tid + 1, 0)
                for k in self.store.engine.scan_keys(start, end,
                                                     Timestamp.MAX):
                    self.store.engine.delete(k, ts)
            self.store.engine.delete(self._key(desc.table_id), ts)

    def _next_id(self) -> int:
        with self._mu:
            used = [d.table_id for d in self._descs.values()]
            for d in self._descs.values():
                used.extend(d.indexes.values())
            return max(used, default=0) + 1

    def create(self, name: str, columns: List[Tuple[str, str]],
               pk: Optional[str],
               notnull: Optional[List[str]] = None) -> TableDescriptor:
        with self._mu:
            if name in self._descs:
                raise BindError(f"table {name!r} already exists")
            desc = TableDescriptor(self._next_id(), name, columns, pk,
                                   notnull=notnull)
            self.save(desc)
            return desc

    def desc(self, name: str) -> TableDescriptor:
        if name not in self._descs:
            raise BindError(f"no table {name!r}")
        return self._descs[name]

    # --------------------------------------------------------- Catalog --

    def table_schema(self, name: str) -> Schema:
        return self.desc(name).schema()

    def table_chunks(self, name: str, capacity: int, columns=None):
        desc = self.desc(name)
        wanted = list(columns) if columns else [c for c, _ in desc.columns]
        store = self.store
        tid = desc.table_id
        n_fields = desc.value_slots() + 1  # + the NULL bitmap

        def chunks():
            # the resident tier first, under storage/mvcc.py's fallback
            # rule; the host walk is the backstop
            # the clock is read only when the resident tier serves (the
            # host walk reads it below), as the JAX catalog reads it
            image = store.resident_columns(tid, n_fields, store.clock.now)
            if image is not None:
                pks, vals = image
                for off in range(0, int(pks.shape[0]), capacity):
                    yield desc.decode_chunk(pks[off:off + capacity],
                                            vals[:, off:off + capacity],
                                            wanted)
                return
            # the host walk: positional slots + the NULL bitmap, with
            # the primary keys from the scanner
            ts = store.clock.now()
            start = encode_key(tid, 0)
            end = encode_key(tid + 1, 0)
            while True:
                res = store.engine.scan_to_cols(start, end, ts, n_fields,
                                                capacity, with_pks=True)
                if res.rows:
                    yield desc.decode_chunk(res.pks, res.cols, wanted)
                if not res.more:
                    return
                start = res.resume_key

        return chunks

    def scan_cache_key(self, name: str, columns, capacity: int):
        # the content identity of MVCCCatalog: every engine write path
        # bumps the per-table version, so a rotated key never serves a
        # stale image. Descriptor changes (ADD/DROP COLUMN) rotate
        # through the column tuple. The "sess" tag keeps these keys
        # disjoint from MVCCCatalog images of the same table: this chunk
        # stream adds pk and validity lanes.
        desc = self.desc(name)
        cols = (tuple(columns) if columns
                else tuple(c for c, _ in desc.columns))
        prefix = self.store.scan_cache_prefix(desc.table_id)
        from cockroach_tpu_torch.storage import resident as _resident

        rt = _resident.lookup(self.store, desc.table_id)
        if rt is not None:
            # resident tier: (attach generation, ts-pack base, write
            # version, newest-version bucket) rotates on every write like
            # the plain key, but the rotated image costs one delta fold
            # and one visibility pass, not an engine walk
            base, bucket = rt.read_bucket(None)
            return prefix + (
                "sess", "resident", rt.generation, base,
                self.store.table_version(desc.table_id), bucket,
                int(capacity), cols)
        return prefix + ("sess", self.store.table_version(desc.table_id),
                         int(capacity), cols)

    def serving_image_key(self, name: str,
                          capacity: int) -> Optional[tuple]:
        """The ServingQueue's runner/compatibility key for one table.
        When the table is device-resident this is STABLE ACROSS WRITES —
        (attach generation, capacity) only — because the resident
        serving runner refreshes its image from the delta fold at every
        dispatch; a write therefore does not tear down the warm runner
        and its image. Falls back to the MVCC-versioned scan_cache_key
        (rotate-on-write) when not resident."""
        desc = self.desc(name)
        from cockroach_tpu_torch.storage import resident as _resident

        rt = _resident.maybe_attach(self.store, desc.table_id,
                                    desc.value_slots() + 1)
        if rt is not None:
            return self.store.scan_cache_prefix(desc.table_id) + (
                "sess", "resident-serving", rt.generation,
                int(capacity))
        return self.scan_cache_key(name, None, capacity)

    def resident_serving(self, name: str, cols) -> Optional[dict]:
        """The resident-tier build recipe for a ServingQueue runner over
        `cols` (INT single-slot projections, per match_batchable): the
        attached ResidentTable plus each column's value-slot index and
        NULL-bitmap bit (-1 = NOT NULL), and the bitmap's slot. None
        when the table is not resident or a column can't ride the
        resident image directly."""
        try:
            desc = self.desc(name)
        except BindError:  # dropped since keyed
            return None
        from cockroach_tpu_torch.storage import resident as _resident

        rt = _resident.maybe_attach(self.store, desc.table_id,
                                    desc.value_slots() + 1)
        if rt is None:
            return None
        slot_of: Dict[str, int] = {}
        bit_of: Dict[str, int] = {}
        off = 0
        for i, (n, t) in enumerate(desc.value_columns()):
            width = _slots_of(t)
            if width == 1:
                slot_of[n] = off
                bit_of[n] = i if desc.nullable(n) else -1
            off += width
        slots, bits = [], []
        for c in cols:
            if c == desc.pk:
                slots.append(-1)  # -1 = the image's pk lane itself
                bits.append(-1)
                continue
            if c not in slot_of:
                return None
            slots.append(slot_of[c])
            bits.append(bit_of[c])
        return {"rt": rt, "slots": tuple(slots), "bits": tuple(bits),
                "mask_slot": desc.value_slots()}

    def table_rows(self, name: str) -> int:
        return max(self.desc(name).row_count, 1)

    def table_pk(self, name: str) -> Optional[Tuple[str, ...]]:
        pk = self.desc(name).pk
        return (pk,) if pk else None

    def table_stats(self, name: str):
        from cockroach_tpu_torch.sql.stats import load_stats

        return load_stats(self.store, self.desc(name).table_id)

    def analyze(self, name: str):
        """ANALYZE <table>: sample the table through the catalog's chunk
        stream and persist TableStats in the stats keyspace."""
        from cockroach_tpu_torch.sql.stats import sample_stats, save_stats

        desc = self.desc(name)
        st = sample_stats(self.table_chunks(name, 1 << 12)())
        save_stats(self.store, desc.table_id, st)
        desc.row_count = st.row_count
        self.save(desc)
        return st

    # --------------------------------------------------------- indexes --

    def table_indexes(self, name: str) -> Dict[str, int]:
        return dict(self.desc(name).indexes)

    def index_chunks(self, name: str, column: str, lo: int, hi: int,
                     capacity: int, columns=None):
        """Index-join chunk stream (joinReader): scan the index span
        [lo, hi] in index order, then fetch each matching primary row by
        rowid in one batched lookup per chunk (kv/streamer.py)."""
        desc = self.desc(name)
        idx_id = desc.indexes[column]
        wanted = list(columns) if columns else [c for c, _ in desc.columns]
        store = self.store
        lo_pk = _index_pk(max(lo, -(1 << 31)), 0)
        hi_pk = _index_pk(min(hi, (1 << 31) - 1), (1 << 32) - 1)
        n_fields = desc.value_slots() + 1  # + the NULL bitmap

        def chunks():
            from cockroach_tpu_torch.kv.streamer import Streamer

            streamer = Streamer(store)
            ts = store.clock.now()
            start = struct.pack(">HQ", idx_id, lo_pk)
            # an unbounded upper constraint saturates the u64 key space:
            # the exclusive end is then the next table prefix
            end = (struct.pack(">HQ", idx_id + 1, 0)
                   if hi_pk >= (1 << 64) - 1
                   else struct.pack(">HQ", idx_id, hi_pk + 1))
            while True:
                res = store.engine.scan_to_cols(start, end, ts, 2,
                                                capacity)
                if res.rows == 0 and not res.more:
                    return
                rowids = np.asarray(res.cols[0][:res.rows], np.int64)
                pks, cols = streamer.multi_get_cols(desc.table_id, rowids,
                                                    n_fields)
                # back into index order; a rowid with no row is skipped
                pos = np.searchsorted(pks, rowids).clip(
                    0, max(len(pks) - 1, 0))
                found = (pks[pos] == rowids) if len(pks) else \
                    np.zeros(len(rowids), bool)
                if found.any():
                    yield desc.decode_chunk(rowids[found],
                                            cols[:, pos[found]], wanted)
                if not res.more:
                    return
                start = res.resume_key

        return chunks


class _TxnReadCatalog(Catalog):
    """Catalog overlay for SELECTs inside an open transaction: tables
    the transaction has written are served row by row through it
    (read-your-writes, and the reads recorded for its commit check);
    tables it has not written stream through the base catalog."""

    def __init__(self, base: SessionCatalog, txn):
        self.base = base
        self.txn = txn

    def _touched(self, name) -> bool:
        tid = self.base.desc(name).table_id
        return any(t == tid for (t, _pk) in self.txn._writes)

    def table_schema(self, name):
        return self.base.table_schema(name)

    def table_rows(self, name):
        return self.base.table_rows(name)

    def table_pk(self, name):
        return self.base.table_pk(name)

    def table_stats(self, name):
        return self.base.table_stats(name)

    def table_indexes(self, name):
        # index entries are not transaction-buffered: no index plans for
        # tables this transaction wrote
        return {} if self._touched(name) else self.base.table_indexes(name)

    def index_chunks(self, *a, **kw):
        return self.base.index_chunks(*a, **kw)

    def table_chunks(self, name, capacity, columns=None):
        if not self._touched(name):
            return self.base.table_chunks(name, capacity, columns)
        desc = self.base.desc(name)
        txn = self.txn
        wanted = list(columns) if columns else [c for c, _ in desc.columns]
        n_fields = desc.value_slots() + 1

        def chunks():
            pks = sorted(set(txn.scan_pks(desc.table_id))
                         | set(txn.buffered_pks(desc.table_id)))
            rows = []
            for pk in pks:
                fields = txn.get(desc.table_id, pk)
                if fields is not None:
                    rows.append((pk, fields))
            for a in range(0, len(rows), capacity):
                part = rows[a:a + capacity]
                yield desc.decode_chunk(
                    np.asarray([p for p, _ in part], dtype=np.int64),
                    _rows_to_slots([f for _, f in part], n_fields),
                    wanted)

        return chunks


class _Prepared:
    """A cached SELECT: the built operator tree, its output schema, the
    per-table scan-cache keys the plan was built against (the validity
    check), the capacity those keys were computed at (the shared cache
    serves sessions of any capacity; the plan's own chunking is what the
    keys describe), and the serving queue's BatchSpec when the statement
    is batchable (sql/serving.py; None otherwise). A serving-only entry
    has no tree (`op` None)."""

    __slots__ = ("op", "schema", "vkeys", "capacity", "bspec")

    def __init__(self, op, schema, vkeys: Dict[str, tuple],
                 capacity: int, bspec=None):
        self.op = op
        self.schema = schema
        self.vkeys = vkeys
        self.capacity = capacity
        self.bspec = bspec


# statements that change plans wholesale (the version check cannot see
# them): each clears the prepared cache
_PLAN_CHANGING = (P.CreateTable, P.DropTable, P.CreateIndex, P.AlterTable,
                  P.SetVar, P.AnalyzeStmt)
_DDL = (P.CreateTable, P.DropTable, P.CreateIndex, P.AlterTable)


class Session:
    """One SQL session: statement dispatch + session vars. Statements run
    on `device` (CUDA unless the caller passes one)."""

    # session var -> cluster-setting key (None = session-local only).
    # `pallas` names the hand-kernel switch, the port's sql.gpu.kernels;
    # `vectorize` is auto|gpu|cpu: cpu places flows on the host; gpu is
    # an alias of auto, which runs them on the session's device (the port
    # has no CPU placement for auto to choose; sql/cost.py).
    _VARS = {
        "exact_arithmetic": "sql.tpu.exact_arithmetic",
        "pallas": "sql.gpu.kernels",
        "admission_slots": _admission.ADMISSION_SLOTS,
        "workmem": "sql.distsql.temp_storage.workmem",
        "vectorize": None,
        # per-statement deadline in seconds: session-local, defaulting
        # to the sql.defaults.statement_timeout cluster setting
        "statement_timeout": None,
        # admission priority for this session's statements: low|normal|high
        "admission_priority": None,
    }
    _VECTORIZE = ("auto", "gpu", "cpu")

    # statements exempt from admission gating AND from error-aborts-txn:
    # transaction control must always run (a COMMIT queued behind the
    # very work holding the slots would wedge), SET/SHOW are free, and
    # CANCEL must reach an overloaded server
    _CONTROL_HEADS = ("begin", "commit", "rollback", "abort", "start",
                      "set", "show", "cancel")

    PREPARED_CACHE_ENTRIES = 32

    def __init__(self, catalog: Catalog, capacity: int = 1 << 14,
                 device=None, db: Optional[DB] = None, registry=None):
        from cockroach_tpu_torch.server.registry import (
            default_query_registry,
        )

        self.catalog = catalog
        self.capacity = capacity
        self.device = device
        self.session_id = next(_session_ids)
        # SHOW SESSIONS visibility; the registry holds this session by
        # weakref, so registration never extends its life
        self._qreg = registry or default_query_registry()
        self._qreg.register_session(self)
        # execution-insights sampling state (_observe_insight): tick
        # counter for the 1-in-8 sub-floor baseline feed and the cached
        # latency floor (0.0 -> the first statement refreshes it)
        self._ins_tick = 0
        self._ins_floor = 0.0
        # the in-flight statement's cancel context, set for the duration
        # of execute(): cancel_query() reaches it from OTHER threads
        self._cancel_mu = threading.Lock()
        self._active_cancel = None
        self.vars: Dict[str, object] = {"vectorize": "auto",
                                        "admission_priority": "normal"}
        if db is None and isinstance(catalog, SessionCatalog):
            db = DB(catalog.store)
        self.db = db
        self._txn = None  # the open transaction (BEGIN .. COMMIT)
        self._txn_aborted = False
        self._txn_row_deltas: Dict[str, int] = {}  # applied at COMMIT
        # prepared-statement cache: EXACT SQL text -> _Prepared. Keyed on
        # the text, NOT sqlstats.fingerprint — the fingerprint strips
        # literals, and two statements differing only in literals need
        # different plans. A SessionCatalog shares one (dict, lock) pair
        # across its sessions; other catalogs get a private pair.
        shared = getattr(catalog, "shared_prepared", None)
        if shared is not None:
            self._prepared, self._prepared_mu = shared
        else:
            self._prepared = OrderedDict()
            self._prepared_mu = threading.Lock()

    # ------------------------------------------------------ cancellation

    def _statement_timeout(self) -> float:
        """Effective statement deadline: session var if SET, else the
        sql.defaults.statement_timeout cluster setting; <= 0 = none."""
        v = self.vars.get("statement_timeout")
        if v is None:
            v = Settings().get(STATEMENT_TIMEOUT)
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    def _admission_priority(self) -> int:
        return {"low": _admission.LOW, "high": _admission.HIGH}.get(
            str(self.vars.get("admission_priority", "normal")).lower(),
            _admission.NORMAL)

    def cancel_query(self, reason: str = "query cancelled") -> bool:
        """Cancel the in-flight statement (if any) from another thread.
        Returns whether a statement was in flight to cancel."""
        with self._cancel_mu:
            ctx = self._active_cancel
        if ctx is None:
            return False
        ctx.cancel(reason)
        return True

    # ---------------------------------------------------------- execute --

    def execute(self, sql: str) -> Tuple[str, object, object]:
        """-> (kind, payload, schema) like explain.execute_with_plan, plus
        kind 'ok' (DDL, DML, SET; payload = tag string). Every statement
        records into sqlstats under a per-query stats overlay, which
        attributes its execution seconds to its fingerprint. A failing
        statement inside an open transaction aborts it (Postgres).

        The lifecycle seams around `_execute`: the statement registers
        in the query registry BEFORE admission (a queued statement is
        visible to SHOW QUERIES and cancellable); its entry is the
        CancelContext armed with the effective statement_timeout; work
        statements pass session admission (shed -> 53300); a cancel or a
        deadline surfaces as 57014 with the session reusable; the root
        span, the slow-query log and the insights observe it. Every exit
        path deregisters the entry and releases the slot."""
        from cockroach_tpu_torch.exec import stats as _stats
        from cockroach_tpu_torch.server import registry as _registry
        from cockroach_tpu_torch.sql.insights import default_insights
        from cockroach_tpu_torch.sql.sqlstats import default_sqlstats
        from cockroach_tpu_torch.util import cancel as _cancel
        from cockroach_tpu_torch.util import tracing

        head = sql.strip().split(None, 1)[0].lower() if sql.strip() else ""
        t0 = time.perf_counter()
        timeout = self._statement_timeout()
        # a statement headed for the serving queue skips per-statement
        # admission — the batch LEADER acquires one slot for the whole
        # coalesced batch (sql/serving.py), so the coalescing depth is
        # not capped at the slot count. The probe (a dict get, no side
        # effects) runs first so the statement registers directly in
        # its final phase.
        from cockroach_tpu_torch.sql import serving as _serving

        serving_path = head == "select" and _serving.probe(self, sql)
        qreg = self._qreg
        # the registry entry doubles as the statement's CancelContext
        ctx = qentry = qreg.register(
            self, sql, timeout if timeout > 0 else None,
            phase=(_registry.PHASE_SERVING if serving_path
                   else _registry.PHASE_QUEUED),
            track=not serving_path, start_pc=t0)
        qid = qentry.query_id
        with self._cancel_mu:
            self._active_cancel = ctx
        queue = None
        try:
            with tracing.query_span("session.execute", sql=sql[:60]), \
                    _cancel.active(ctx), _stats.query_stats() as qcol:
                try:
                    if not serving_path:
                        queue = self._admit(head)
                        qentry.phase = _registry.PHASE_EXECUTING
                    kind, payload, schema = self._execute(sql)
                except Exception as e:
                    elapsed = time.perf_counter() - t0
                    default_sqlstats().record(
                        sql, elapsed, error=True,
                        session_id=self.session_id,
                        device_s=_stats.device_seconds(qcol),
                        bytes_scanned=_stats.bytes_scanned(qcol))
                    self._maybe_log_slow(sql, elapsed, error=True)
                    default_insights().observe(
                        sql, elapsed, session_id=self.session_id,
                        query_id=qid,
                        shed=(isinstance(e, SQLError)
                              and e.pgcode == "53300"),
                        degraded=_stats.degradations_seen(qcol),
                        error=True)
                    if self._txn is not None and \
                            head not in self._CONTROL_HEADS:
                        self._txn_aborted = True
                    mapped = map_execution_error(e)
                    if mapped is not None:
                        try:
                            raise mapped from e
                        finally:
                            # no frame -> error -> traceback -> frame
                            # cycle: the failed flow's device memory goes
                            # with the traceback, not at a later GC pass
                            del mapped
                    raise
                rows = 0
                if kind == "rows" and payload:
                    first = next(iter(payload.values()), None)
                    rows = len(first) if first is not None else 0
                elapsed = time.perf_counter() - t0
                default_sqlstats().record(
                    sql, elapsed, rows=rows, session_id=self.session_id,
                    device_s=_stats.device_seconds(qcol),
                    bytes_scanned=_stats.bytes_scanned(qcol),
                    op_device=_stats.operator_device(qcol))
                self._maybe_log_slow(sql, elapsed, rows=rows)
                self._observe_insight(sql, elapsed, qid,
                                      _stats.degradations_seen(qcol))
            return kind, payload, schema
        finally:
            qreg.deregister(self, qentry, not serving_path)
            if queue is not None:
                queue.release()
            with self._cancel_mu:
                self._active_cancel = None

    def execute_spec(self, spec, sql: str):
        """The EXECUTE fast path (pgwire Bind matched the bound text to
        a batch class): serve the statement straight through the
        ServingQueue with the same lifecycle seams as execute() —
        cancel context + statement_timeout, sqlstats, slow-query log,
        error mapping — but no parse, no plan, and no per-statement
        admission (the batch leader admits for the whole batch).
        Returns (kind, payload, schema), or None when the statement
        should run the normal path instead (batch declined/fell back,
        open transaction, serving disabled)."""
        from cockroach_tpu_torch.server import registry as _registry
        from cockroach_tpu_torch.sql import serving as _serving
        from cockroach_tpu_torch.sql.insights import default_insights
        from cockroach_tpu_torch.sql.sqlstats import default_sqlstats
        from cockroach_tpu_torch.util import cancel as _cancel
        from cockroach_tpu_torch.util import tracing

        if (not _serving.enabled() or self._txn is not None
                or self._txn_aborted):
            return None
        t0 = time.perf_counter()
        timeout = self._statement_timeout()
        qreg = self._qreg
        # the registry entry doubles as the statement's CancelContext
        ctx = qentry = qreg.register(self, sql,
                                     timeout if timeout > 0 else None,
                                     phase=_registry.PHASE_SERVING,
                                     start_pc=t0)
        qid = qentry.query_id
        with self._cancel_mu:
            self._active_cancel = ctx
        try:
            with tracing.query_span("session.execute_spec",
                                    sql=sql[:60]), \
                    _cancel.active(ctx):
                try:
                    vkey = _serving._class_vkey(self.catalog,
                                                self.capacity, spec)
                    if vkey is None:
                        return None
                    payload = _serving.serving_queue().submit(
                        self, spec, vkey, via="execute")
                except Exception as e:
                    elapsed = time.perf_counter() - t0
                    default_sqlstats().record(
                        sql, elapsed, error=True,
                        session_id=self.session_id)
                    self._maybe_log_slow(sql, elapsed, error=True)
                    default_insights().observe(
                        sql, elapsed, session_id=self.session_id,
                        query_id=qid,
                        shed=(isinstance(e, SQLError)
                              and e.pgcode == "53300"),
                        error=True)
                    mapped = map_execution_error(e)
                    if mapped is not None:
                        try:
                            raise mapped from e
                        finally:
                            del mapped
                    raise
                if payload is None:
                    # the batch declined or fell apart mid-flight: the
                    # caller re-runs the statement serially — an insight
                    # the operator should see when it becomes a pattern
                    default_insights().observe(
                        sql, time.perf_counter() - t0,
                        session_id=self.session_id, query_id=qid,
                        batch_fallback=True, error=True)
                    return None
                first = next(iter(payload.values()), None)
                rows = len(first) if first is not None else 0
                elapsed = time.perf_counter() - t0
                default_sqlstats().record(sql, elapsed, rows=rows,
                                          session_id=self.session_id)
                self._maybe_log_slow(sql, elapsed, rows=rows)
                self._observe_insight(sql, elapsed, qid, False)
                return "rows", payload, _serving.spec_schema(spec)
        finally:
            qreg.deregister(self, qentry)
            with self._cancel_mu:
                self._active_cancel = None

    def _admit(self, head: str):
        """Session-layer admission: gate work statements through the
        shared WorkQueue. Returns the queue holding ONE slot — released
        in execute()'s finally, so a shed, cancel or execution error
        never leaks a slot — or None when admission is off or the
        statement is exempt."""
        queue = _admission.session_queue()
        if queue is None or head in self._CONTROL_HEADS:
            return None
        try:
            queue.acquire(
                priority=self._admission_priority(),
                timeout=float(Settings().get(
                    _admission.SESSION_QUEUE_TIMEOUT)))
        except TimeoutError as e:
            # 53300 too_many_connections: the server is at capacity —
            # overload sheds statements instead of a collapsing convoy
            raise SQLError(
                "53300",
                "statement shed: admission queue timed out under "
                "overload") from e
        return queue

    def _observe_insight(self, sql: str, elapsed: float, qid: int,
                         degraded: bool) -> None:
        """Healthy-statement insights seam. Full observe() runs for
        degraded or at/above-floor executions (those can flag) and for
        a 1-in-8 baseline sample of sub-floor ones; the other 7/8 of
        warm sub-floor statements pay only this guard."""
        tick = self._ins_tick = (self._ins_tick + 1) & 7
        if degraded or tick == 0 or elapsed >= self._ins_floor:
            from cockroach_tpu_torch.sql.insights import default_insights

            ins = default_insights()
            self._ins_floor = ins.min_latency_floor()
            ins.observe(sql, elapsed, session_id=self.session_id,
                        query_id=qid, degraded=degraded)

    def _maybe_log_slow(self, sql: str, elapsed: float, rows: int = 0,
                        error: bool = False) -> None:
        """Slow-query log (sql.log.slow_query_latency feeding the
        SQL_EXEC channel). Disabled at the default 0."""
        threshold = float(Settings().get(SLOW_QUERY_LATENCY))
        if threshold <= 0 or elapsed < threshold:
            return
        interval = float(Settings().get(SLOW_QUERY_INTERVAL))
        if interval > 0:
            from cockroach_tpu_torch.sql.sqlstats import fingerprint

            fp = fingerprint(sql)
            now = time.monotonic()
            with _slow_log_mu:
                last = _slow_log_last.get(fp)
                if last is not None and now - last < interval:
                    return
                _slow_log_last[fp] = now
        from cockroach_tpu_torch.util.log import (
            Channel, Redactable, get_logger,
        )

        get_logger().structured(
            Channel.SQL_EXEC, "WARNING", "slow_query",
            sql=Redactable(sql), latency_s=round(elapsed, 4), rows=rows,
            error=error, session=self.session_id)

    # ------------------------------------------------ prepared statements

    def _prepared_lookup(self, sql: str) -> Optional[_Prepared]:
        """The prepared entry for this exact SQL text, IF every scanned
        table's current scan-cache key still equals the one the plan was
        built against (over a SessionCatalog the key embeds the table's
        write version, so any write rotates it)."""
        with self._prepared_mu:
            prep = self._prepared.get(sql)
        if prep is None:
            return None
        for tname, vkey in prep.vkeys.items():
            try:
                cur = self.catalog.scan_cache_key(tname, None,
                                                  prep.capacity)
            except Exception:  # noqa: BLE001 — e.g. table dropped
                cur = None
            if cur != vkey:
                if (prep.bspec is not None and cur is not None
                        and len(prep.vkeys) == 1
                        and tname == prep.bspec.table
                        and self._serving_still_warm(tname,
                                                     prep.capacity)):
                    # the plan's stacked image is stale, but the
                    # statement is batchable over a device-resident
                    # table whose serving image refreshes per dispatch:
                    # hand back a serving-only entry (op=None) so the
                    # warm path still skips the parse — _execute falls
                    # through to the cold path only if the serving
                    # submit itself declines
                    return _Prepared(None, prep.schema, prep.vkeys,
                                     prep.capacity, prep.bspec)
                with self._prepared_mu:
                    self._prepared.pop(sql, None)
                return None
        with self._prepared_mu:
            if sql in self._prepared:
                self._prepared.move_to_end(sql)
        return prep

    def _serving_still_warm(self, tname: str, capacity: int) -> bool:
        """Is `tname` device-resident, i.e. does its serving image
        survive writes? (The stable-across-writes serving_image_key
        tags resident tables "resident-serving".)"""
        sik = getattr(self.catalog, "serving_image_key", None)
        if sik is None:
            return False
        try:
            k = sik(tname, capacity)
        except Exception:  # noqa: BLE001
            return False
        return k is not None and "resident-serving" in k

    def _prepared_store(self, sql: str, sunk, ast=None) -> None:
        """Cache the built operator tree when it is safely re-runnable:
        every scan carries a cache key (an IndexScan's does not), and
        every scanned table vouches for its content with a scan-cache
        key. Statements in the serving queue's batchable class
        additionally carry a BatchSpec, the ticket into cross-session
        coalescing."""
        from cockroach_tpu_torch.exec.operators import ScanOp, walk_operators
        from cockroach_tpu_torch.sql.plan import Scan as _Scan, _walk_plan

        op = sunk.get("op") if isinstance(sunk, dict) else None
        if op is None:
            return
        for s in walk_operators(op):
            if isinstance(s, ScanOp) and s.cache_key is None:
                return
        vkeys: Dict[str, tuple] = {}
        for t in {n.table for n in _walk_plan(sunk["plan"])
                  if isinstance(n, _Scan)}:
            try:
                k = self.catalog.scan_cache_key(t, None, self.capacity)
            except Exception:  # noqa: BLE001
                return
            if k is None:
                return
            vkeys[t] = k
        bspec = None
        if ast is not None:
            from cockroach_tpu_torch.sql import serving as _serving

            try:
                bspec = _serving.match_batchable(ast, self.catalog,
                                                 self.capacity)
            except Exception:  # noqa: BLE001 — matcher must never
                bspec = None   # block the prepared path
        with self._prepared_mu:
            self._prepared[sql] = _Prepared(op, op.schema, vkeys,
                                            self.capacity, bspec)
            self._prepared.move_to_end(sql)
            while len(self._prepared) > self.PREPARED_CACHE_ENTRIES:
                self._prepared.popitem(last=False)

    def _execute(self, sql: str) -> Tuple[str, object, object]:
        # warm-path short-circuit BEFORE the parse: a prepared hit needs
        # no ast at all (only SELECTs are ever stored, and the entry was
        # validated against the tables' cache keys). Not inside a
        # transaction: its reads go through the transaction.
        if self._txn is None and not self._txn_aborted:
            prep = self._prepared_lookup(sql)
            if prep is not None:
                from cockroach_tpu_torch.exec import collect, stats

                stats.add("sql.prepared_hit")
                if prep.bspec is not None:
                    from cockroach_tpu_torch.sql import serving as _serving

                    payload = _serving.maybe_submit(self, prep, sql=sql)
                    if payload is not None:
                        return "rows", payload, prep.schema
                if prep.op is not None:
                    return "rows", collect(prep.op, device=self.device,
                                           backend=self.vars["vectorize"]
                                           ), prep.schema
                # serving-only entry (stale plan over a resident table)
                # whose batch submit declined: fall through to the cold
                # parse path, which also re-stores a full entry
        ast = P.parse(sql)
        if isinstance(ast, _PLAN_CHANGING):
            # schema, settings or stats changes can change plans
            # wholesale: drop every prepared entry (DML is covered by the
            # per-hit version check)
            with self._prepared_mu:
                self._prepared.clear()
        if self._txn_aborted and not isinstance(ast, P.TxnControl):
            raise BindError("current transaction is aborted — "
                            "ROLLBACK to continue")
        if self._txn is not None and isinstance(ast, _DDL):
            raise BindError("DDL inside a transaction is not supported "
                            "(descriptors are not transactional yet)")
        if isinstance(ast, P.SelectStmt) and len(ast.tables) == 1 \
                and isinstance(self.catalog, SessionCatalog) \
                and self._matviews().get(ast.tables[0].name) is not None:
            return self._select_matview(ast)
        if isinstance(ast, (P.SelectStmt, P.ExplainStmt)):
            return self._select(sql, ast)
        if isinstance(ast, P.TxnControl):
            return self._txn_control(ast)
        if isinstance(ast, P.SetVar):
            return self._set_var(ast)
        if isinstance(ast, P.ShowVar):
            name = ast.name
            if name not in self._VARS:
                raise BindError(f"unknown session variable {name!r}")
            if name == "statement_timeout":
                # the effective value: the session's, else the default
                value = self.vars.get(name)
                if value is None:
                    value = Settings().get(STATEMENT_TIMEOUT)
            else:
                value = self._get_var(name)
            return "rows", {name: np.asarray([str(value)],
                                             dtype=object)}, None
        if isinstance(ast, P.ShowStmt):
            return self._show_stmt(ast)
        if isinstance(ast, P.CancelQuery):
            reason = f"CANCEL QUERY {ast.query_id}"
            # the local registry; routing an id another node owns is
            # ROADMAP.md queue 1, item 8e
            if not self._qreg.cancel(ast.query_id, reason=reason):
                # 42704 undefined_object: the id names nothing live
                raise SQLError("42704",
                               f"unknown query id {ast.query_id}")
            return "ok", "CANCEL QUERY", None
        if not isinstance(self.catalog, SessionCatalog):
            raise BindError("this catalog is read-only (DDL/DML need a "
                            "storage-backed session)")
        if isinstance(ast, P.CreateTable):
            return self._create(ast)
        if isinstance(ast, P.CreateIndex):
            return self._create_index(ast)
        if isinstance(ast, P.AlterTable):
            return self._alter(ast)
        if isinstance(ast, P.AnalyzeStmt):
            st = self.catalog.analyze(ast.table)
            return "ok", f"ANALYZE {st.row_count} rows", None
        if isinstance(ast, P.DropTable):
            return self._drop(ast)
        if isinstance(ast, P.Insert):
            return self._insert(ast)
        if isinstance(ast, P.Update):
            return self._update(ast)
        if isinstance(ast, P.Delete):
            return self._delete(ast)
        if isinstance(ast, P.CreateChangefeed):
            return self._create_changefeed(ast)
        if isinstance(ast, P.StreamChangefeed):
            return self._stream_changefeed(ast)
        if isinstance(ast, P.CreateMatView):
            return self._create_matview(ast)
        if isinstance(ast, P.DropMatView):
            return self._drop_matview(ast)
        if isinstance(ast, P.RefreshMatView):
            return self._refresh_matview(ast)
        if isinstance(ast, P.JobControl):
            return self._job_control(ast)
        raise BindError(f"unsupported statement {type(ast).__name__}")

    def _select(self, sql: str, ast):
        """SELECT / EXPLAIN. Inside an open transaction the statement
        reads through `_TxnReadCatalog` and is not kept."""
        from cockroach_tpu_torch.sql.explain import execute_with_plan

        catalog = self.catalog
        if self._txn is not None and isinstance(catalog, SessionCatalog):
            catalog = _TxnReadCatalog(catalog, self._txn)
        kw = dict(ast=ast, device=self.device,
                  setting=self.vars["vectorize"], resident=True)
        if isinstance(ast, P.SelectStmt) and self._txn is None:
            sink: List[object] = []
            out = execute_with_plan(sql, catalog, self.capacity,
                                    op_sink=sink, **kw)
            if sink:
                self._prepared_store(sql, sink[0], ast)
            return out
        return execute_with_plan(sql, catalog, self.capacity, **kw)

    # ------------------------------------------------------ transactions

    def _txn_control(self, ast: P.TxnControl):
        """BEGIN / COMMIT / ROLLBACK. Mutations inside an open
        transaction buffer in one kv.Txn and apply atomically at COMMIT
        with serializable validation (a conflict surfaces at COMMIT as a
        'restart transaction' error). COMMIT of an aborted transaction
        rolls back."""
        if self.db is None:
            raise BindError("transactions need a storage-backed session")
        if ast.op == "begin":
            if self._txn is not None:
                raise BindError("there is already a transaction open")
            self._txn = self.db.txn()
            self._txn_aborted = False
            self._txn_row_deltas = {}
            return "ok", "BEGIN", None
        if self._txn is None:
            raise BindError("no transaction is open")
        txn, self._txn = self._txn, None
        deltas, self._txn_row_deltas = self._txn_row_deltas, {}
        aborted, self._txn_aborted = self._txn_aborted, False
        if ast.op == "rollback" or aborted:
            txn.rollback()
            return "ok", "ROLLBACK", None
        try:
            txn.commit()
        except TxnRetryError as e:
            raise BindError(f"restart transaction: {e}") from e
        # row-count deltas apply only once the writes are durable
        if isinstance(self.catalog, SessionCatalog):
            for tname, d in deltas.items():
                try:
                    desc = self.catalog.desc(tname)
                except BindError:
                    continue  # table dropped meanwhile
                desc.row_count = max(0, desc.row_count + d)
                self.catalog.save(desc)
        return "ok", "COMMIT", None

    def _run_dml(self, op) -> None:
        """Run a mutation closure: inside the open transaction when one
        exists (deferred commit), else auto-commit with retries. DML of
        every session of the catalog serializes under its lock: the
        closures mutate descriptor state in place (dictionaries grow,
        next_rowid bumps), which no MVCC version check protects."""
        mu = getattr(self.catalog, "_mu", None)
        with (mu if mu is not None else contextlib.nullcontext()):
            if self._txn is not None:
                if self._txn_aborted:
                    raise BindError("current transaction is aborted — "
                                    "ROLLBACK to continue")
                op(self._txn)
            else:
                self.db.run(op)

    def _bump_rows(self, cat: SessionCatalog, desc: TableDescriptor,
                   delta: int) -> None:
        """Row-count stats: immediate in auto-commit; deferred to COMMIT
        inside an open transaction (a rollback must not drift them)."""
        if self._txn is not None:
            self._txn_row_deltas[desc.name] = (
                self._txn_row_deltas.get(desc.name, 0) + delta)
        else:
            desc.row_count = max(0, desc.row_count + delta)
        cat.save(desc)  # dictionaries/rowid watermark persist either way

    # ------------------------------------------------------------- vars --

    def _show_stmt(self, ast: "P.ShowStmt"):
        """SHOW QUERIES | SESSIONS | JOBS: sugar over the crdb_internal
        virtual-table providers, in the ShowVar shape (object-dtype
        columns, no schema)."""
        from cockroach_tpu_torch.sql.vtable import TABLES, provider_rows

        table = {"queries": "cluster_queries",
                 "sessions": "cluster_sessions",
                 "jobs": "jobs"}[ast.kind]
        if ast.kind == "jobs" and isinstance(self.catalog,
                                             SessionCatalog):
            self._jobs_registry()
        rows = provider_rows(table, self.catalog)
        cols = [c for c, _, _ in TABLES[table][0]]
        payload = {c: np.asarray([r.get(c) for r in rows], dtype=object)
                   for c in cols}
        return "rows", payload, None

    # --------------------------------------- changefeeds / matviews / jobs

    def _matviews(self):
        """The catalog-attached MatViewManager (made on first use; the
        definitions load from the 0xFFC0 system keyspace once per
        catalog). Its group states live on the device of the session
        that made it."""
        from cockroach_tpu_torch.sql.matview import MatViewManager

        cat = self.catalog
        mgr = getattr(cat, "_matview_mgr", None)
        if mgr is None:
            mgr = MatViewManager(cat, device=self.device)
            cat._matview_mgr = mgr
        return mgr

    def _jobs_registry(self):
        """The catalog-attached jobs Registry that SHOW JOBS and
        crdb_internal.jobs list (job records are durable in the store,
        so it lists the CREATE INDEX and ALTER TABLE backfills every
        session ran), with the changefeed resumer registered: shared
        across sessions, so CANCEL JOB fences feeds any session
        started."""
        from cockroach_tpu_torch.server.jobs import Registry
        from cockroach_tpu_torch.sql import changefeed as _cf

        cat: SessionCatalog = self.catalog
        reg = getattr(cat, "_jobs_registry", None)
        if reg is None:
            reg = Registry(cat.store)
            _cf.register(reg, cat)
            cat._jobs_registry = reg
        return reg

    def _create_changefeed(self, ast: P.CreateChangefeed):
        from cockroach_tpu_torch.server.jobs import States
        from cockroach_tpu_torch.sql.bind import bind_changefeed

        cat: SessionCatalog = self.catalog
        desc, options = bind_changefeed(ast, cat)
        payload: dict = {"table": desc.name,
                         "options": {"resolved":
                                     bool(options.pop("resolved", False))}}
        sink_opt = options.pop("sink", None)
        if sink_opt:
            s = str(sink_opt)
            payload["sink"] = ({"kind": "file", "path": s[5:]}
                               if s.startswith("file:")
                               else {"kind": "memory", "token": s})
        if "target_wall" in options:
            payload["target"] = [int(options.pop("target_wall")), 0]
        for k in ("max_polls", "poll_interval_ms", "once"):
            if k in options:
                payload[k] = options.pop(k)
        finite = any(k in payload for k in ("target", "max_polls",
                                            "once"))
        run_opt = options.pop("run", None)
        if run_opt is not None and bool(run_opt) and not finite:
            # adopt_and_run would never return: a continuous feed has
            # no stop condition, so inline execution hangs the session
            raise BindError(
                "WITH run needs a stop condition (once / max_polls / "
                "target_wall); run continuous feeds on a background "
                "adopter and stop them with CANCEL JOB")
        run_inline = finite if run_opt is None else bool(run_opt)
        reg = self._jobs_registry()
        job_id = reg.create("changefeed", payload)
        if run_inline:
            reg.adopt_and_run()
            rec = reg.get(job_id)
            if rec.state == States.FAILED:
                raise SQLError("XX000", f"changefeed failed: {rec.error}")
        return "rows", {"job_id": np.asarray([job_id], np.int64)}, None

    def _stream_changefeed(self, ast: P.StreamChangefeed):
        """EXPERIMENTAL CHANGEFEED FOR t: the "stream" result kind, a
        generator of envelope lines (sql/changefeed.py stream_rows)."""
        from cockroach_tpu_torch.sql import changefeed as _cf
        from cockroach_tpu_torch.sql.bind import bind_changefeed

        cat: SessionCatalog = self.catalog
        desc, options = bind_changefeed(ast, cat)
        return "stream", _cf.stream_rows(cat, desc, options), None

    def _create_matview(self, ast: P.CreateMatView):
        self._matviews().create(ast.name, ast.sql, ast.if_not_exists)
        return "ok", "CREATE MATERIALIZED VIEW", None

    def _drop_matview(self, ast: P.DropMatView):
        self._matviews().drop(ast.name, ast.if_exists)
        return "ok", "DROP MATERIALIZED VIEW", None

    def _refresh_matview(self, ast: P.RefreshMatView):
        mv = self._matviews().get(ast.name)
        if mv is None:
            raise BindError(f"no materialized view {ast.name!r}")
        mv.refresh()
        return "ok", "REFRESH MATERIALIZED VIEW", None

    def _select_matview(self, ast: P.SelectStmt):
        """SELECT * FROM <view>: serve from the device-resident group
        state (refreshed to now), rows sorted by group key."""
        if (len(ast.items) != 1
                or not isinstance(ast.items[0][0], P.ColRef)
                or ast.items[0][0].name != "*"
                or ast.where is not None or ast.group_by
                or ast.order_by or ast.limit is not None):
            raise BindError("materialized views support only "
                            "SELECT * FROM <view> reads")
        payload, schema = self._matviews().read(ast.tables[0].name)
        return "rows", payload, schema

    def _job_control(self, ast: P.JobControl):
        reg = self._jobs_registry()
        if ast.op == "cancel":
            reg.cancel(ast.job_id)
        elif ast.op == "pause":
            reg.pause(ast.job_id)
        else:
            reg.resume(ast.job_id)
        return "ok", f"{ast.op.upper()} JOB", None

    def _get_var(self, name: str):
        key = self._VARS[name]
        if key is None:
            return self.vars.get(name)
        return Settings().get(key)

    def _set_var(self, ast: P.SetVar):
        if ast.name not in self._VARS:
            raise BindError(f"unknown session variable {ast.name!r}")
        value = ast.value
        if ast.name not in ("pallas", "vectorize"):  # string-valued vars
            if value in ("on", "true"):
                value = True
            elif value in ("off", "false"):
                value = False
        if ast.name == "vectorize" and value not in self._VECTORIZE:
            raise BindError(f"vectorize must be one of "
                            f"{', '.join(self._VECTORIZE)}, not {value!r}")
        key = self._VARS[ast.name]
        if key is None:
            self.vars[ast.name] = value
        else:
            Settings().set(key, value)
        return "ok", f"SET {ast.name}", None

    # -------------------------------------------------------------- DDL --

    def _create(self, ast: P.CreateTable):
        cat: SessionCatalog = self.catalog
        if ast.if_not_exists and ast.name in cat._descs:
            return "ok", "CREATE TABLE", None
        pk = None
        for c in ast.columns:
            if c.type_name == "float":
                raise BindError(
                    "FLOAT storage columns are not supported yet — use "
                    "DECIMAL (the row codec is exact int64 lanes)")
            if c.primary_key:
                if c.type_name != "int":
                    raise BindError("PRIMARY KEY must be an INT column")
                if pk is not None:
                    raise BindError("multiple primary keys")
                pk = c.name
        cols = [(c.name, c.type_name) for c in ast.columns]
        cat.create(ast.name, cols, pk,
                   notnull=[c.name for c in ast.columns if c.not_null])
        return "ok", "CREATE TABLE", None

    def _drop(self, ast: P.DropTable):
        cat: SessionCatalog = self.catalog
        if ast.name not in cat._descs:
            if ast.if_exists:
                return "ok", "DROP TABLE", None
            raise BindError(f"no table {ast.name!r}")
        cat.drop(ast.name)
        return "ok", "DROP TABLE", None

    def _create_index(self, ast: P.CreateIndex):
        """CREATE INDEX: allocate the index keyspace, backfill it as a
        checkpointed job (server/jobs.py), then publish the index in the
        descriptor. Later DML maintains it synchronously (_index_ops)."""
        from cockroach_tpu_torch.server.jobs import Registry, States

        cat: SessionCatalog = self.catalog
        desc = cat.desc(ast.table)
        types = dict(desc.columns)
        if ast.column not in types:
            raise BindError(f"unknown column {ast.column!r}")
        if types[ast.column] != "int":
            raise BindError("only INT columns are indexable (composite "
                            "byte index keys arrive with the key codec)")
        if ast.column == desc.pk:
            raise BindError("the primary key already orders the table")
        if ast.column in desc.indexes:
            raise BindError(f"index on {ast.column!r} already exists")
        idx_id = cat._next_id()
        value_names = [c for c, _ in desc.value_columns()]
        ci = value_names.index(ast.column)
        store = cat.store

        def backfill(registry: Registry, rec):
            start_pk = int(rec.progress.get("start_pk", 0))
            ts = store.clock.now()
            chunk = 512
            while True:
                keys = store.engine.scan_keys(
                    struct.pack(">HQ", desc.table_id, start_pk),
                    struct.pack(">HQ", desc.table_id + 1, 0), ts,
                    max_rows=chunk)
                if not keys:
                    break
                for k in keys:
                    rid = struct.unpack(">HQ", k)[1]
                    hit = store.get(desc.table_id, rid, ts)
                    if hit is None:
                        continue
                    v = hit[0][ci]
                    store.put(idx_id, _index_pk(v, rid), [rid, v])
                start_pk = struct.unpack(">HQ", keys[-1])[1] + 1
                registry.checkpoint(rec.id, rec.lease_epoch,
                                    {"start_pk": start_pk})
                if len(keys) < chunk:
                    break

        reg = Registry(store)
        reg.register_resumer("index_backfill", backfill)
        job_id = reg.create("index_backfill", {
            "table": ast.table, "column": ast.column,
            "index_id": idx_id, "name": ast.name})
        reg.adopt_and_run()
        rec = reg.get(job_id)
        if rec.state != States.SUCCEEDED:
            raise BindError(f"index backfill failed: {rec.error}")
        desc.indexes[ast.column] = idx_id
        cat.save(desc)
        return "ok", "CREATE INDEX", None

    def _column_backfill(self, desc: TableDescriptor, kind: str,
                         phys_i: int, job_name: str):
        """Checkpointed row-rewrite job shared by ALTER TABLE ADD/DROP:
        ADD normalizes every row to the new physical layout (value slot
        + NULL bit); DROP scrubs the dead slot to NULL. Progress
        checkpoints by primary key; a crash mid-backfill resumes from the
        watermark."""
        from cockroach_tpu_torch.server.jobs import Registry, States
        from cockroach_tpu_torch.util.fault import maybe_fail

        cat: SessionCatalog = self.catalog
        store = cat.store
        n_phys = sum(1 for _ in desc.value_columns())

        def backfill(registry: Registry, rec):
            start_pk = int(rec.progress.get("start_pk", 0))
            ts = store.clock.now()
            chunk = 256
            while True:
                keys = store.engine.scan_keys(
                    struct.pack(">HQ", desc.table_id, start_pk),
                    struct.pack(">HQ", desc.table_id + 1, 0), ts,
                    max_rows=chunk)
                if not keys:
                    break
                maybe_fail("alter.backfill_chunk")
                for kk in keys:
                    rid = struct.unpack(">HQ", kk)[1]
                    hit = store.get(desc.table_id, rid)
                    if hit is None:
                        continue
                    fields = list(hit[0])
                    # split off the mask (absent on legacy rows)
                    if kind == "add":
                        old_n = n_phys - 1
                        vals = fields[:old_n]
                        mask = fields[old_n] if len(fields) > old_n \
                            else 0
                        vals += [0] * (old_n - len(vals))
                        vals.append(0)                 # the new slot
                        mask |= 1 << phys_i            # starts NULL
                    else:
                        vals = fields[:n_phys]
                        mask = fields[n_phys] if len(fields) > n_phys \
                            else 0
                        vals += [0] * (n_phys - len(vals))
                        vals[phys_i] = 0               # scrub
                        mask |= 1 << phys_i
                    store.put(desc.table_id, rid, vals + [mask])
                start_pk = struct.unpack(">HQ", keys[-1])[1] + 1
                registry.checkpoint(rec.id, rec.lease_epoch,
                                    {"start_pk": start_pk})
                if len(keys) < chunk:
                    break

        reg = Registry(store)
        reg.register_resumer(job_name, backfill)
        job_id = reg.create(job_name, {
            "table": desc.name, "kind": kind, "phys_i": phys_i})
        reg.adopt_and_run()
        rec = reg.get(job_id)
        if rec.state != States.SUCCEEDED:
            raise BindError(f"column backfill failed: {rec.error}")

    def _alter(self, ast: P.AlterTable):
        """ALTER TABLE ADD/DROP COLUMN: the column's PHYSICAL slot is
        allocated or retired in the descriptor, a checkpointed backfill
        rewrites the rows, and only then does ADD become public (reads
        during the backfill see the old schema)."""
        cat: SessionCatalog = self.catalog
        desc = cat.desc(ast.table)
        if any(t.startswith("vector(") for _, t in desc.columns):
            raise BindError("ALTER TABLE is not supported on tables "
                            "with VECTOR columns")
        if ast.op == "add" and ast.type_name.startswith("vector("):
            raise BindError("ALTER TABLE ADD of a VECTOR column is not "
                            "supported — declare it at CREATE TABLE")
        if ast.op == "add":
            if desc.backfilling == ast.column:
                # resume after a crashed backfill: rerun the job (row
                # rewrites are idempotent; checkpoints bound the redo)
                phys_i = [c for c, _ in desc.value_columns()].index(
                    ast.column)
                self._column_backfill(desc, "add", phys_i, "add_column")
                desc.backfilling = None
                cat.save(desc)
                return "ok", "ALTER TABLE", None
            if any(c == ast.column for c, _ in desc.columns):
                raise BindError(f"column {ast.column!r} already exists "
                                "(dropped slots keep their name)")
            if ast.type_name == "float":
                raise BindError("FLOAT storage columns are not "
                                "supported — use DECIMAL")
            desc.columns.append((ast.column, ast.type_name))
            if ast.type_name == "string":
                desc.dicts.setdefault(ast.column, [])
            desc.backfilling = ast.column
            cat.save(desc)
            phys_i = [c for c, _ in desc.value_columns()].index(
                ast.column)
            self._column_backfill(desc, "add", phys_i, "add_column")
            desc.backfilling = None
            cat.save(desc)
            return "ok", "ALTER TABLE", None
        # drop
        if not any(c == ast.column and desc.visible(c)
                   for c, _ in desc.columns):
            raise BindError(f"no column {ast.column!r}")
        if ast.column == desc.pk:
            raise BindError("cannot drop the PRIMARY KEY")
        if ast.column in desc.indexes:
            raise BindError(f"drop index on {ast.column!r} first")
        desc.dropped.append(ast.column)  # invisible immediately
        cat.save(desc)
        phys_i = [c for c, _ in desc.value_columns()].index(ast.column)
        self._column_backfill(desc, "drop", phys_i, "drop_column")
        return "ok", "ALTER TABLE", None

    def _index_ops(self, desc: TableDescriptor, txn, rowid: int,
                   old_fields, new_fields) -> None:
        """Synchronous secondary-index maintenance for one row mutation
        (old_fields/new_fields = value-field lists or None)."""
        if not desc.indexes:
            return
        value_names = [c for c, _ in desc.value_columns()]
        for col, idx_id in desc.indexes.items():
            i = value_names.index(col)
            # NULL values have no index entry (field_value -> None)
            old_v = (desc.field_value(old_fields, i)
                     if old_fields is not None else None)
            new_v = (desc.field_value(new_fields, i)
                     if new_fields is not None else None)
            if old_v == new_v:
                continue
            if old_v is not None:
                txn.delete(idx_id, _index_pk(int(old_v), rowid))
            if new_v is not None:
                txn.put(idx_id, _index_pk(int(new_v), rowid),
                        [rowid, int(new_v)])

    # -------------------------------------------------------------- DML --

    def _encode_value(self, desc: TableDescriptor, cname: str,
                      tname: str, v):
        ty = _type_of(tname)
        if v is None:
            if not desc.nullable(cname):
                raise BindError(
                    f"null value in column {cname!r} violates "
                    f"not-null constraint")
            if ty.kind is Kind.VECTOR:
                return [0] * ty.dim
            return 0  # the caller sets the row's NULL-bitmap bit
        if ty.kind is Kind.VECTOR:
            if isinstance(v, str):
                try:
                    v = _parse_vector_literal(v)
                except ValueError as err:
                    raise BindError(f"bad vector literal: {err}")
            arr = np.asarray(v, dtype=np.float32)
            if arr.shape != (ty.dim,):
                raise BindError(
                    f"column {cname!r} expects a {ty.dim}-dim vector, "
                    f"got shape {arr.shape}")
            return [int(x) for x in arr.view(np.uint32)]
        if ty.kind is Kind.DECIMAL:
            return int(Decimal(str(v)).scaleb(ty.scale)
                       .to_integral_value(ROUND_HALF_UP))
        if ty.kind is Kind.STRING:
            d = desc.dicts[cname]
            s = str(v)
            if s in d:
                return d.index(s)
            d.append(s)  # grow the dictionary (persisted with the desc)
            return len(d) - 1
        if ty.kind is Kind.DATE and isinstance(v, str):
            dt = datetime.date.fromisoformat(v)
            return (dt - datetime.date(1970, 1, 1)).days
        return int(v)

    def _literal(self, node: P.Node):
        if isinstance(node, P.Num):
            return node.value
        if isinstance(node, P.Str):
            return node.value
        if isinstance(node, P.DateLit):
            return node.days
        if isinstance(node, P.NullLit):
            return None
        if isinstance(node, P.BoolLit):
            return node.value
        if isinstance(node, P.Unary) and node.op == "-":
            inner = self._literal(node.arg)
            return -inner
        raise BindError("INSERT VALUES must be literals")

    def _encode_row(self, desc: TableDescriptor, vals: Dict[str, object]
                    ) -> List[int]:
        """The stored fields of one row: every value column's slots, then
        the NULL bitmap."""
        fields: List[int] = []
        mask = 0
        for i, (c, t) in enumerate(desc.value_columns()):
            ev = self._encode_value(desc, c, t, vals[c])
            # VECTOR columns encode to d slots
            fields.extend(ev if isinstance(ev, list) else [ev])
            if vals[c] is None:
                mask |= 1 << i
        fields.append(mask)
        return fields

    def _insert(self, ast: P.Insert):
        cat: SessionCatalog = self.catalog
        desc = cat.desc(ast.table)
        col_names = [c for c, _ in desc.visible_columns()]
        target = ast.columns or col_names
        unknown = set(target) - set(col_names)
        if unknown:
            raise BindError(f"unknown columns {sorted(unknown)}")
        missing = set(c for c, _ in desc.visible_columns()
                      if c != desc.pk) - set(target)
        if desc.pk is not None and desc.pk not in target:
            raise BindError(f"missing PRIMARY KEY {desc.pk!r}")
        not_nullable = [c for c in missing if not desc.nullable(c)]
        if not_nullable:
            raise BindError(f"INSERT missing NOT NULL columns "
                            f"{sorted(not_nullable)}")
        n = 0
        new_rows = 0

        def op(txn):
            nonlocal n, new_rows
            n = new_rows = 0
            for row in ast.rows:
                if len(row) != len(target):
                    raise BindError("VALUES arity mismatch")
                vals = {c: self._literal(v) for c, v in zip(target, row)}
                for c, _t in desc.value_columns():
                    # unnamed nullable + dropped/backfilling slots: NULL
                    vals.setdefault(c, None)
                old = None
                if desc.pk is not None:
                    rowid = int(vals[desc.pk])
                    old = txn.get(desc.table_id, rowid)
                    new_row = old is None
                    if not new_row and not ast.upsert:
                        raise BindError(
                            f"duplicate key value violates unique "
                            f"constraint ({desc.pk}={rowid})")
                else:
                    rowid = desc.next_rowid
                    desc.next_rowid += 1
                    new_row = True
                fields = self._encode_row(desc, vals)
                txn.put(desc.table_id, rowid, fields)
                self._index_ops(desc, txn, rowid, old, fields)
                n += 1
                new_rows += int(new_row)

        self._run_dml(op)
        self._bump_rows(cat, desc, new_rows)
        return "ok", f"INSERT {n}", None

    def _scan_rows(self, desc: TableDescriptor, txn):
        """-> [(rowid, {col: datum})] decoded for predicate evaluation,
        every row walked on the host through the transaction (its own
        buffered rows included)."""
        from cockroach_tpu_torch.exec.rowexec import _decode

        schema = desc.schema()
        out = []
        pks = sorted(set(txn.scan_pks(desc.table_id))
                     | set(txn.buffered_pks(desc.table_id)))
        n_slots = desc.value_slots()
        for rowid in pks:
            fields = txn.get(desc.table_id, rowid)
            if fields is None:
                continue
            mask = fields[n_slots] if len(fields) > n_slots else 0
            row: Dict[str, object] = {}
            vi = 0   # value-column index (NULL bitmap bit)
            off = 0  # physical slot offset
            for cname, tname in desc.columns:
                ty = _type_of(tname)
                if cname == desc.pk:
                    row[cname] = rowid
                    continue
                s = _slots_of(tname)
                null = ((mask >> vi) & 1) == 1 or off >= len(fields)
                raw = None if null else fields[off:off + s]
                vi += 1
                off += s
                if not desc.visible(cname):
                    continue
                if raw is None:
                    row[cname] = None
                    continue
                if ty.kind is Kind.VECTOR:
                    row[cname] = _slots_to_f32(
                        np.asarray([raw], dtype=np.int64))[0]
                    continue
                row[cname] = _decode(
                    np.asarray([raw[0]]), None, ty,
                    schema.dictionary(cname))[0]
            out.append((rowid, row))
        return out

    def _bind_predicates(self, desc: TableDescriptor, where, sets=()):
        """The WHERE clause and SET expressions bound over one table."""
        from cockroach_tpu_torch.sql.bind import Binder

        binder = Binder(self.catalog)
        schema = desc.schema()
        binder._schemas = {desc.name: schema}
        binder._col_to_rel = {n: desc.name for n in schema.names()}
        binder._global = schema
        bound_where = (binder._bind_scalar(where)[0]
                       if where is not None else None)
        return schema, bound_where, [(c, binder._bind_scalar(e)[0])
                                     for c, e in sets]

    def _update(self, ast: P.Update):
        from cockroach_tpu_torch.exec.rowexec import eval_datum

        cat: SessionCatalog = self.catalog
        desc = cat.desc(ast.table)
        types = dict(desc.visible_columns())
        for col, _ in ast.sets:
            if col not in types:
                raise BindError(f"unknown column {col!r}")
            if col == desc.pk:
                raise BindError("cannot UPDATE the primary key")
        schema, where, sets = self._bind_predicates(desc, ast.where,
                                                    ast.sets)
        n = 0

        def op(txn):
            nonlocal n
            n = 0
            for rowid, row in self._scan_rows(desc, txn):
                if where is not None and \
                        eval_datum(where, row, schema) is not True:
                    continue
                new = dict(row)
                for c, e in sets:
                    new[c] = eval_datum(e, row, schema)
                for c, _t in desc.value_columns():
                    new.setdefault(c, None)  # dropped/backfilling slots
                old_fields = txn.get(desc.table_id, rowid)
                fields = self._encode_row(desc, new)
                txn.put(desc.table_id, rowid, fields)
                self._index_ops(desc, txn, rowid, old_fields, fields)
                n += 1

        self._run_dml(op)
        cat.save(desc)
        return "ok", f"UPDATE {n}", None

    def _delete(self, ast: P.Delete):
        from cockroach_tpu_torch.exec.rowexec import eval_datum

        cat: SessionCatalog = self.catalog
        desc = cat.desc(ast.table)
        schema, where, _ = self._bind_predicates(desc, ast.where)
        n = 0

        def op(txn):
            nonlocal n
            n = 0
            for rowid, row in self._scan_rows(desc, txn):
                if where is not None and \
                        eval_datum(where, row, schema) is not True:
                    continue
                old_fields = txn.get(desc.table_id, rowid)
                txn.delete(desc.table_id, rowid)
                self._index_ops(desc, txn, rowid, old_fields, None)
                n += 1

        self._run_dml(op)
        self._bump_rows(cat, desc, -n)
        return "ok", f"DELETE {n}", None
