"""ctypes binding for the native C++ MVCC engine (native/mvcc_engine.cpp).

Counterpart of cockroach_tpu/storage/engine.py, host-only (numpy and the
stdlib), with the same classes, byte formats and semantics. The C++
source is a byte-for-byte copy of the JAX package's. Departures: the
engine builds at first use with `g++ -O2 -std=c++17 -shared -fPIC`
into build/torch_native/mvcc_engine-<sha256[:16]>.so under the repo
root, never next to its source (a per-process `.tmp` then `os.replace`,
so that processes building at once never load a half-written library);
and `NativeEngine.export_span_buffer` hands over export_span's records
as one bytes object, which the resident tier parses with numpy.

The reference's storage layer is Pebble (Go LSM) under MVCC semantics in
pkg/storage. A pure-Python `PyEngine` with identical semantics backs
environments without a toolchain and serves as the differential-testing
model (the kvnemesis posture: two implementations, one history —
pkg/kv/kvnemesis/validator.go:49).
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cockroach_tpu_torch.util.fault import DurableFile, crash_point
from cockroach_tpu_torch.util.hlc import Timestamp

_SRC = os.path.join(os.path.dirname(__file__), "native", "mvcc_engine.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "torch_native")

_lib = None
_lib_err: Optional[str] = None
_lib_lock = threading.Lock()


def _build_lib() -> Optional[str]:
    """Compile (or reuse) the shared library; returns its path or None."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"mvcc_engine-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    # one temporary name per process: workers that build at once each
    # write their own and the last rename wins with a whole library
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return so_path
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _load():
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        path = _build_lib()
        if path is None:
            _lib_err = "g++ unavailable or compile failed"
            return None
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.eng_open.restype = ctypes.c_void_p
        lib.eng_close.argtypes = [ctypes.c_void_p]
        lib.eng_set_flush_threshold.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint64]
        lib.eng_put.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int32,
                                ctypes.c_uint64, ctypes.c_uint32, u8p,
                                ctypes.c_int32]
        lib.eng_get.restype = ctypes.c_int64
        lib.eng_get.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int32,
                                ctypes.c_uint64, ctypes.c_uint32, u8p,
                                ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_uint32)]
        lib.eng_scan_to_cols.restype = ctypes.c_int64
        lib.eng_scan_to_cols.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int32, u8p, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, u8p,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64)]
        lib.eng_scan_keys.restype = ctypes.c_int64
        lib.eng_scan_keys.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int32, u8p, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint32, u8p, ctypes.c_int64,
            ctypes.c_int64]
        lib.eng_flush.argtypes = [ctypes.c_void_p]
        lib.eng_stats.restype = ctypes.c_uint64
        lib.eng_stats.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.eng_open_at.restype = ctypes.c_void_p
        lib.eng_open_at.argtypes = [u8p, ctypes.c_int32]
        lib.eng_sync.argtypes = [ctypes.c_void_p]
        lib.eng_ingest.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64,
            ctypes.c_uint32]
        lib.eng_export_span.restype = ctypes.c_int64
        lib.eng_export_span.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int32, u8p, ctypes.c_int32,
            u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.eng_clear_span.argtypes = [ctypes.c_void_p, u8p,
                                       ctypes.c_int32, u8p,
                                       ctypes.c_int32]
        lib.eng_ingest_span.argtypes = [ctypes.c_void_p, u8p,
                                        ctypes.c_int64]
        _lib = lib
        return _lib


def _u8(b: bytes):
    return (ctypes.c_uint8 * len(b)).from_buffer_copy(b) if b else None


# ---- CRC32C (Castagnoli) + the shared durable record format --------------
# Byte-identical to the C++ engine's WAL/run checksum (poly 0x82F63B78,
# reflected; crc32c(b"123456789") == 0xE3069283) so both engines' durable
# files verify the same way and the chaos harness can audit either.

def _crc32c_table() -> List[int]:
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab.append(c)
    return tab


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    tab = _CRC_TABLE
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# Durable record, identical across both engines' WAL and snapshot files:
#   u32 crc32c | u32 klen | u32 vlen | u64 wall | u32 logical | key | value
# where the crc covers everything after the crc field. A record that fails
# its checksum or reads short is a torn tail: recovery keeps the verified
# prefix and truncates — never a fatal parse error.
_REC_BODY_HDR = struct.Struct("<IIQI")   # klen, vlen, wall, logical
_REC_CRC = struct.Struct("<I")


def pack_record(key: bytes, ts: Timestamp, value: bytes) -> bytes:
    body = _REC_BODY_HDR.pack(len(key), len(value), ts.wall,
                              ts.logical) + key + value
    return _REC_CRC.pack(crc32c(body)) + body


def iter_records(buf: bytes, stats: Optional[Dict[str, int]] = None):
    """Yield (key, ts, value, end_offset) for each VERIFIED record in
    `buf`; stops (without raising) at the first torn or corrupt record.
    The final yield's end_offset is the last trustworthy byte — callers
    truncate the file there. `stats` (optional) gets "crc_failures"
    bumped when the stop was a checksum mismatch rather than a plain
    short tail."""
    off = 0
    n = len(buf)
    while off + 24 <= n:
        (crc,) = _REC_CRC.unpack_from(buf, off)
        klen, vlen, wall, logical = _REC_BODY_HDR.unpack_from(buf, off + 4)
        if klen > (1 << 20) or vlen > (1 << 28):
            return  # implausible header: corrupt tail
        end = off + 24 + klen + vlen
        if end > n:
            return  # short body: torn write
        if crc32c(buf[off + 4:end]) != crc:
            if stats is not None:
                stats["crc_failures"] = stats.get("crc_failures", 0) + 1
            return  # checksum mismatch: stop at the last good record
        key = buf[off + 24:off + 24 + klen]
        value = buf[off + 24 + klen:end]
        yield key, Timestamp(wall, logical), value, end
        off = end


class ScanResult:
    def __init__(self, cols: np.ndarray, rows: int, more: bool,
                 resume_key: Optional[bytes]):
        self.cols = cols          # (ncols, rows) int64, column-major
        self.rows = rows
        self.more = more
        self.resume_key = resume_key


def engine_fingerprint(engine, ts: Optional[Timestamp] = None,
                       start: bytes = b"", end: bytes = b"") -> int:
    """CRC32C over every MVCC version in [start, end) with version-ts <=
    `ts` (None = all), key-ascending / newest-first — tombstones included.
    Two engines agree iff their visible history is bit-identical: the
    post-crash-recovery verification primitive, shared by both engine
    classes (export_span has identical ordering contracts)."""
    fp = 0
    for key, vts, val in engine.export_span(start, end):
        if ts is not None and not (
                vts.wall < ts.wall
                or (vts.wall == ts.wall and vts.logical <= ts.logical)):
            continue
        fp = crc32c(
            _REC_BODY_HDR.pack(len(key), len(val), vts.wall, vts.logical)
            + key + val, fp)
    return fp


class TableVersions:
    """Per-table write-version counters, mixed into both engines: every
    put/delete/ingest bumps the written table's version, giving upper
    layers (the cross-query scan-image cache, exec/scan_cache.py) a cheap
    content-identity token — a cached device image keyed on the version
    can never serve a post-write read. Table ids decode from the first two
    key bytes (the >HQ keyspace layout, storage/mvcc.py encode_key)."""

    _table_versions: Dict[int, int]

    def _init_versions(self) -> None:
        self._table_versions = {}

    def _bump_key(self, key: bytes) -> None:
        if len(key) >= 2:
            tid = (key[0] << 8) | key[1]
            self._table_versions[tid] = self._table_versions.get(tid, 0) + 1

    def _bump_table(self, table_id: int) -> None:
        self._table_versions[table_id] = \
            self._table_versions.get(table_id, 0) + 1

    def _bump_span(self, start: bytes, end: bytes) -> None:
        """A span mutation (clear_span) may touch every table the span
        covers: bump the boundary table plus every known table id in
        the covered id range."""
        if len(start) < 2:
            return
        lo = (start[0] << 8) | start[1]
        hi = ((end[0] << 8) | end[1]) if len(end) >= 2 else lo
        for tid in [t for t in self._table_versions if lo <= t <= hi]:
            self._bump_table(tid)
        self._bump_table(lo)

    def table_version(self, table_id: int) -> int:
        return self._table_versions.get(int(table_id), 0)


class NativeEngine(TableVersions):
    """The C++ engine. All methods take/return host types; the scan path
    returns numpy column blocks ready for ScanOp ingest."""

    def __init__(self, flush_threshold: Optional[int] = None,
                 path: Optional[str] = None):
        self._init_versions()
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native engine unavailable: {_lib_err}")
        self._lib = lib
        if path:
            pb = path.encode()
            self._h = ctypes.c_void_p(lib.eng_open_at(_u8(pb), len(pb)))
            if not self._h:
                raise RuntimeError(f"cannot open engine at {path!r}")
        else:
            self._h = ctypes.c_void_p(lib.eng_open())
        # ctypes releases the GIL around calls; the C++ engine is single-
        # writer, so all entry points serialize here (the Pebble-batch
        # commit mutex analog). Fine-grained locking arrives with M7.
        self._mu = threading.Lock()
        if flush_threshold is not None:
            lib.eng_set_flush_threshold(self._h, flush_threshold)

    def close(self):
        with self._mu:
            if self._h:
                self._lib.eng_close(self._h)
                self._h = None

    def sync(self) -> None:
        """fsync the WAL: everything written so far survives kill -9
        (durable engines only; no-op for in-memory)."""
        crash_point("wal.sync")
        with self._mu:
            self._lib.eng_sync(self._h)

    def ingest(self, table_id: int, pks: np.ndarray,
               cols: Sequence[np.ndarray], ts: Timestamp) -> None:
        """Bulk-load one sorted run of fixed-width rows (the AddSSTable
        analog): ~100x faster than per-row put for table loads, and
        written straight to a durable run file when the engine has a
        directory."""
        n = len(pks)
        if n == 0:
            return
        self._bump_table(table_id)
        pks64 = np.ascontiguousarray(pks, dtype=np.int64)
        mat = np.ascontiguousarray(
            np.stack([np.asarray(c, dtype=np.int64) for c in cols])
            if cols else np.zeros((0, n), np.int64))
        i64p = ctypes.POINTER(ctypes.c_int64)
        with self._mu:
            self._lib.eng_ingest(
                self._h, table_id, n,
                pks64.ctypes.data_as(i64p), len(cols),
                mat.ctypes.data_as(i64p), ts.wall, ts.logical)

    # ---- range-snapshot seam (replication snapshots, kv/kvserver.py):
    # export_span/clear_span/ingest_span move ALL MVCC versions of a
    # keyspan (tombstones included) between engines — the interface a
    # Replica snapshots through, identical on both engine classes.

    def export_span_buffer(self, start: bytes, end: bytes) -> bytes:
        """export_span's records as the engine writes them: per version
        u32 klen | u32 vlen | u64 wall | u32 logical | key | value, in
        export_span's order (the resident tier parses it with numpy)."""
        cap = 1 << 20
        while True:
            out = (ctypes.c_uint8 * cap)()
            nrec = ctypes.c_int64()
            with self._mu:
                need = self._lib.eng_export_span(
                    self._h, _u8(start), len(start), _u8(end), len(end),
                    out, cap, ctypes.byref(nrec))
            if need <= cap:
                break
            cap = int(need)  # buffer too small: retry full-size
        return memoryview(out).cast("B")[:need].tobytes()

    def export_span(self, start: bytes, end: bytes
                    ) -> List[Tuple[bytes, Timestamp, bytes]]:
        """Every version of every key in [start, end), key-ascending and
        newest-first per key, as (key, ts, value) with b"" tombstones."""
        import struct as _struct

        buf = self.export_span_buffer(start, end)
        entries: List[Tuple[bytes, Timestamp, bytes]] = []
        off = 0
        while off + 20 <= len(buf):
            klen, vlen, wall, logical = _struct.unpack_from(
                "<IIQI", buf, off)
            key = buf[off + 20:off + 20 + klen]
            val = buf[off + 20 + klen:off + 20 + klen + vlen]
            entries.append((key, Timestamp(wall, logical), val))
            off += 20 + klen + vlen
        return entries

    def clear_span(self, start: bytes, end: bytes) -> None:
        """Drop every version of every key in [start, end)."""
        self._bump_span(start, end)
        with self._mu:
            self._lib.eng_clear_span(self._h, _u8(start), len(start),
                                     _u8(end), len(end))

    def ingest_span(self, entries) -> None:
        """Bulk-add (key, ts, value) versions (export_span's output) as
        one ingested run — the snapshot-application write path."""
        import struct as _struct

        parts: List[bytes] = []
        tids = set()
        for key, ts, val in entries:
            parts.append(_struct.pack("<IIQI", len(key), len(val),
                                      ts.wall, ts.logical))
            parts.append(key)
            parts.append(val)
            if len(key) >= 2:
                tids.add((key[0] << 8) | key[1])
        if not parts:
            return
        for tid in tids:
            self._bump_table(tid)
        buf = b"".join(parts)
        with self._mu:
            self._lib.eng_ingest_span(self._h, _u8(buf), len(buf))

    def put(self, key: bytes, ts: Timestamp, value: bytes) -> None:
        crash_point("wal.append")
        self._bump_key(key)
        with self._mu:
            self._lib.eng_put(self._h, _u8(key), len(key), ts.wall,
                              ts.logical, _u8(value), len(value))

    def delete(self, key: bytes, ts: Timestamp) -> None:
        self.put(key, ts, b"")  # tombstone

    def get(self, key: bytes, ts: Timestamp
            ) -> Optional[Tuple[bytes, Timestamp]]:
        cap = 1 << 16
        while True:
            out = (ctypes.c_uint8 * cap)()
            vw = ctypes.c_uint64()
            vl = ctypes.c_uint32()
            with self._mu:
                n = self._lib.eng_get(self._h, _u8(key), len(key), ts.wall,
                                      ts.logical, out, cap,
                                      ctypes.byref(vw), ctypes.byref(vl))
            if n < 0:
                return None
            if n <= cap:
                return bytes(out[:n]), Timestamp(vw.value, vl.value)
            cap = int(n)  # value larger than the buffer: retry full-size

    def scan_to_cols(self, start: bytes, end: bytes, ts: Timestamp,
                     ncols: int, max_rows: int,
                     with_pks: bool = False) -> ScanResult:
        out = np.zeros((ncols, max_rows), dtype=np.int64)
        pks = np.zeros(max_rows, dtype=np.int64) if with_pks else None
        rk = (ctypes.c_uint8 * 4096)()
        rlen = ctypes.c_int32()
        more = ctypes.c_int32()
        with self._mu:
            rows = self._lib.eng_scan_to_cols(
                self._h, _u8(start), len(start), _u8(end), len(end),
                ts.wall, ts.logical, ncols,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                max_rows, rk, 4096, ctypes.byref(rlen),
                ctypes.byref(more),
                pks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                if pks is not None else None)
        resume = bytes(rk[:rlen.value]) if more.value else None
        res = ScanResult(out[:, :rows], int(rows), bool(more.value),
                         resume)
        if with_pks:
            res.pks = pks[:rows]
        return res

    def scan_keys(self, start: bytes, end: bytes, ts: Timestamp,
                  max_rows: int = 1 << 20) -> List[bytes]:
        cap = 1 << 22
        out = (ctypes.c_uint8 * cap)()
        with self._mu:
            rows = self._lib.eng_scan_keys(
                self._h, _u8(start), len(start), _u8(end), len(end),
                ts.wall, ts.logical, out, cap, max_rows)
        keys = []
        off = 0
        buf = bytes(out)
        for _ in range(rows):
            n = buf[off] | (buf[off + 1] << 8)
            keys.append(buf[off + 2:off + 2 + n])
            off += 2 + n
        return keys

    def flush(self) -> None:
        crash_point("engine.flush")
        with self._mu:
            self._lib.eng_flush(self._h)

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {
                "entries": int(self._lib.eng_stats(self._h, 0)),
                "runs": int(self._lib.eng_stats(self._h, 1)),
                "mem_bytes": int(self._lib.eng_stats(self._h, 2)),
                "puts": int(self._lib.eng_stats(self._h, 3)),
                # recovery forensics from the last open (0 when clean)
                "wal_replayed": int(self._lib.eng_stats(self._h, 4)),
                "torn_bytes": int(self._lib.eng_stats(self._h, 5)),
                "crc_failures": int(self._lib.eng_stats(self._h, 6)),
            }

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PyEngine(TableVersions):
    """Pure-Python model with the same semantics (differential oracle).

    Optionally DURABLE: opened with `path=`, every put appends a
    checksummed record (the shared format above) to a write-ahead log
    through the crash-point shim (`util/fault.DurableFile`), `sync()`
    fsyncs it, and `flush()` folds all versions into an atomically
    replaced snapshot file (tmp+rename, tracked by a MANIFEST) and
    truncates the WAL. Reopening replays snapshot + WAL tail; a torn or
    corrupt WAL tail is detected by CRC and truncated at the last good
    record — the same recovery contract as the C++ engine, so the chaos
    nemesis drives both identically."""

    def __init__(self, flush_threshold: Optional[int] = None,
                 path: Optional[str] = None):
        self._init_versions()
        # versions[key] = sorted list of (packed_desc_ts, ts, value)
        self._versions: Dict[bytes, List[Tuple[int, Timestamp, bytes]]] = {}
        self._keys: List[bytes] = []
        self._path = path
        self._wal: Optional[DurableFile] = None
        self._recovery = {"wal_replayed": 0, "torn_bytes": 0,
                          "crc_failures": 0}
        if path:
            os.makedirs(path, exist_ok=True)
            self._recover()
            self._wal = DurableFile(os.path.join(path, "wal.log"),
                                    point="wal")

    # ---- durability ----

    def _recover(self) -> None:
        """Load snapshot (if the MANIFEST names one) then replay the WAL
        tail, truncating at the first unverifiable record."""
        assert self._path is not None
        manifest = os.path.join(self._path, "MANIFEST")
        if os.path.exists(manifest):
            with open(manifest, "r") as f:
                snap_name = f.readline().strip()
            if snap_name:
                snap = os.path.join(self._path, snap_name)
                if os.path.exists(snap):
                    with open(snap, "rb") as f:
                        buf = f.read()
                    for key, ts, val, _end in iter_records(
                            buf, self._recovery):
                        self._apply_put(key, ts, val)
        wal_path = os.path.join(self._path, "wal.log")
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                buf = f.read()
            good_end = 0
            for key, ts, val, end in iter_records(buf, self._recovery):
                self._apply_put(key, ts, val)
                self._recovery["wal_replayed"] += 1
                good_end = end
            if good_end < len(buf):
                self._recovery["torn_bytes"] += len(buf) - good_end
                with open(wal_path, "r+b") as f:
                    f.truncate(good_end)
                    f.flush()
                    os.fsync(f.fileno())

    def _write_atomic(self, name: str, data: bytes) -> None:
        """tmp + fsync + rename: the file either has its old content or
        the complete new content, never a partial write."""
        assert self._path is not None
        final = os.path.join(self._path, name)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def close(self):
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    @staticmethod
    def _desc(ts: Timestamp) -> int:
        return -ts.pack()

    def _apply_put(self, key: bytes, ts: Timestamp, value: bytes) -> None:
        """In-memory apply only (replay path + the tail of put())."""
        self._bump_key(key)
        vs = self._versions.get(key)
        if vs is None:
            vs = self._versions[key] = []
            bisect.insort(self._keys, key)
        ent = (self._desc(ts), ts, value)
        i = bisect.bisect_left(vs, (ent[0],), key=lambda e: (e[0],))
        if i < len(vs) and vs[i][0] == ent[0]:
            vs[i] = ent
        else:
            vs.insert(i, ent)

    def put(self, key: bytes, ts: Timestamp, value: bytes) -> None:
        if self._wal is not None:
            # write-ahead: the record reaches the log (and its crash
            # points) before the in-memory state changes
            self._wal.append(pack_record(key, ts, value))
        else:
            crash_point("wal.append")  # ephemeral engines still crash
        self._apply_put(key, ts, value)

    def delete(self, key: bytes, ts: Timestamp) -> None:
        self.put(key, ts, b"")

    # ---- range-snapshot seam (same contract as NativeEngine) ----

    def export_span(self, start: bytes, end: bytes
                    ) -> List[Tuple[bytes, Timestamp, bytes]]:
        """Every version of every key in [start, end), key-ascending and
        newest-first per key, as (key, ts, value) with b"" tombstones."""
        lo = bisect.bisect_left(self._keys, start)
        out: List[Tuple[bytes, Timestamp, bytes]] = []
        for k in self._keys[lo:]:
            if end and k >= end:
                break
            for _d, ts, val in self._versions[k]:
                out.append((k, ts, val))
        return out

    def clear_span(self, start: bytes, end: bytes) -> None:
        """Drop every version of every key in [start, end). Durable
        engines immediately fold the filtered picture into a fresh
        snapshot (+WAL truncate) so a reopen cannot resurrect cleared
        keys — same contract as the C++ engine's clear_span."""
        self._bump_span(start, end)
        lo = bisect.bisect_left(self._keys, start)
        hi = (bisect.bisect_left(self._keys, end) if end
              else len(self._keys))
        for k in self._keys[lo:hi]:
            del self._versions[k]
        del self._keys[lo:hi]
        if self._path is not None:
            self.flush()

    def ingest_span(self, entries) -> None:
        """Bulk-add (key, ts, value) versions (export_span's output)."""
        for k, ts, val in entries:
            self.put(k, ts, val)

    def _visible(self, key: bytes, ts: Timestamp
                 ) -> Optional[Tuple[bytes, Timestamp]]:
        vs = self._versions.get(key)
        if not vs:
            return None
        i = bisect.bisect_left(vs, (self._desc(ts),), key=lambda e: (e[0],))
        if i >= len(vs):
            return None
        _, vts, val = vs[i]
        if val == b"":
            return None
        return val, vts

    def get(self, key: bytes, ts: Timestamp
            ) -> Optional[Tuple[bytes, Timestamp]]:
        return self._visible(key, ts)

    def scan_to_cols(self, start: bytes, end: bytes, ts: Timestamp,
                     ncols: int, max_rows: int,
                     with_pks: bool = False) -> ScanResult:
        lo = bisect.bisect_left(self._keys, start)
        rows: List[np.ndarray] = []
        pks: List[int] = []
        more = False
        resume = None
        i = lo
        while i < len(self._keys):
            k = self._keys[i]
            if end and k >= end:
                break
            vis = self._visible(k, ts)
            i += 1
            if vis is None:
                continue
            if len(rows) >= max_rows:
                more, resume = True, k
                break
            val = vis[0]
            fields = np.zeros(ncols, dtype=np.int64)
            usable = min(ncols, len(val) // 8)
            if usable:
                fields[:usable] = np.frombuffer(
                    val[:usable * 8], dtype="<i8")
            rows.append(fields)
            if with_pks:
                pks.append(int.from_bytes(k[2:10], "big")
                           if len(k) >= 10 else 0)
        cols = (np.stack(rows, axis=1) if rows
                else np.zeros((ncols, 0), dtype=np.int64))
        res = ScanResult(cols, len(rows), more, resume)
        if with_pks:
            res.pks = np.asarray(pks, dtype=np.int64)
        return res

    def scan_keys(self, start: bytes, end: bytes, ts: Timestamp,
                  max_rows: int = 1 << 20) -> List[bytes]:
        lo = bisect.bisect_left(self._keys, start)
        out = []
        for k in self._keys[lo:]:
            if end and k >= end:
                break
            if self._visible(k, ts) is not None:
                out.append(k)
                if len(out) >= max_rows:
                    break
        return out

    def sync(self) -> None:
        """fsync the WAL: everything put() so far survives kill -9
        (durable engines only; crash seam still counted when ephemeral)."""
        if self._wal is not None:
            self._wal.sync()
        else:
            crash_point("wal.sync")

    def ingest(self, table_id: int, pks, cols, ts: Timestamp) -> None:
        """Model-engine bulk load: semantics of NativeEngine.ingest via
        per-row puts (the model is the differential oracle, not fast)."""
        import struct as _struct

        mat = [np.asarray(c, dtype=np.int64) for c in cols]
        for i, pk in enumerate(np.asarray(pks, dtype=np.int64)):
            key = _struct.pack(">HQ", table_id, int(pk) & (2**64 - 1))
            val = b"".join(
                int(mat[c][i]).to_bytes(8, "little", signed=True)
                for c in range(len(mat)))
            self.put(key, ts, val)

    def flush(self) -> None:
        """Durable engines fold every version into an atomically replaced
        snapshot (tmp+rename), point the MANIFEST at it, then truncate
        the WAL — the snapshot now carries everything the log did. A
        crash anywhere in the sequence leaves either the old
        snapshot+full WAL or the new snapshot (+WAL whose records are
        shadowed duplicates): never a state that loses a synced write."""
        crash_point("engine.flush")
        if self._path is None:
            return
        parts = []
        count = 0
        for k in self._keys:
            for _d, ts, val in self._versions[k]:
                parts.append(pack_record(k, ts, val))
                count += 1
        self._write_atomic("snapshot.dat", b"".join(parts))
        self._write_atomic("MANIFEST", b"snapshot.dat\n")
        if self._wal is not None:
            self._wal.truncate(0)

    def gc(self, start: bytes, end: bytes, threshold: Timestamp) -> int:
        """MVCC garbage collection (reference: the mvcc GC queue +
        storage GC semantics): for each key in [start, end) drop
        versions strictly older than the newest version at/below
        `threshold` — reads at ts >= threshold are unaffected; history
        below it is gone. If that newest covered version is a tombstone
        it goes too (a fully-deleted key vanishes). Returns versions
        removed."""
        lo = bisect.bisect_left(self._keys, start)
        removed = 0
        dead_keys = []
        for k in self._keys[lo:]:
            if end and k >= end:
                break
            vs = self._versions[k]
            # vs is newest-first; find the newest version <= threshold
            i = bisect.bisect_left(vs, (self._desc(threshold),),
                                   key=lambda e: (e[0],))
            if i >= len(vs):
                continue
            keep_to = i if vs[i][2] == b"" else i + 1
            removed += len(vs) - keep_to
            del vs[keep_to:]
            if not vs:
                dead_keys.append(k)
        for k in dead_keys:
            del self._versions[k]
            j = bisect.bisect_left(self._keys, k)
            del self._keys[j]
        if removed and self._path is not None:
            self.flush()  # persist the pruned history
        return removed

    def stats(self) -> Dict[str, int]:
        n = sum(len(v) for v in self._versions.values())
        return {"entries": n, "runs": 0, "mem_bytes": 0, "puts": n,
                **self._recovery}

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_engine(prefer_native: bool = True, **kw):
    """NativeEngine when the toolchain allows, else the Python model."""
    if prefer_native and _load() is not None:
        return NativeEngine(**kw)
    return PyEngine(**kw)
