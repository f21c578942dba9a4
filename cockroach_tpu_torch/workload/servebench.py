"""Concurrent serving benchmark + the shared harness pieces behind it.

Counterpart of cockroach_tpu/workload/servebench.py (`WireClient`,
`send_cancel`, `load_serving_catalog`, `execute_pool`, `query_pool`,
`percentiles`, `run`, `compare`), with its tables, pools and report
keys: a minimal pgwire client, the three-table serving catalog (YCSB-ish
kv, a lineitem-shaped table for TPC-H trickle aggregates, a small vector
table), the fixed read-query pool whose answers are insert-independent,
and `run()` — N wire-client threads hammering the pool with cross-session
continuous batching (sql/serving.py) on or off.

`compare()` runs both modes back to back and reports the
batched-vs-unbatched speedup. Every read is verified bit-exact against a
serial reference over the same wire path, so a throughput win can never
hide a correctness regression. The server and its sessions run on
`device` (CUDA unless the caller passes one).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, List, Tuple

KV_ROWS = 512           # preloaded YCSB keyspace; reads stay below this
LI_ROWS = 480           # TPC-H-trickle lineitem-shaped table
EMB_ROWS = 64           # vector table
INSERT_BASE = 1_000_000  # concurrent inserts land here, ABOVE all reads


class WireClient:
    """Minimal pgwire client (simple protocol) for the concurrent
    harnesses: captures the BackendKeyData cancel key at startup and
    reports statement errors as (rows, sqlstate) instead of raising —
    callers classify 57014/53300/57P01 as expected chaos."""

    def __init__(self, addr, timeout: float = 120.0):
        self.s = socket.create_connection(addr, timeout=timeout)
        try:
            # mirror the server side: a query is one small send each way
            self.s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.buf = b""
        body = struct.pack(">I", 196608) + b"user\x00chaos\x00\x00"
        self.s.sendall(struct.pack(">I", len(body) + 4) + body)
        self.key = None  # (pid, secret) from BackendKeyData
        while True:
            t, payload = self._read_msg()
            if t == b"K":
                self.key = struct.unpack(">ii", payload)
            if t == b"Z":
                break

    def _recv(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.s.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _read_msg(self):
        t = self._recv(1)
        (ln,) = struct.unpack(">I", self._recv(4))
        return t, self._recv(ln - 4)

    @staticmethod
    def _err_code(body: bytes) -> str:
        for field in body.split(b"\x00"):
            if field[:1] == b"C":
                return field[1:].decode()
        return "XX000"

    def query(self, sql: str):
        """Run one simple query; returns (rows, sqlstate-or-None)."""
        payload = sql.encode() + b"\x00"
        self.s.sendall(b"Q" + struct.pack(">I", len(payload) + 4)
                       + payload)
        return self._read_result()

    def query_extended(self, sql: str, params=()):
        """One Parse/Bind/Execute/Sync round (unnamed statement, text
        params); returns (rows, sqlstate-or-None). This is the wire
        path prepared-statement clients take — and where the serving
        queue's EXECUTE seam coalesces concurrent binds."""
        msg = bytearray()
        pl = b"\x00" + sql.encode() + b"\x00" + struct.pack(">H", 0)
        msg += b"P" + struct.pack(">I", len(pl) + 4) + pl
        bp = bytearray(b"\x00\x00")          # unnamed portal + stmt
        bp += struct.pack(">HH", 0, len(params))  # all-text params
        for p in params:
            v = str(p).encode()
            bp += struct.pack(">i", len(v)) + v
        bp += struct.pack(">H", 0)           # all-text results
        msg += b"B" + struct.pack(">I", len(bp) + 4) + bp
        ep = b"\x00" + struct.pack(">i", 0)
        msg += b"E" + struct.pack(">I", len(ep) + 4) + ep
        msg += b"S" + struct.pack(">I", 4)
        self.s.sendall(bytes(msg))
        return self._read_result()

    def _read_result(self):
        """Drain one response up to ReadyForQuery.

        The response is parsed in a single pass over the receive buffer
        (no per-message buffer reslicing): on a 1-core box the client
        threads share the benchmark machine with the server, so client
        parse cost would otherwise eat into the measured throughput."""
        rows, code = [], None
        unpack_i = struct.Struct(">i").unpack_from
        unpack_h = struct.Struct(">H").unpack_from
        while True:
            buf, pos, n = self.buf, 0, len(self.buf)
            while n - pos >= 5:
                ln = int.from_bytes(buf[pos + 1:pos + 5], "big")
                end = pos + 1 + ln
                if n < end:
                    break
                t = buf[pos]
                if t == 68:  # DataRow
                    (nf,) = unpack_h(buf, pos + 5)
                    off, row = pos + 7, []
                    for _ in range(nf):
                        (fl,) = unpack_i(buf, off)
                        off += 4
                        if fl < 0:
                            row.append(None)
                        else:
                            row.append(buf[off:off + fl].decode())
                            off += fl
                    rows.append(tuple(row))
                elif t == 69:  # ErrorResponse
                    code = self._err_code(buf[pos + 5:end])
                elif t == 90:  # ReadyForQuery
                    self.buf = buf[end:]
                    return rows, code
                pos = end
            self.buf = buf[pos:]
            chunk = self.s.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk

    def close(self):
        try:
            self.s.close()
        except OSError:
            pass


def send_cancel(addr, pid: int, secret: int) -> None:
    """Fire a CancelRequest on a NEW connection (the protocol's shape)."""
    try:
        s = socket.create_connection(addr, timeout=5)
        s.sendall(struct.pack(">IIii", 16, 80877102, pid, secret))
        s.close()
    except OSError:
        pass  # server mid-restart: the cancel is simply lost


def load_serving_catalog(device=None):
    """SessionCatalog preloaded with the three concurrent workloads:
    a YCSB-ish kv table (f0 = 37*pk — deterministic, so scans have a
    stable answer), a lineitem-shaped table for TPC-H-trickle
    aggregates, and a small vector table for ANN probes. The writes are
    host work; the store and the loading session get `device`."""
    from cockroach_tpu_torch.sql.session import Session, SessionCatalog
    from cockroach_tpu_torch.storage.engine import PyEngine
    from cockroach_tpu_torch.storage.mvcc import MVCCStore
    from cockroach_tpu_torch.util.hlc import HLC, ManualClock

    store = MVCCStore(engine=PyEngine(), clock=HLC(ManualClock(1000)),
                      device=device)
    cat = SessionCatalog(store)
    s = Session(cat, capacity=256, device=device)
    s.execute("create table kv (pk int primary key, f0 int, f1 int)")
    for a in range(0, KV_ROWS, 128):
        s.execute("insert into kv values " + ", ".join(
            "(%d, %d, %d)" % (pk, 37 * pk % 1009, pk * pk % 7919)
            for pk in range(a, min(a + 128, KV_ROWS))))
    s.execute("create table li (qty int, price int, disc int, "
              "rflag int, shipdate int)")
    for a in range(0, LI_ROWS, 128):
        s.execute("insert into li values " + ", ".join(
            "(%d, %d, %d, %d, %d)" % ((i * 7) % 50 + 1,
                                      (i * 97) % 900 + 100,
                                      (i * 3) % 10, i % 3,
                                      (i * 11) % 365)
            for i in range(a, min(a + 128, LI_ROWS))))
    s.execute("create table emb (id int primary key, v vector(4))")
    s.execute("insert into emb values " + ", ".join(
        "(%d, '[%d,%d,%d,%d]')" % (i, (i % 7) - 3, (i % 5) - 2,
                                   i % 3, (i % 11) - 5)
        for i in range(EMB_ROWS)))
    return store, cat


def execute_pool() -> List[Tuple[str, str, Tuple[str, ...]]]:
    """Parameterized EXECUTE variants of the batchable kv range read:
    (substituted_sql, template, params) triples. query_pool() lists the
    substituted text under class "execute" so chaos's simple-protocol
    warm-up/verification loops can replay it verbatim; run() re-binds
    the template through Parse/Bind/Execute so the timed statements
    take pgwire's EXECUTE seam into the serving queue."""
    out = []
    tmpl = ("select pk, f0 from kv where pk >= $1 and pk < $2 "
            "order by pk")
    for i in range(6):
        lo = (i * 71) % (KV_ROWS - 140)
        hi = lo + 24 + (i * 17) % 90
        sql = tmpl.replace("$1", str(lo), 1).replace("$2", str(hi), 1)
        out.append((sql, tmpl, (str(lo), str(hi))))
    return out


def query_pool() -> List[Tuple[str, str]]:
    """The fixed read-query pool. Every query's answer is independent of
    concurrent inserts (which only touch kv at pk >= INSERT_BASE), so
    a serial pre-run gives the bit-exact expected rows. The "ycsb",
    "agg", "topk", "vector", and "execute" classes map onto the serving
    queue's batchable compatibility classes; "tpch" (group-by over the
    pk-less li table) bypasses the queue untouched."""
    qs = []
    for i in range(8):
        lo = (i * 53) % (KV_ROWS - 130)
        hi = lo + 20 + (i * 13) % 100
        qs.append(("ycsb", "select pk, f0 from kv where pk >= %d and "
                           "pk < %d order by pk" % (lo, hi)))
    for i in range(5):
        lo = (i * 67) % (KV_ROWS - 160)
        hi = lo + 30 + (i * 19) % 110
        qs.append(("agg", "select count(*) as c, sum(f0) as s, "
                          "min(f1) as mn, max(f1) as mx, avg(f0) as a "
                          "from kv where pk >= %d and pk < %d"
                          % (lo, hi)))
    for i, k in enumerate((5, 9, 13, 7)):
        lo = (i * 41) % (KV_ROWS - 150)
        hi = lo + 40 + (i * 23) % 90
        qs.append(("topk", "select pk, f0 from kv where pk >= %d and "
                           "pk < %d order by f1%s limit %d"
                           % (lo, hi, " desc" if i % 2 else "", k)))
    for sql, _tmpl, _params in execute_pool():
        qs.append(("execute", sql))
    for d in (90, 180, 270, 364):
        qs.append(("tpch", "select rflag, count(*) as n, sum(qty) as "
                           "sq, sum(price) as sp from li where "
                           "shipdate <= %d group by rflag order by "
                           "rflag" % d))
    for a, b in ((0, 120), (60, 200)):
        qs.append(("tpch", "select sum(price * disc) as rev, count(*) "
                           "as n from li where shipdate >= %d and "
                           "shipdate < %d and qty < 30" % (a, b)))
    for probe in ("[0,0,1,0]", "[1,-1,2,0]", "[3,1,0,-2]"):
        qs.append(("vector", "select id from emb order by v <-> '%s' "
                             "limit 5" % probe))
    return qs


def percentiles(lat) -> Dict[str, object]:
    import numpy as np

    if not lat:
        return {"n": 0}
    a = np.asarray(lat)
    return {"n": len(lat),
            "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 2),
            "p99_ms": round(float(np.percentile(a, 99)) * 1e3, 2)}


def _serving_deltas(before_after):
    """Per-run serving-queue numbers out of two cumulative snapshots
    (the queue is a process singleton; counters never reset)."""
    before, after = before_after
    out = dict(after)
    for k in ("batched_dispatch_total", "coalesced_statements",
              "fallbacks", "dispatches"):
        out[k] = after[k] - before[k]
    cls_b, cls_a = before.get("classes", {}), after.get("classes", {})
    out["classes"] = {}
    for cls, a in cls_a.items():
        d = dict(a)
        b = cls_b.get(cls, {})
        for k in ("batched_dispatch_total", "coalesced_statements",
                  "fallbacks"):
            d[k] = a.get(k, 0) - b.get(k, 0)
        out["classes"][cls] = d
    return out


def run(threads: int = 8, ops_per_thread: int = 40,
        serving: bool = True, seed: int = 0, slots: int = 4,
        classes: Tuple[str, ...] = ("ycsb",),
        cat=None, emit=None, device=None) -> Dict[str, object]:
    """N wire-client threads against one PgServer, read-only, timed.

    Every thread loops `ops_per_thread` queries drawn round-robin from
    the pool entries in `classes` (default: the batchable YCSB range
    reads) and verifies each answer bit-exact against a serial warm-up
    reference. Returns aggregate q/s, per-class p50/p99, the mismatch
    count, and (when serving) the serving queue's per-run deltas.
    Pass `cat` to reuse a preloaded catalog across the off/on pair so
    the comparison isn't skewed by load time. The server runs on
    `device` (CUDA unless given)."""
    import random

    from cockroach_tpu_torch.sql import serving as _serving
    from cockroach_tpu_torch.sql.pgwire import PgServer
    from cockroach_tpu_torch.util.admission import (
        SESSION_QUEUE_TIMEOUT, SESSION_SLOTS,
    )
    from cockroach_tpu_torch.util.settings import Settings

    s = Settings()
    prev = {k: s.get(k) for k in (SESSION_SLOTS, SESSION_QUEUE_TIMEOUT,
                                  _serving.SERVING_ENABLED)}
    s.set(SESSION_SLOTS, slots)
    s.set(SESSION_QUEUE_TIMEOUT, 30.0)
    s.set(_serving.SERVING_ENABLED, serving)
    if cat is None:
        _store, cat = load_serving_catalog(device)
    pool = [(c, q) for c, q in query_pool() if c in classes]
    if not pool:
        raise ValueError("no pool queries in classes=%r" % (classes,))
    # execute-class entries re-bind their template over the extended
    # protocol in the timed loop (keyed by the substituted text, which
    # is also what the serial reference replays)
    ext = {sql: (tmpl, params) for sql, tmpl, params in execute_pool()}
    srv = PgServer(cat, capacity=256, device=device).start()
    try:
        # serial reference AND warm-up: two passes store the prepared
        # entries (shared across sessions via the catalog), capture the
        # per-statement graphs and build the batched runners, so the
        # timed region measures serving, not first runs
        ref = {}
        c = WireClient(srv.addr)
        for _ in range(2):
            for _cls, q in pool:
                rows, code = c.query(q)
                assert code is None, (q, code)
                ref[q] = sorted(rows)
        c.close()
        if serving:
            # run every pow2 batch-bucket shape up front (the serial
            # warm-up only reaches batch=1), so no client's p99 pays a
            # bucket's first allocations
            _serving.serving_queue().prewarm(max_batch=threads)

        q0 = _serving.serving_queue().snapshot()
        mu = threading.Lock()
        lat: Dict[str, list] = {cls: [] for cls in classes}
        errs: list = []
        mismatch = [0]
        start_gate = threading.Event()

        def client(tid):
            rng = random.Random(seed * 6151 + tid)
            conn = WireClient(srv.addr)
            start_gate.wait()
            try:
                for i in range(ops_per_thread):
                    cls, sql = pool[(tid + i + rng.randrange(2))
                                    % len(pool)]
                    t0 = time.monotonic()
                    if cls == "execute":
                        rows, code = conn.query_extended(*ext[sql])
                    else:
                        rows, code = conn.query(sql)
                    dt = time.monotonic() - t0
                    with mu:
                        if code is not None:
                            errs.append((tid, sql, code))
                        elif sorted(rows) != ref[sql]:
                            mismatch[0] += 1
                        else:
                            lat[cls].append(dt)
            finally:
                conn.close()

        workers = [threading.Thread(target=client, args=(tid,),
                                    name=f"servebench-{tid}",
                                    daemon=True)
                   for tid in range(threads)]
        for w in workers:
            w.start()
        t0 = time.monotonic()
        start_gate.set()
        for w in workers:
            w.join(300)
        elapsed = time.monotonic() - t0
        q1 = _serving.serving_queue().snapshot()
    finally:
        srv.drain(timeout=10.0)
        for k, v in prev.items():
            s.set(k, v)

    ok = sum(len(v) for v in lat.values())
    report = {
        "serving": serving,
        "threads": threads,
        "ops_per_thread": ops_per_thread,
        "elapsed_s": round(elapsed, 3),
        "qps": round(ok / elapsed, 1) if elapsed > 0 else 0.0,
        "ok": ok,
        "mismatches": mismatch[0],
        "errors": errs[:10],
        "latency": {cls: percentiles(v) for cls, v in lat.items()},
    }
    if serving:
        report["serving_queue"] = _serving_deltas((q0, q1))
    if emit:
        emit("servebench serving=%s: %.1f q/s (%d ok, %d mismatches)"
             % (serving, report["qps"], ok, mismatch[0]))
    return report


def compare(threads: int = 8, ops_per_thread: int = 40, seed: int = 0,
            slots: int = 4, classes: Tuple[str, ...] = ("ycsb",),
            emit=None, device=None) -> Dict[str, object]:
    """Unbatched baseline, then batched, on the SAME preloaded catalog:
    the speedup is the continuous-batching win at equal client count."""
    _store, cat = load_serving_catalog(device)
    off = run(threads, ops_per_thread, serving=False, seed=seed,
              slots=slots, classes=classes, cat=cat, emit=emit,
              device=device)
    on = run(threads, ops_per_thread, serving=True, seed=seed,
             slots=slots, classes=classes, cat=cat, emit=emit,
             device=device)
    speedup = (on["qps"] / off["qps"]) if off["qps"] else 0.0
    return {"unbatched": off, "batched": on,
            "speedup": round(speedup, 2)}
