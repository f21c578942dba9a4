"""The port's pgwire server (sql/pgwire.py) against the JAX package's, on
the CPU: the wire cases of tests/test_pgwire_extended.py,
tests/test_pgwire_rowexec.py (:114-160), tests/test_concurrency.py
(:257-360), tests/test_changefeed.py (:393) and tests/test_serving.py's
EXECUTE coalescing, each run as the same conversation against a JAX
PgServer and a port PgServer (device="cpu") over equal catalogs, with
equal rows and equal SQLSTATE codes (messages may differ in text). Every
socket has a timeout, every server binds port 0 and closes in `finally`,
and process-wide settings and fault points are restored."""

import json
import socket
import struct
import threading
import time

import pytest

from cockroach_tpu.sql import TPCHCatalog as JTPCHCatalog
from cockroach_tpu.sql.pgwire import PgServer as JPgServer
from cockroach_tpu.sql.session import SessionCatalog as JSessionCatalog
from cockroach_tpu.storage.engine import PyEngine as JPyEngine
from cockroach_tpu.storage.mvcc import MVCCStore as JMVCCStore
from cockroach_tpu.util import fault as jfault
from cockroach_tpu.util.hlc import HLC as JHLC, ManualClock as JClock
from cockroach_tpu.util.retry import (
    RESILIENCE_INITIAL_BACKOFF as JBACKOFF,
)
from cockroach_tpu.util.settings import Settings as JSettings
from cockroach_tpu.workload.tpch import TPCH as JTPCH
from cockroach_tpu_torch.sql import serving
from cockroach_tpu_torch.sql.pgwire import PgServer
from cockroach_tpu_torch.sql.plan import TPCHCatalog
from cockroach_tpu_torch.sql.session import SessionCatalog
from cockroach_tpu_torch.storage.engine import PyEngine
from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util import circuit as tcircuit
from cockroach_tpu_torch.util import fault as tfault
from cockroach_tpu_torch.util.hlc import HLC, ManualClock
from cockroach_tpu_torch.util.retry import RESILIENCE_INITIAL_BACKOFF
from cockroach_tpu_torch.util.settings import Settings
from cockroach_tpu_torch.workload.tpch import TPCH
from torch_threads import one_torch_thread  # noqa: F401

TIMEOUT = 30.0
N_ROWS = 128
WARM_Q = "select pk, v from t where pk >= 0 and pk < 40 order by pk"


class Client:
    """A minimal v3 client over a raw socket (every read times out)."""

    def __init__(self, addr, user=b"t", password=None):
        self.s = socket.create_connection(addr, timeout=TIMEOUT)
        self.buf = b""
        body = struct.pack(">I", 196608) + b"user\x00" + user + b"\x00\x00"
        self.s.sendall(struct.pack(">I", len(body) + 4) + body)
        self.key = None
        self.first = None
        for t, payload in self._until(b"Z", stop=(b"E",)):
            if self.first is None:
                self.first = (t, payload)
            if t == b"K":
                self.key = struct.unpack(">ii", payload)

    def _recv(self, n):
        while len(self.buf) < n:
            chunk = self.s.recv(65536)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def msg(self):
        t = self._recv(1)
        (ln,) = struct.unpack(">I", self._recv(4))
        return t, self._recv(ln - 4)

    def _until(self, kind, stop=()):
        out = []
        while True:
            t, body = self.msg()
            out.append((t, body))
            if t == kind or t in stop:
                return out

    def send(self, t, payload=b""):
        self.s.sendall(t + struct.pack(">I", len(payload) + 4) + payload)

    @staticmethod
    def _outcome(msgs):
        cols, rows, code, tags = [], [], None, []
        for t, body in msgs:
            if t == b"T":
                (n,) = struct.unpack(">H", body[:2])
                off, cols = 2, []
                for _ in range(n):
                    end = body.index(b"\x00", off)
                    cols.append(body[off:end].decode())
                    off = end + 1 + 18
            elif t == b"D":
                (n,) = struct.unpack(">H", body[:2])
                off, row = 2, []
                for _ in range(n):
                    (ln,) = struct.unpack(">i", body[off:off + 4])
                    off += 4
                    row.append(None if ln < 0 else body[off:off + ln].decode())
                    off += max(ln, 0)
                rows.append(row)
            elif t == b"E":
                for f in body.split(b"\x00"):
                    if f[:1] == b"C":
                        code = code or f[1:].decode()
            elif t == b"C":
                tags.append(body.rstrip(b"\x00").decode())
        return {"cols": cols, "rows": rows, "code": code, "tags": tags}

    def query(self, sql):
        self.send(b"Q", sql.encode() + b"\x00")
        return self._outcome(self._until(b"Z"))

    def parse(self, name, sql, oids=()):
        self.send(b"P", name.encode() + b"\x00" + sql.encode() + b"\x00"
                  + struct.pack(f">H{len(oids)}I", len(oids), *oids))

    def bind(self, portal, stmt, params, binary=False):
        p = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
        p += struct.pack(">HH", 1, 1) if binary else struct.pack(">H", 0)
        p += struct.pack(">H", len(params))
        for v in params:
            if v is None:
                p += struct.pack(">i", -1)
            else:
                b = v if binary else str(v).encode()
                p += struct.pack(">i", len(b)) + b
        self.send(b"B", p + struct.pack(">H", 0))

    def execute(self, portal=""):
        self.send(b"E", portal.encode() + b"\x00" + struct.pack(">i", 0))

    def sync(self):
        self.send(b"S")
        msgs = self._until(b"Z")
        out = self._outcome(msgs)
        out["kinds"] = [t for t, _ in msgs]
        return out

    def extended(self, sql, params=(), describe=True):
        self.parse("", sql)
        self.bind("", "", list(params))
        if describe:
            self.send(b"D", b"P\x00")
        self.execute()
        return self.sync()

    def close(self):
        try:
            self.send(b"X")
        except OSError:
            pass
        self.s.close()


def _send_cancel(addr, pid, secret):
    s = socket.create_connection(addr, timeout=5)
    s.sendall(struct.pack(">IIii", 16, 80877102, pid, secret))
    s.close()


def _fill(c):
    c.query("create table t (pk int primary key, v int)")
    c.query("insert into t values " + ", ".join(
        "(%d, %d)" % (pk, 37 * pk % 1009) for pk in range(N_ROWS)))


class Servers:
    """A JAX and a port PgServer over equal catalogs; `both(fn)` runs a
    conversation against each and returns the two results."""

    def __init__(self, kind="session", password=None):
        if kind == "session":
            self.jstore = JMVCCStore(engine=JPyEngine(),
                                     clock=JHLC(JClock(1000)))
            self.tstore = MVCCStore(engine=PyEngine(),
                                    clock=HLC(ManualClock(1000)),
                                    device="cpu")
            jcat = JSessionCatalog(self.jstore)
            tcat = SessionCatalog(self.tstore)
        else:
            jcat, tcat = JTPCHCatalog(JTPCH(sf=0.01)), TPCHCatalog(
                TPCH(sf=0.01))
        self.j = JPgServer(jcat, capacity=256, password=password).start()
        try:
            self.t = PgServer(tcat, capacity=256, password=password,
                              device="cpu").start()
        except BaseException:
            self.j.close()
            raise

    def both(self, fn, equal=True):
        want, got = fn(self.j, jfault), fn(self.t, tfault)
        if equal:
            assert got == want
        return want, got

    def close(self):
        self.j.close()
        self.t.close()


@pytest.fixture(autouse=True)
def _hygiene():
    s, js = Settings(), JSettings()
    keys = (serving.SERVING_ENABLED, serving.COALESCE_WINDOW_MS,
            serving.MAX_BATCH, RESILIENCE_INITIAL_BACKOFF)
    prev = {k: s.get(k) for k in keys}
    jprev = js.get(JBACKOFF)
    s.set(RESILIENCE_INITIAL_BACKOFF, 0.0)
    js.set(JBACKOFF, 0.0)
    yield
    for k, v in prev.items():
        s.set(k, v)
    js.set(JBACKOFF, jprev)
    tfault.registry().disarm()
    jfault.registry().disarm()
    tcircuit.reset_all()


@pytest.fixture(scope="module")
def session_servers():
    srv = Servers("session")
    try:
        yield srv
    finally:
        srv.close()


@pytest.fixture(scope="module")
def tpch_servers():
    srv = Servers("tpch")
    try:
        yield srv
    finally:
        srv.close()


# ----------------------------------------- tests/test_pgwire_extended.py --

def test_prepared_statement_with_params(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            out = [d.extended("create table pp (id int primary key, v int)"),
                   d.extended("insert into pp values (1, 10), (2, 20), "
                              "(3, 30)"),
                   d.extended("select id, v from pp where v > $1 order by "
                              "id", [15])]
            d.parse("q1", "select v from pp where id = $1")
            for p in (2, 3):
                d.bind("", "q1", [p])
                d.execute()
            out.append(d.sync())
            return out
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[2]["rows"] == [["2", "20"], ["3", "30"]]
    assert got[3]["rows"] == [["20"], ["30"]]


def test_null_param_and_string_quoting(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.extended("create table s (id int primary key, name string)")
            d.extended("insert into s values ($1, $2)", [1, "o'hara"])
            d.extended("insert into s values ($1, $2)", [2, None])
            return d.extended("select id, name from s order by id")
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got["rows"] == [["1", "o'hara"], ["2", None]]


def test_describe_dml_portal_has_no_side_effects(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.extended("create table dd (id int primary key, v int)")
            d.parse("", "insert into dd values (1, 10)")
            d.bind("", "", [])
            d.send(b"D", b"P\x00")
            kinds = d.sync()["kinds"]
            out = [b"n" in kinds, d.extended("select count(*) from dd")]
            d.extended("insert into dd values (1, 10)")
            out.append(d.extended("select count(*) from dd"))
            return out
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[0] and got[1]["rows"] == [["0"]] and got[2]["rows"] == [["1"]]


def test_error_skips_to_sync(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.parse("", "select broken syntax here from")
            d.bind("", "", [])
            d.execute()
            first = d.sync()
            return [first["code"], b"E" in first["kinds"],
                    d.extended("select 1 + 1 as x from s")]
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[0] is not None and got[1] and got[2]["rows"]


def test_simple_query_still_works(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            return d.query("select 2 + 2 as four from s")
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got["cols"] == ["four"] and got["rows"] and got["tags"]


def test_password_auth():
    srv = Servers("session", password="hunter2")
    try:
        def conv(server, _f):
            out = []
            for pw in ("wrong", "hunter2"):
                sock = socket.create_connection(server.addr, timeout=5)
                try:
                    body = struct.pack(">I", 196608) + b"user\x00t\x00\x00"
                    sock.sendall(struct.pack(">I", len(body) + 4) + body)
                    t = sock.recv(1)
                    (ln,) = struct.unpack(">I", sock.recv(4))
                    (code,) = struct.unpack(">I", sock.recv(ln - 4))
                    payload = pw.encode() + b"\x00"
                    sock.sendall(b"p" + struct.pack(">I", len(payload) + 4)
                                 + payload)
                    out.append((t, code, sock.recv(1)))
                finally:
                    sock.close()
            return out

        _w, got = srv.both(conv)
        assert got == [(b"R", 3, b"E"), (b"R", 3, b"R")]
    finally:
        srv.close()


def test_binary_format_params(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.extended("create table bp (id int primary key, x decimal(1))")
            d.extended("insert into bp values (1, 1.5), (2, 2.5), (7, 7.5)")
            out = []
            for sql, oid, raw in (
                    ("select x from bp where id = $1", 20,
                     struct.pack(">q", 7)),
                    ("select id from bp where x < $1 order by id", 701,
                     struct.pack(">d", 2.0)),
                    ("select id from bp where id = $1", 1700, b"\x00\x01")):
                d.parse("", sql, oids=[oid])
                d.bind("", "", [raw], binary=True)
                d.execute()
                r = d.sync()
                out.append((r["rows"], r["code"]))
            return out
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[0] == ([["7.50"]], None) and got[1] == ([["1"]], None)
    assert got[2][1] is not None


def test_vector_over_the_wire(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.extended("create table vt (id int primary key, emb vector(3))")
            d.extended("insert into vt values ($1, $2)", [1, "[1.5,2.5,3.5]"])
            d.extended("insert into vt values ($1, $2)", [2, "[0.0,0.0,1.0]"])
            near = d.extended("select id from vt order by emb <-> $1 "
                              "limit 2", ["[0,0,1]"])
            d.parse("", "select emb from vt where id = $1", oids=[20])
            d.bind("", "", [struct.pack(">q", 1)], binary=True)
            d.send(b"D", b"P\x00")
            d.execute()
            return near, d.sync()
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[0]["rows"] == [["2"], ["1"]]
    assert got[1]["rows"] == [["[1.5,2.5,3.5]"]]


def test_copy_from_stdin(session_servers):
    def conv(srv, _f):
        d = Client(srv.addr)
        try:
            d.extended("create table ct (id int primary key, v int, "
                       "s string)")
            d.send(b"Q", b"copy ct from stdin\x00")
            while True:
                t, body = d.msg()
                if t == b"G":
                    break
                assert t != b"E", body
            d.send(b"d", b"1\t10\talpha\n2\t\\N\tbe'ta\n3\t30\t\\N\n")
            d.send(b"c")
            done = Client._outcome(d._until(b"Z"))
            return done["tags"], d.extended("select id, v, s from ct "
                                            "order by id")["rows"]
        finally:
            d.close()

    _w, got = session_servers.both(conv)
    assert got[0] == ["COPY 3"]
    assert got[1] == [["1", "10", "alpha"], ["2", None, "be'ta"],
                      ["3", "30", None]]


# ---------------------------------- tests/test_pgwire_rowexec.py :114-160 --

def test_pgwire_tpch_simple_queries(tpch_servers):
    texts = ["select n_name, n_regionkey from nation where n_regionkey = 1 "
             "order by n_name limit 3",
             "select l_extendedprice, l_shipdate from lineitem "
             "order by l_orderkey limit 1",
             "select nope from nation",
             "select count(*) as n from region",
             "select 1 as a from region limit 1; "
             "select 2 as b from region limit 1"]

    def conv(srv, _f):
        c = Client(srv.addr)
        try:
            return [c.query(sql) for sql in texts]
        finally:
            c.close()

    _w, got = tpch_servers.both(conv)
    assert got[0]["cols"] == ["n_name", "n_regionkey"] and \
        len(got[0]["rows"]) == 3
    assert "." in got[1]["rows"][0][0] and "-" in got[1]["rows"][0][1]
    assert got[2]["code"] is not None and got[3]["rows"] == [["5"]]
    assert got[4]["cols"] == ["b"] and len(got[4]["rows"]) == 2


def test_pgwire_explain(tpch_servers):
    def conv(srv, _f):
        c = Client(srv.addr)
        try:
            r = c.query("explain select n_name from nation")
            return r["cols"], r["code"], any(
                "scan nation" in row[0] for row in r["rows"])
        finally:
            c.close()

    _w, got = tpch_servers.both(conv)
    assert got == (["info"], None, True)


# -------------------------------------- tests/test_concurrency.py :257-360 --

def _slow_retryable(delay):
    def make():
        time.sleep(delay)
        return ConnectionError("transfer failed")

    return make


def test_pgwire_cancelrequest_aborts_in_flight():
    srv = Servers("session")
    try:
        def conv(server, fault):
            c = Client(server.addr)
            try:
                _fill(c)
                first = c.query(WARM_Q)
                c.query(WARM_Q)
                fault.registry().arm("fused.exec", probability=1.0,
                                     make=_slow_retryable(0.05))
                out = {}
                th = threading.Thread(target=lambda: out.update(
                    r=c.query(WARM_Q)))
                th.start()
                time.sleep(0.2)
                _send_cancel(server.addr, *c.key)
                th.join(TIMEOUT)
                assert not th.is_alive()
                fault.registry().disarm()
                again = c.query(WARM_Q)
                _send_cancel(server.addr, 999999, 12345)
                bogus = c.query(WARM_Q)
                return (out["r"]["code"], len(first["rows"]),
                        again["rows"] == first["rows"],
                        bogus["rows"] == first["rows"])
            finally:
                fault.registry().disarm()
                c.close()

        _w, got = srv.both(conv)
        assert got == ("57014", 40, True, True)
    finally:
        srv.close()


def test_pgwire_drain_idle_then_refuses_connections():
    srv = Servers("session")
    try:
        def conv(server, _f):
            c = Client(server.addr)
            _fill(c)
            r = c.query("select count(*) as n from t")
            summary = server.drain(timeout=5)
            refused = False
            try:
                socket.create_connection(server.addr, timeout=2).close()
            except OSError:
                refused = True
            c.s.close()
            return r["rows"], summary["graceful"], summary["forced"], refused

        _w, got = srv.both(conv)
        assert got == ([["128"]], True, False, True)
    finally:
        srv.close()


def test_pgwire_drain_cancels_straggler():
    srv = Servers("session")
    try:
        def conv(server, fault):
            hooks = []
            server.drain_hooks.append(lambda: hooks.append(True))
            c = Client(server.addr)
            idle = Client(server.addr)
            try:
                _fill(c)
                c.query(WARM_Q)
                c.query(WARM_Q)
                fault.registry().arm("fused.exec", probability=1.0,
                                     make=_slow_retryable(0.05))
                out = {}

                def run():
                    try:
                        out["r"] = c.query(WARM_Q)["code"]
                    except (ConnectionError, OSError):
                        out["r"] = "conn-lost"

                th = threading.Thread(target=run)
                th.start()
                time.sleep(0.2)
                drained = {}
                dth = threading.Thread(target=lambda: drained.update(
                    server.drain(timeout=6, grace=0.2)))
                dth.start()
                deadline = time.monotonic() + TIMEOUT
                while not server.draining() and time.monotonic() < deadline:
                    time.sleep(0.001)
                new_stmt = idle.query("select count(*) as n from t")["code"]
                dth.join(TIMEOUT)
                th.join(TIMEOUT)
                assert not th.is_alive() and not dth.is_alive()
                return (drained["cancelled"] >= 1, drained["forced"],
                        out["r"], new_stmt, hooks)
            finally:
                fault.registry().disarm()
                c.s.close()
                idle.s.close()

        want, got = srv.both(conv, equal=False)
        # the JAX drain may close the straggler's socket before its
        # ErrorResponse; the port's closes only between messages
        assert want[0] and not want[1] and want[2] in ("57014", "conn-lost")
        assert got == (True, False, "57014", "57P01", [True])
        assert want[3] == "57P01" and want[4] == [True]
    finally:
        srv.close()


def test_wire_cancel_query_cross_session():
    srv = Servers("session")
    try:
        def conv(server, fault):
            victim, admin = Client(server.addr), Client(server.addr)
            try:
                _fill(victim)
                first = victim.query(WARM_Q)
                victim.query(WARM_Q)
                admin.query("select query_id, phase, sql from "
                            "crdb_internal.cluster_queries")
                fault.registry().arm("fused.exec", after=0,
                                     make=_slow_retryable(1.5))
                out = {}
                th = threading.Thread(target=lambda: out.update(
                    r=victim.query(WARM_Q)))
                th.start()
                qid, phase = None, None
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and qid is None:
                    r = admin.query("select query_id, phase, sql from "
                                    "crdb_internal.cluster_queries")
                    for query_id, ph, sql in r["rows"]:
                        if sql == WARM_Q and ph in ("executing",
                                                    "serving-batched"):
                            qid, phase = int(query_id), ph
                    time.sleep(0.02)
                assert qid is not None
                cancel = admin.query("cancel query %d" % qid)
                th.join(TIMEOUT)
                assert not th.is_alive()
                fault.registry().disarm()
                after = victim.query(WARM_Q)
                return (phase, cancel["code"], out["r"]["code"],
                        after["rows"] == first["rows"])
            finally:
                fault.registry().disarm()
                victim.close()
                admin.close()

        _w, got = srv.both(conv)
        assert got == ("serving-batched", None, "57014", True)
    finally:
        srv.close()


# ------------------------------------ tests/test_changefeed.py :393 (wire) --

def test_pgwire_experimental_changefeed():
    srv = Servers("session")
    try:
        def conv(server, _f):
            d = Client(server.addr)
            try:
                d.extended("create table t (k int primary key, grp int not "
                           "null, v int)")
                d.extended("insert into t values (1, 0, 10), (2, 1, 20)")
                r = d.extended("experimental changefeed for t with "
                               "max_polls = 1, limit = 10")
                return r["cols"], [json.loads(row[0]) for row in r["rows"]]
            finally:
                d.close()

        want, got = srv.both(conv, equal=False)
        cols, envs = got
        # the JAX server's start reads the HLC for its pre-warm job (item
        # 8e, not ported), so its versions carry a later logical clock:
        # equal envelopes but for their timestamps
        strip = [[{k: v for k, v in e.items() if k != "ts"} for e in x[1]]
                 for x in (want, got)]
        assert cols == want[0] == ["changefeed"] and strip[0] == strip[1]
        assert sorted(e["key"] for e in envs) == [1, 2]
        assert envs[0]["after"] == {"grp": 0, "v": 10}
        # the port's envelopes are a memory-sink feed's over its store
        from cockroach_tpu_torch.sql import changefeed as cfmod

        sink = cfmod.MemorySink()
        cfmod.ChangefeedStream(srv.tstore, srv.t.catalog.desc("t"),
                               sink).poll()
        assert envs == sink.events()
    finally:
        srv.close()


# ------------------------- tests/test_serving.py: EXECUTE binds coalesce --

def test_execute_binds_coalesce_over_wire():
    """Concurrent Parse/Bind/Execute clients running one template with
    different params join the scan-class group at Bind: one full batch,
    counted in the execute family, every bind's rows equal to the JAX
    server's."""
    srv = Servers("session")
    n = 4
    try:
        tmpl = "select pk, v from t where pk >= $1 and pk < $2 order by pk"
        binds = [(str(i * 29), str(i * 29 + 12 + i)) for i in range(n)]

        def ref(server, _f):
            c = Client(server.addr)
            try:
                _fill(c)
                out = []
                for lo, hi in binds:
                    text = tmpl.replace("$1", lo).replace("$2", hi)
                    simple = c.query(text)["rows"]
                    out.append((simple, c.extended(tmpl, [lo, hi])["rows"]))
                return out
            finally:
                c.close()

        want, _g = srv.both(ref)
        s = Settings()
        s.set(serving.COALESCE_WINDOW_MS, 5000.0)
        s.set(serving.MAX_BATCH, n)
        clients = [Client(srv.t.addr) for _ in range(n)]
        q = serving.serving_queue()
        before = q.snapshot()["classes"]["execute"]
        with q._mu:
            q._inflight += 1
        gate = threading.Barrier(n)
        got = [None] * n

        def worker(i):
            gate.wait(TIMEOUT)
            got[i] = clients[i].extended(tmpl, binds[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
        finally:
            with q._mu:
                q._inflight -= 1
            for c in clients:
                c.close()
        assert not any(t.is_alive() for t in threads)
        assert [g["rows"] for g in got] == [w[0] for w in want]
        assert all(w[0] == w[1] for w in want)
        after = q.snapshot()["classes"]["execute"]
        d = {k: after[k] - before[k]
             for k in ("batched_dispatch_total", "coalesced_statements",
                       "fallbacks")}
        assert d == {"batched_dispatch_total": 1, "coalesced_statements": n,
                     "fallbacks": 0}
    finally:
        srv.close()
