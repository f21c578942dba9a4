"""pgwire: the PostgreSQL v3 wire protocol server.

Counterpart of cockroach_tpu/sql/pgwire.py (`AdminShutdownError`, the
OIDs, `_pgcode`, `_Conn`, `PgServer`), with its names and messages.
Reference: pkg/sql/pgwire (server.go:918 ServeConn, conn.go,
pgwirebase message codecs): startup (trust, or cleartext password),
SimpleQuery (Q -> RowDescription + DataRows + CommandComplete +
ReadyForQuery), the extended protocol (Parse/Bind/Describe/Execute/
Close/Sync; Bind re-matches the bound text against the serving queue's
batch classes, and Execute serves a matched portal through
Session.execute_spec), COPY FROM STDIN, errors as ErrorResponse with a
SQLSTATE, Terminate, SSL-request refusal, CancelRequest by
BackendKeyData key, and drain (stragglers cancelled with 57014, new
statements refused with 57P01). Results are text-format, with
dictionary strings, decimals and dates decoded server-side
(cli.decode_column); EXPERIMENTAL CHANGEFEED's "stream" result is one
flushed DataRow per envelope.

Threaded accept loop (reader-per-connection, the serveImpl goroutine
analog); the Stopper owns shutdown. Every connection's Session runs on
the server's device: `PgServer(catalog, capacity, device=None)` resolves
it at construction (CUDA unless the caller passes one; without CUDA and
without a device it raises).

Departure from the JAX module: drain closes a connection's socket only
between messages (`_Conn.busy`, held from a message's receipt to its
last response byte), so a cancelled straggler's ErrorResponse (57014)
always reaches its client; the JAX drain can close the socket first.

Not ported yet: `PgServer._start_prewarm` (the plan vault and the
pre-warm job, ROADMAP.md queue 1, item 8e).
"""

from __future__ import annotations

import itertools
import secrets as _secrets
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from cockroach_tpu_torch.util.log import Channel, get_logger

_log = get_logger()


class AdminShutdownError(Exception):
    """The server is draining: no new statements on this connection
    (pgcode 57P01 admin_shutdown, what the reference sends on drain)."""

    pgcode = "57P01"

# type OIDs (pg catalog)
OID_INT8 = 20
OID_FLOAT4 = 700
OID_NUMERIC = 1700
OID_TEXT = 25
OID_DATE = 1082
OID_BOOL = 16


def _oid_for(ty) -> int:
    from cockroach_tpu_torch.coldata.batch import Kind

    return {
        Kind.INT: OID_INT8, Kind.FLOAT: OID_FLOAT4,
        Kind.DECIMAL: OID_NUMERIC, Kind.STRING: OID_TEXT,
        Kind.DATE: OID_DATE, Kind.BOOL: OID_BOOL,
        Kind.TIMESTAMP: OID_INT8,
        # vectors travel as pgvector-style text '[1,2,...]'
        Kind.VECTOR: OID_TEXT,
    }[ty.kind]


# binary-format (format code 1) parameter decoders, keyed by the OID
# the client declared in Parse. Everything renders to text because
# binding is textual (_substitute); clients like psycopg send int/float
# params in binary once they know the statement's parameter types.
OID_INT2, OID_INT4, OID_FLOAT8 = 21, 23, 701
_BINARY_DECODERS = {
    OID_INT2: lambda b: str(struct.unpack(">h", b)[0]),
    OID_INT4: lambda b: str(struct.unpack(">i", b)[0]),
    OID_INT8: lambda b: str(struct.unpack(">q", b)[0]),
    OID_FLOAT4: lambda b: repr(struct.unpack(">f", b)[0]),
    OID_FLOAT8: lambda b: repr(struct.unpack(">d", b)[0]),
    OID_BOOL: lambda b: "t" if b and b[0] else "f",
}


def _decode_binary_param(raw: bytes, oid: int) -> str:
    dec = _BINARY_DECODERS.get(oid)
    if dec is None:
        raise ValueError(
            f"binary parameter format not supported for OID {oid} "
            "(use text)")
    return dec(raw)


def _pgcode(e: BaseException) -> str:
    """SQLSTATE for an error headed to the wire. session.SQLError carries
    its own code (53200 out_of_memory, 40001 serialization_failure);
    anything unmapped reports 42601 (the historic catch-all here). A
    last-chance net also catches resource errors that bypassed the
    session layer (e.g. raised inside pgwire result encoding)."""
    code = getattr(e, "pgcode", None)
    if code is not None:
        return str(code)
    if isinstance(e, MemoryError):
        return "53200"
    return "42601"


class _Conn:
    def __init__(self, sock: socket.socket, server: "PgServer"):
        from cockroach_tpu_torch.sql.session import Session

        self.sock = sock
        try:
            # a query response is several small sendalls (RowDescription,
            # DataRows, CommandComplete, ReadyForQuery): without NODELAY,
            # Nagle holds the trailing ones for the peer's delayed ACK —
            # a flat ~40 ms stall on EVERY statement roundtrip
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.server = server
        self.buf = b""
        self._out: List[bytes] = []  # write buffer; see _send/_flush
        # one Session per connection (the connExecutor instance)
        self.session = Session(server.catalog,
                               capacity=server.capacity,
                               device=server.device)
        # BackendKeyData cancel key, assigned at handshake
        self.pid: Optional[int] = None
        self.secret: Optional[int] = None
        # held from a message's receipt to its last response byte: drain
        # closes the socket only between messages, so a cancelled
        # straggler's ErrorResponse always reaches its client
        self.busy = threading.Lock()

    # -- wire helpers -----------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("client closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def _send(self, type_byte: bytes, payload: bytes = b""):
        # buffered: a query response is RowDescription + N DataRows +
        # CommandComplete + ReadyForQuery — writing each as its own
        # sendall costs a syscall per ROW; instead messages accumulate
        # and _flush() writes them as one syscall at the protocol sync
        # points (ReadyForQuery, auth/copy handoffs, the H message) —
        # conn.go buffers its writes the same way
        self._out.append(type_byte + struct.pack(">I", len(payload) + 4)
                         + payload)

    def _flush(self):
        if self._out:
            msg = b"".join(self._out)
            self._out.clear()
            self.sock.sendall(msg)

    # -- protocol ---------------------------------------------------------

    def handshake(self) -> bool:
        while True:
            (length,) = struct.unpack(">I", self._recv_exact(4))
            body = self._recv_exact(length - 4)
            (version,) = struct.unpack(">I", body[:4])
            if version in (80877103, 80877104):  # SSL / GSSENC request
                self.sock.sendall(b"N")  # neither offered
                continue
            if version == 80877102:
                # CancelRequest: (pid, secret) on a NEW connection, no
                # response (pgwire server.go handleCancel) — route to
                # the owning session's in-flight statement and close
                pid, secret = struct.unpack(">ii", body[4:12])
                self.server.handle_cancel(pid, secret)
                return False
            if version != 196608:  # protocol 3.0
                self._error(f"unsupported protocol version {version}")
                return False
            break
        # startup parameters (ignored beyond logging)
        params: Dict[str, str] = {}
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        if self.server.password is not None:
            # AuthenticationCleartextPassword -> PasswordMessage
            # (pgwire/auth.go's password method)
            self._send(b"R", struct.pack(">I", 3))
            self._flush()  # the client won't speak until it sees this
            t = self._recv_exact(1)
            (plen,) = struct.unpack(">I", self._recv_exact(4))
            pw = self._recv_exact(plen - 4).rstrip(b"\x00").decode()
            if t != b"p" or pw != self.server.password:
                self._error("password authentication failed")
                return False
        self._send(b"R", struct.pack(">I", 0))  # AuthenticationOk
        for k, v in (("server_version", "13.0 cockroach_tpu"),
                     ("client_encoding", "UTF8"),
                     ("DateStyle", "ISO")):
            self._send(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")
        # BackendKeyData: the (pid, secret) cancel key the client echoes
        # in a CancelRequest; registered before ReadyForQuery so a
        # cancel can never race ahead of its own key
        self.pid, self.secret = self.server.register_cancel_key(self)
        self._send(b"K", struct.pack(">ii", self.pid, self.secret))
        self._send(b"Z", b"I")  # ReadyForQuery, idle
        self._flush()
        _log.info(Channel.SQL_EXEC, f"pgwire session: {params.get('user')}")
        return True

    def serve(self):
        if not self.handshake():
            return
        # extended-protocol state (Parse/Bind/Execute, conn.go:151's
        # command loop): named prepared statements + bound portals
        self._stmts: Dict[str, Tuple[str, int]] = {}
        self._portals: Dict[str, dict] = {}
        self._in_error = False  # skip-until-Sync after an error
        while not self.server.stopping():
            t = self._recv_exact(1)
            (length,) = struct.unpack(">I", self._recv_exact(4))
            body = self._recv_exact(length - 4)
            if t == b"X":  # Terminate
                return
            with self.busy:
                self._message(t, body)

    def _message(self, t: bytes, body: bytes):
        if t == b"S":  # Sync: end of the extended batch
            self._in_error = False
            self._ready()
            return
        if self._in_error:
            return  # discard until Sync
        try:
            if t == b"Q":
                self.simple_query(body.rstrip(b"\x00").decode())
            elif t == b"P":
                self._msg_parse(body)
            elif t == b"B":
                self._msg_bind(body)
            elif t == b"D":
                self._msg_describe(body)
            elif t == b"E":
                self._msg_execute(body)
            elif t == b"C":
                self._msg_close(body)
            elif t == b"H":  # Flush: push buffered responses now
                self._flush()
            else:
                raise ValueError(f"unsupported message type {t!r}")
        except Exception as e:  # noqa: BLE001 — errors go inband
            self._error(f"{type(e).__name__}: {e}", _pgcode(e))
            if t == b"Q":
                self._ready()
            else:
                self._in_error = True

    def _copy_in(self, table: str):
        """COPY <table> FROM STDIN (text format, tab-separated, \\N =
        NULL — pgwire conn.go's copy-in machine): CopyInResponse, then
        CopyData frames buffered into batched INSERTs, CopyDone ->
        CommandComplete."""
        cat = self.session.catalog
        desc = cat.desc(table)  # raises if unknown before CopyInResponse
        cols = [c for c, _ in desc.visible_columns()]
        n_cols = len(cols)
        # CopyInResponse: text overall + per-column text formats
        self._send(b"G", struct.pack(f">bH{n_cols}H", 0, n_cols,
                                     *([0] * n_cols)))
        self._flush()  # client sends CopyData only after seeing this
        data = b""
        while True:
            t = self._recv_exact(1)
            (length,) = struct.unpack(">I", self._recv_exact(4))
            body = self._recv_exact(length - 4)
            if t == b"d":
                data += body
            elif t == b"c":  # CopyDone
                break
            elif t == b"f":  # CopyFail
                reason = body.rstrip(b"\x00").decode()
                raise ValueError(f"COPY failed by client: {reason}")
            else:
                raise ValueError(f"unexpected message {t!r} during COPY")
        n = 0
        values_sql: List[str] = []
        for line in data.decode().split("\n"):
            if not line or line == "\\.":
                continue
            fields = line.split("\t")
            if len(fields) != n_cols:
                raise ValueError(
                    f"COPY row has {len(fields)} columns, want {n_cols}")
            rendered = []
            for f in fields:
                if f == "\\N":
                    rendered.append("NULL")
                else:
                    try:
                        float(f)
                        rendered.append(f)
                    except ValueError:
                        rendered.append("'" + f.replace("'", "''") + "'")
            values_sql.append("(" + ", ".join(rendered) + ")")
            n += 1
            if len(values_sql) >= 512:  # bounded INSERT batches
                self._execute_stmt(
                    f"insert into {table} ({', '.join(cols)}) values "
                    + ", ".join(values_sql))
                values_sql = []
        if values_sql:
            self._execute_stmt(
                f"insert into {table} ({', '.join(cols)}) values "
                + ", ".join(values_sql))
        self._complete(f"COPY {n}")

    def _ready(self):
        status = b"T" if self.session._txn is not None else b"I"
        self._send(b"Z", status)
        self._flush()

    # -- extended protocol (Parse/Bind/Describe/Execute) -------------------

    @staticmethod
    def _cstr(body: bytes, off: int) -> Tuple[str, int]:
        end = body.index(b"\x00", off)
        return body[off:end].decode(), end + 1

    def _msg_parse(self, body: bytes):
        name, off = self._cstr(body, 0)
        sql, off = self._cstr(body, off)
        (n_oids,) = struct.unpack(">H", body[off:off + 2])
        off += 2
        # retain the declared parameter OIDs: Bind needs them to decode
        # binary-format parameter values
        oids = struct.unpack(f">{n_oids}I", body[off:off + 4 * n_oids])
        n_params = 0
        import re as _re

        for m in _re.finditer(r"\$(\d+)", sql):
            n_params = max(n_params, int(m.group(1)))
        self._stmts[name] = (sql, max(n_params, n_oids), tuple(oids))
        self._send(b"1")  # ParseComplete

    def _msg_bind(self, body: bytes):
        portal, off = self._cstr(body, 0)
        stmt, off = self._cstr(body, off)
        if stmt not in self._stmts:
            raise ValueError(f"unknown prepared statement {stmt!r}")
        sql, _n, oids = self._stmts[stmt]
        (n_fmt,) = struct.unpack(">H", body[off:off + 2])
        off += 2
        fmts = struct.unpack(f">{n_fmt}H", body[off:off + 2 * n_fmt])
        off += 2 * n_fmt
        (n_params,) = struct.unpack(">H", body[off:off + 2])
        off += 2
        params: List[Optional[str]] = []
        for i in range(n_params):
            (plen,) = struct.unpack(">i", body[off:off + 4])
            off += 4
            if plen < 0:
                params.append(None)
            else:
                raw = body[off:off + plen]
                off += plen
                if len(fmts) == 0:
                    fmt = 0
                elif len(fmts) == 1:
                    fmt = fmts[0]
                else:
                    fmt = fmts[i]
                if fmt == 1:
                    oid = oids[i] if i < len(oids) else 0
                    params.append(_decode_binary_param(raw, oid))
                else:
                    params.append(raw.decode())
        # substitute $n with typed literals (text-format params; the
        # session parser has no placeholder support, so binding is
        # textual — quoting strings, passing numerics through)
        bound = self._substitute(sql, params)
        # EXECUTE seam: re-match the BOUND text against the serving
        # batch classes, so prepared statements differing only in bind
        # values join their class's coalescing group at Execute time
        # (Session.execute_spec) instead of re-running parse/plan
        spec = None
        try:
            from cockroach_tpu_torch.sql import serving as _serving

            spec = _serving.match_bound_sql(self.session, bound)
        except Exception:  # noqa: BLE001 — matching must never fail Bind
            spec = None
        self._portals[portal] = {"sql": bound, "result": None,
                                 "spec": spec}
        self._send(b"2")  # BindComplete

    @staticmethod
    def _substitute(sql: str, params: List[Optional[str]]) -> str:
        import re as _re

        def repl(m):
            i = int(m.group(1)) - 1
            if i >= len(params):
                raise ValueError(f"parameter ${i + 1} not bound")
            v = params[i]
            if v is None:
                return "NULL"
            try:
                float(v)
                return v
            except ValueError:
                return "'" + v.replace("'", "''") + "'"

        return _re.sub(r"\$(\d+)", repl, sql)

    def _execute_stmt(self, sql: str) -> tuple:
        """session.execute wrapped as a Stopper task: drain waits for
        every in-flight statement (then cancels stragglers); once the
        stopper quiesces, new statements are refused with 57P01."""
        from cockroach_tpu_torch.util.stop import StopperStopped

        if self.server.draining():
            raise AdminShutdownError("server is draining")
        try:
            with self.server.stopper.task("pgwire-stmt"):
                return self.session.execute(sql)
        except StopperStopped as e:
            raise AdminShutdownError("server is draining") from e

    def _exec_portal(self, portal: str) -> tuple:
        p = self._portals[portal]
        if p["result"] is None:
            spec = p.get("spec")
            if spec is not None:
                p["result"] = self._execute_spec(spec, p["sql"])
            if p["result"] is None:
                p["result"] = self._execute_stmt(p["sql"])
        return p["result"]

    def _execute_spec(self, spec, sql: str):
        """The batched EXECUTE path, under the same drain/stopper seams
        as _execute_stmt. None -> run the normal statement path."""
        from cockroach_tpu_torch.util.stop import StopperStopped

        if self.server.draining():
            raise AdminShutdownError("server is draining")
        try:
            with self.server.stopper.task("pgwire-stmt"):
                return self.session.execute_spec(spec, sql)
        except StopperStopped as e:
            raise AdminShutdownError("server is draining") from e

    def _msg_describe(self, body: bytes):
        kind = body[0:1]
        name, _ = self._cstr(body, 1)
        if kind == b"S":
            if name not in self._stmts:
                raise ValueError(f"unknown statement {name!r}")
            _sql, n, oids = self._stmts[name]
            # ParameterDescription: declared OIDs, unknowns default text
            po = list(oids) + [OID_TEXT] * (n - len(oids))
            self._send(b"t", struct.pack(f">H{len(po)}I", len(po), *po))
            self._send(b"n")  # NoData (schema known after Bind)
            return
        # Describe(portal) may only pre-execute SIDE-EFFECT-FREE
        # statements (ADVICE r4: a client describing a DML portal without
        # executing must not apply its effects, and execution errors
        # belong to Execute) — DML/DDL portals answer NoData from the
        # text alone
        sql = self._portals[name]["sql"].lstrip()
        word = sql.split(None, 1)[0].upper() if sql else ""
        if word not in ("SELECT", "EXPLAIN", "SHOW", "VALUES"):
            self._send(b"n")  # NoData
            return
        out = self._exec_portal(name)
        kind_s, payload, schema = out
        if kind_s == "rows":
            names, _rows = self._render(payload, schema)
            self._row_desc(names)
        elif kind_s == "explain":
            self._row_desc([("info", OID_TEXT)])
        else:
            self._send(b"n")  # NoData

    def _msg_execute(self, body: bytes):
        name, off = self._cstr(body, 0)
        kind_s, payload, schema = self._exec_portal(name)
        if kind_s == "ok":
            self._complete(str(payload))
        elif kind_s == "explain":
            for line in payload:
                self._data_row([line])
            self._complete(f"EXPLAIN {len(payload)}")
        elif kind_s == "stream":  # EXPERIMENTAL CHANGEFEED over the
            # open portal: RowDescription here (Describe answered NoData
            # for non-SELECT text), then one flushed DataRow per envelope
            self._row_desc([("changefeed", OID_TEXT)])
            n = 0
            for line in payload:
                self._data_row([line])
                self._flush()
                n += 1
            self._complete(f"CHANGEFEED {n}")
        else:
            _names, rows = self._render(payload, schema)
            self._data_rows(rows)
            self._complete(f"SELECT {len(rows)}")
        self._portals[name]["result"] = None  # re-Execute re-runs

    def _msg_close(self, body: bytes):
        kind = body[0:1]
        name, _ = self._cstr(body, 1)
        if kind == b"S":
            self._stmts.pop(name, None)
        else:
            self._portals.pop(name, None)
        self._send(b"3")  # CloseComplete

    def _error(self, msg: str, code: str = "42601"):
        fields = b"SERROR\x00" + b"C" + code.encode() + b"\x00" + \
            b"M" + msg.encode() + b"\x00\x00"
        self._send(b"E", fields)
        # flushed eagerly: the handshake error paths return without ever
        # reaching a ReadyForQuery, and an early flush mid-batch is just
        # a smaller write
        self._flush()

    def simple_query(self, sql: str):
        from cockroach_tpu_torch.cli import split_statements

        stmts, rest = split_statements(sql)
        if rest.strip():
            stmts.append(rest)
        for stmt in stmts:
            try:
                self._run_one(stmt)
            except Exception as e:  # noqa: BLE001 — all errors go inband
                self._error(f"{type(e).__name__}: {e}", _pgcode(e))
                break  # v3 protocol: an error aborts the rest of the Q
        self._send(b"Z", b"I")
        self._flush()

    def _run_one(self, stmt: str):
        import re as _re

        m = _re.match(r"\s*copy\s+(\w+)\s+from\s+stdin\s*;?\s*$",
                      stmt, _re.IGNORECASE)
        if m is not None:
            self._copy_in(m.group(1))
            return
        kind, payload, schema = self._execute_stmt(stmt)
        if kind == "ok":  # DDL / DML / SET
            self._complete(str(payload))
            return
        if kind == "explain":
            self._row_desc([("info", OID_TEXT)])
            for line in payload:
                self._data_row([line])
            self._complete(f"EXPLAIN {len(payload)}")
            return
        if kind == "stream":  # EXPERIMENTAL CHANGEFEED: one envelope
            # per DataRow, flushed eagerly so the client sees events as
            # they are emitted rather than at stream end
            self._row_desc([("changefeed", OID_TEXT)])
            n = 0
            for line in payload:
                self._data_row([line])
                self._flush()
                n += 1
            self._complete(f"CHANGEFEED {n}")
            return
        names, rows = self._render(payload, schema)
        self._row_desc(names)
        self._data_rows(rows)
        self._complete(f"SELECT {len(rows)}")

    def _render(self, result: dict, schema
                ) -> Tuple[List[Tuple[str, int]], List[List[Optional[str]]]]:
        from cockroach_tpu_torch.cli import decode_column

        names = [n for n in result if not n.endswith("__valid")]
        descs: List[Tuple[str, int]] = []
        cols = []
        for n in names:
            vals = result[n]
            valid = result.get(n + "__valid")
            ty = None
            d = None
            if schema is not None:
                try:
                    ty = schema.field(n).type
                    d = schema.dictionary(n)
                except KeyError:
                    pass
            oid = _oid_for(ty) if ty is not None else (
                OID_FLOAT4 if np.issubdtype(np.asarray(vals).dtype,
                                            np.floating) else OID_INT8)
            descs.append((n, oid))
            cols.append(decode_column(vals, valid, ty, d))
        rows = list(zip(*cols)) if cols else []
        return descs, rows

    def _row_desc(self, fields: List[Tuple[str, int]]):
        payload = struct.pack(">H", len(fields))
        for name, oid in fields:
            payload += name.encode() + b"\x00"
            payload += struct.pack(">IHIhih", 0, 0, oid, -1, -1, 0)
        self._send(b"T", payload)

    def _data_row(self, values: List[Optional[str]]):
        self._data_rows([values])

    def _data_rows(self, rows):
        """All of a result's DataRow messages in one tight loop straight
        into the write buffer — the per-row hot path of the serving
        harness (a 16-client YCSB run emits tens of thousands of rows)."""
        pack_i = struct.Struct(">i").pack
        pack_hdr = struct.Struct(">IH").pack
        out = self._out
        for r in rows:
            parts = []
            for v in r:
                if v is None:
                    parts.append(b"\xff\xff\xff\xff")  # >i -1
                else:
                    b = v.encode() if type(v) is str else str(v).encode()
                    parts.append(pack_i(len(b)))
                    parts.append(b)
            payload = b"".join(parts)
            out.append(b"D" + pack_hdr(len(payload) + 6, len(r)) + payload)

    def _complete(self, tag: str):
        self._send(b"C", tag.encode() + b"\x00")


class PgServer:
    """Accept loop bound to localhost; one thread per connection.

    Lifecycle: a util/stop.Stopper tracks every in-flight statement as
    a task. drain() stops accepting connections, gives running
    statements a grace period, cancels stragglers via their sessions'
    cancel contexts, quiesces the stopper (new statements then refuse
    with 57P01), closes connections, and runs registered drain hooks
    (TSDB poller flush et al.) — the server.Drain sequence."""

    def __init__(self, catalog, capacity: int = 1 << 14,
                 host: str = "127.0.0.1", port: int = 0,
                 password: Optional[str] = None, device=None):
        from cockroach_tpu_torch import resolve_device
        from cockroach_tpu_torch.util.stop import Stopper

        self.catalog = catalog
        self.capacity = capacity
        # every connection's Session runs on this device
        self.device = resolve_device(device)
        # cleartext-password auth when set (auth.go's password method;
        # trust otherwise — TLS termination is out of scope)
        self.password = password
        self._stop = threading.Event()
        self._draining = threading.Event()
        self.stopper = Stopper()
        # cancel-key registry: (pid, secret) -> live _Conn. pids are a
        # process-local counter (there is no real backend process); the
        # secret is the actual authenticator, per the protocol.
        self._mu = threading.Lock()
        self._pid_seq = itertools.count(1)
        self._cancel_keys: Dict[Tuple[int, int], _Conn] = {}
        self._conns: List[_Conn] = []
        # callables run at the end of drain() (flush the TSDB poller,
        # final metrics sample, ...)
        self.drain_hooks: List = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr = self._sock.getsockname()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)

    def start(self) -> "PgServer":
        self._thread.start()
        _log.info(Channel.OPS,
                  f"pgwire listening on {self.addr[0]}:{self.addr[1]}")
        return self

    def stopping(self) -> bool:
        return self._stop.is_set()

    def draining(self) -> bool:
        return self._draining.is_set()

    # -- cancel keys -------------------------------------------------------

    def register_cancel_key(self, conn: "_Conn") -> Tuple[int, int]:
        pid = next(self._pid_seq)
        secret = _secrets.randbits(31)
        with self._mu:
            self._cancel_keys[(pid, secret)] = conn
        return pid, secret

    def unregister_conn(self, conn: "_Conn") -> None:
        with self._mu:
            if conn.pid is not None:
                self._cancel_keys.pop((conn.pid, conn.secret), None)
            if conn in self._conns:
                self._conns.remove(conn)

    def handle_cancel(self, pid: int, secret: int) -> bool:
        """Route a CancelRequest to the owning session. Unknown or
        stale (pid, secret) is silently ignored — the protocol sends no
        response either way, so a guessing client learns nothing."""
        with self._mu:
            conn = self._cancel_keys.get((pid, secret))
        if conn is None:
            return False
        delivered = conn.session.cancel_query("query cancelled by "
                                              "CancelRequest")
        _log.info(Channel.SQL_EXEC,
                  f"pgwire cancel: pid={pid} in_flight={delivered}")
        return delivered

    # -- serving -----------------------------------------------------------

    def _accept_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket):
        c = _Conn(conn, self)
        with self._mu:
            self._conns.append(c)
        try:
            c.serve()
        except (ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001
            _log.warning(Channel.SQL_EXEC, f"pgwire conn error: {e}")
        finally:
            self.unregister_conn(c)
            try:
                conn.close()
            except OSError:
                pass

    # -- shutdown ----------------------------------------------------------

    def _close_listener(self) -> None:
        """Stop accepting, deterministically. close() alone races with a
        blocked accept(): the in-flight syscall keeps the kernel socket
        referenced, so the port can stay in LISTEN after drain returns.
        shutdown() invalidates it immediately; joining the accept thread
        guarantees the port is released before we report drained."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(2.0)

    def drain(self, timeout: float = 10.0,
              grace: Optional[float] = None) -> dict:
        """Graceful drain under a deadline. Phases: (1) stop accepting
        and mark draining (new statements -> 57P01); (2) wait up to
        `grace` (default timeout/2) for in-flight statements; (3) cancel
        stragglers through their sessions' cancel contexts (they finish
        with 57014); (4) quiesce the stopper and close connections; (5)
        run drain hooks. Returns a summary for the ops log / harness."""
        import time as _time

        deadline = _time.monotonic() + timeout
        if grace is None:
            grace = timeout / 2.0
        self._draining.set()
        self._stop.set()
        self._close_listener()
        graceful = self.stopper.wait_idle(grace)
        cancelled = 0
        if not graceful:
            with self._mu:
                conns = list(self._conns)
            for c in conns:
                cancelled += int(
                    c.session.cancel_query("server is draining"))
            graceful = self.stopper.wait_idle(
                max(0.0, deadline - _time.monotonic()))
        forced = False
        try:
            self.stopper.stop(
                timeout=max(0.5, deadline - _time.monotonic()))
        except TimeoutError:
            forced = True  # stragglers ignored their cancel checkpoints
        with self._mu:
            conns = list(self._conns)
        for c in conns:
            # between messages only: a statement's last response (a
            # straggler's 57014) is flushed before its socket closes
            held = c.busy.acquire(
                timeout=max(0.0, deadline - _time.monotonic()))
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            finally:
                if held:
                    c.busy.release()
            try:
                c.sock.close()
            except OSError:
                pass
        for hook in self.drain_hooks:
            try:
                hook()
            except Exception as e:  # noqa: BLE001 — drain must finish
                _log.warning(Channel.OPS, f"drain hook failed: {e}")
        summary = {"graceful": graceful, "cancelled": cancelled,
                   "forced": forced, "conns_closed": len(conns)}
        _log.info(Channel.OPS, f"pgwire drain: {summary}")
        return summary

    def close(self):
        self._stop.set()
        self._close_listener()
