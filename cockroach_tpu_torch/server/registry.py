"""Process-wide live query/session registry — the SessionRegistry analog.

Reference: pkg/sql/conn_executor.go's SessionRegistry — every session and
every executing statement is registered so `SHOW QUERIES`/`SHOW SESSIONS`
and `CANCEL QUERY <id>` can see and reach them from ANY connection. The
query id is stable and node-scoped: (node_id << 32) | local counter, the
same scheme server/jobs.py uses for job ids.

Layout is chosen for the per-statement hot path: the registry itself
holds only SESSIONS (registered once per connection, by weakref); each
live statement is an entry appended to its owning session's
`_active_stmts` list. Registering a statement is therefore a list append
plus an entry construction — no global dict churn, no lock, no
thread-local — and `SHOW QUERIES`/`CANCEL QUERY` (rare, human-paced)
pay the cost of walking the registered sessions instead. List append/pop
and the snapshot reads are single bytecode ops, atomic under the GIL.

Lifecycle contract (enforced at the Session.execute/execute_spec seams):
`register()` CREATES the statement's CancelContext — the QueryEntry
subclasses it, so the one per-statement allocation the execute path
always made now carries the registry row too — and runs BEFORE
admission, so an admission-queued statement is already visible and
cancellable (WorkQueue.acquire polls the context in its wait slices);
`deregister()` runs in the same `finally` that clears the session's
active cancel context, so every exit path — success, error, shed, drain,
cancel — removes the entry. A leaked entry is a bug the concurrency
tests assert against.

Cold-path statements (`track=True`) additionally push their entry on a
thread-local stack so deeper layers (the plan/compile pipeline in
sql/explain.py) can flip the phase of "their" statement without plumbing
ids through every call signature; warm serving-path statements skip the
stack — their phase is final at registration.

Counterpart of cockroach_tpu/server/registry.py, a copy (stdlib only).
sql/session.py `Session.execute` registers every statement (a warm
serving-path statement in `serving-batched`, untracked) and
`execute_spec` registers the bound statements pgwire serves; CANCEL
QUERY reaches the local registry only: routing a cancel to another
node's registry (`route_cancel`) waits for item 8e.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional

from cockroach_tpu_torch.util.cancel import CancelContext

# statement phases, in lifecycle order (SHOW QUERIES' `phase` column)
PHASE_QUEUED = "queued"
PHASE_COMPILING = "compiling"
PHASE_EXECUTING = "executing"
PHASE_SERVING = "serving-batched"

# wall = perf_counter + offset, captured once: entries store only a
# perf_counter stamp (usually the one the statement already read for
# its own latency accounting — zero extra clock reads) and snapshots
# derive the wall time for display. NTP steps after process start skew
# displayed start times, which monitoring tolerates.
_WALL_OFFSET = time.time() - time.perf_counter()


class QueryEntry(CancelContext):
    """One executing statement (the registry's row in cluster_queries)
    — and its CancelContext: the statement needs one cancellation
    object per execution anyway, so the registry row IS that object.
    Registering a statement therefore allocates NOTHING beyond what the
    pre-registry execute path already allocated; it adds five slot
    writes. The fingerprint is computed at snapshot time (lru-cached in
    sqlstats), not at registration."""

    __slots__ = ("query_id", "session_id", "sql", "phase", "start_pc")

    def __init__(self, query_id: int, session_id: int, sql: str,
                 timeout: Optional[float] = None,
                 phase: str = PHASE_QUEUED,
                 start_pc: Optional[float] = None):
        CancelContext.__init__(self, timeout)
        self.query_id = query_id
        self.session_id = session_id
        self.sql = sql
        self.phase = phase
        self.start_pc = (time.perf_counter() if start_pc is None
                         else start_pc)

    def as_dict(self) -> dict:
        from cockroach_tpu_torch.sql.sqlstats import fingerprint

        return {
            "query_id": self.query_id,
            "session_id": self.session_id,
            "phase": self.phase,
            "start_unix": round(_WALL_OFFSET + self.start_pc, 3),
            "elapsed_s": round(time.perf_counter() - self.start_pc, 4),
            "fingerprint": fingerprint(self.sql),
            "sql": self.sql[:200],
        }


class SessionEntry:
    """One live session (cluster_sessions row). The session object is
    held by weakref: a dropped connection garbage-collects its row.
    Statement counts live ON the session (`_stmt_total`, bumped without
    a lock — a lost increment under thread preemption is tolerable) and
    `active_queries` is the live length of its `_active_stmts` list, so
    leak-freedom follows from the per-session lists draining."""

    __slots__ = ("session_id", "start_wall", "ref")

    def __init__(self, session_id: int, ref):
        self.session_id = session_id
        self.start_wall = time.time()
        self.ref = ref  # weakref.ref to the session

    def as_dict(self, statements: int = 0, active: int = 0) -> dict:
        return {
            "session_id": self.session_id,
            "start_unix": round(self.start_wall, 3),
            "statements": statements,
            "active_queries": active,
        }


class QueryRegistry:
    """Thread-safe registry of live sessions and executing statements."""

    def __init__(self, node_id: int = 1):
        self.node_id = node_id
        self._mu = threading.Lock()
        self._sessions: Dict[int, SessionEntry] = {}
        self._next_local = itertools.count(1)
        self._tls = threading.local()

    # ------------------------------------------------------------ sessions

    def register_session(self, session) -> None:
        """Track a session for SHOW SESSIONS; a weakref finalizer removes
        the row when the session object is collected."""
        if getattr(session, "_active_stmts", None) is None:
            session._active_stmts = []
            session._stmt_total = 0
        sid = session.session_id
        with self._mu:
            if sid in self._sessions:
                return
            self._sessions[sid] = SessionEntry(sid, weakref.ref(session))
        weakref.finalize(session, self._drop_session, sid)

    def _drop_session(self, session_id: int) -> None:
        with self._mu:
            self._sessions.pop(session_id, None)

    # ------------------------------------------------------- query lifecycle

    def register(self, session, sql: str,
                 timeout: Optional[float] = None,
                 phase: str = PHASE_QUEUED,
                 track: bool = False,
                 start_pc: Optional[float] = None) -> QueryEntry:
        """-> the live QueryEntry, which doubles as the statement's
        CancelContext (its query_id is stable: (node_id << 32) |
        counter). Pass track=True for cold-path statements so the
        compile pipeline can set_phase_current(); warm-path phases are
        final at registration and skip the thread-local entirely.
        `start_pc` lets the caller donate the perf_counter stamp it
        already read for latency accounting, so registration itself
        reads no clock."""
        stmts = getattr(session, "_active_stmts", None)
        if stmts is None:  # session built outside Session.__init__
            self.register_session(session)
            stmts = session._active_stmts
        entry = QueryEntry((self.node_id << 32) | next(self._next_local),
                           session.session_id, sql, timeout, phase,
                           start_pc)
        session._stmt_total += 1
        stmts.append(entry)
        if track:
            stack = getattr(self._tls, "stack", None)
            if stack is None:
                stack = self._tls.stack = []
            stack.append(entry)
        return entry

    def deregister(self, session, entry: QueryEntry,
                   track: bool = False) -> None:
        """Every exit path runs this — it rides the same statement
        finally block as cancel cleanup. Lock-free: the common case is
        one list pop (statements nest LIFO within a session). Pass the
        same `track` the register() call used so warm-path statements
        skip the thread-local entirely."""
        stmts = session._active_stmts
        if stmts and stmts[-1] is entry:
            stmts.pop()
        else:  # out-of-order completion (concurrent use of one session)
            try:
                stmts.remove(entry)
            except ValueError:
                pass
        if track:
            stack = getattr(self._tls, "stack", None)
            if stack and stack[-1] is entry:
                stack.pop()

    def set_phase_current(self, phase: str) -> None:
        """Flip the phase of the statement the CALLING thread registered
        with track=True (the plan/compile pipeline tags compiling ->
        executing without threading ids through every signature)."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1].phase = phase

    def current_query_id(self) -> Optional[int]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1].query_id if stack else None

    # ------------------------------------------------------------- cancel

    def cancel(self, query_id: int,
               reason: str = "CANCEL QUERY") -> bool:
        """Route a cancel to the owning statement's CancelContext — the
        cross-session `CANCEL QUERY <id>` path. Safe from any thread;
        returns whether the id named a live statement."""
        for entry in self._live_entries():
            if entry.query_id == query_id:
                entry.cancel(reason)
                return True
        return False

    # ---------------------------------------------------------- snapshots

    def _live_sessions(self) -> List[tuple]:
        """[(SessionEntry, session)] for sessions still alive."""
        with self._mu:
            entries = list(self._sessions.values())
        out = []
        for se in entries:
            s = se.ref()
            if s is not None:
                out.append((se, s))
        return out

    def _live_entries(self) -> List[QueryEntry]:
        out: List[QueryEntry] = []
        for _, s in self._live_sessions():
            out.extend(list(s._active_stmts))
        return out

    def queries(self) -> List[dict]:
        rows = [e.as_dict() for e in self._live_entries()]
        rows.sort(key=lambda r: r["query_id"])
        return rows

    def sessions(self) -> List[dict]:
        rows = [se.as_dict(getattr(s, "_stmt_total", 0),
                           len(s._active_stmts))
                for se, s in self._live_sessions()]
        rows.sort(key=lambda r: r["session_id"])
        return rows

    def query_count(self) -> int:
        return sum(len(s._active_stmts)
                   for _, s in self._live_sessions())

    def reset(self) -> None:
        """Test hook: drop all live statement rows (sessions stay
        registered; their active lists are emptied)."""
        for _, s in self._live_sessions():
            del s._active_stmts[:]


_default = QueryRegistry()


def default_query_registry() -> QueryRegistry:
    return _default
