"""Query cancellation + statement deadlines.

Reference: pkg/sql/cancelchecker (cancel_checker.go) — long-running
operators poll a cancellation checker derived from the statement's
context; pgwire's CancelRequest and `statement_timeout` both resolve to
the same context cancellation, surfacing as SQLSTATE 57014
(query_canceled) with the session left healthy for the next statement.

This slice is the Python analog: a `CancelContext` per executing
statement (owned by sql/session.Session, set asynchronously by the
pgwire cancel path or synchronously by the deadline), installed in a
thread-local so pipeline seams can call the module-level `checkpoint()`
without plumbing. Checkpoints are polled at the flow-driver seams
(exec/operators.py `_run_tier` per batch and per ladder tier, retry
backoff sleeps, the prefetch consumer loop, the fused dispatch) — cheap
enough to sit on the hot path (one attribute read when nothing is
active) yet frequent enough that a cancel lands within one batch or one
backoff interval.

Threading: the context is installed on the DRIVING thread only.
Producer threads (scan prefetch) see no active context and their
checkpoints no-op; abandoning the consumer-side stream closes the
producer (the existing `_prefetch` drain contract), so cancelling the
driver cancels the whole flow.

Counterpart of cockroach_tpu/util/cancel.py, a copy (stdlib only). The
port's checkpoints: exec/operators.py `_run_tier` (before each attempt,
before each batch and after the last, before a retry's backoff) and the
ladder before each tier,
the prefetch consumer's 0.1 s poll, exec/fused.py before a run (ahead of
its capture or replay, never inside the capture), util/retry.py
`with_retry` before each backoff, and util/admission.py's queue waits.
A CUDA graph replay is not interruptible: on the fused tier a cancel
lands after the replay in flight, on the streaming tier after the batch
in flight; the external sort's host merge has no checkpoint.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional


class QueryCancelled(Exception):
    """The statement was cancelled (client CancelRequest, session drain)
    or overran its deadline (`statement_timeout`). pgwire maps this to
    SQLSTATE 57014 query_canceled; the session survives and serves the
    next statement."""

    pgcode = "57014"


class CancelContext:
    """Cancellation state for ONE executing statement: an async cancel
    flag (set from any thread) plus an optional monotonic deadline."""

    __slots__ = ("_ev", "deadline", "reason")

    def __init__(self, timeout: Optional[float] = None):
        self._ev = threading.Event()
        self.deadline = (time.monotonic() + timeout
                         if timeout and timeout > 0 else None)
        self.reason = "query cancelled"

    def cancel(self, reason: str = "query cancelled") -> None:
        """Request cancellation (called from the pgwire cancel thread or
        the drain path; safe from any thread, idempotent)."""
        if not self._ev.is_set():
            self.reason = reason
            self._ev.set()

    def cancelled(self) -> bool:
        if self._ev.is_set():
            return True
        if self.deadline is not None and time.monotonic() > self.deadline:
            self.reason = "statement timeout reached"
            self._ev.set()
            return True
        return False

    def checkpoint(self) -> None:
        """Raise QueryCancelled if cancellation was requested or the
        deadline passed. The per-seam poll."""
        if self.cancelled():
            raise QueryCancelled(self.reason)


_local = threading.local()


@contextmanager
def active(ctx: Optional[CancelContext]):
    """Install `ctx` as this thread's active cancel context for the
    duration (statement scope; nests, restoring the outer context)."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def current() -> Optional[CancelContext]:
    return getattr(_local, "ctx", None)


def checkpoint() -> None:
    """Poll the active context (no-op when none / on producer threads)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None:
        ctx.checkpoint()
