"""Admission control: slot-based work queues with priority ordering.

Reference: pkg/util/admission — CPU slots + token buckets shape both KV
and SQL work so overload degrades gracefully instead of collapsing
(io_load_listener.go derives IO tokens from LSM health; the WorkQueue
orders waiters by (priority, create time)).

This slice provides the WorkQueue the flow runtime gates on: a
fixed-slot pool with priority-FIFO waiters, context-manager acquisition,
and gauges for observability. The flow runtime acquires one slot per
running flow when `sql.tpu.admission_slots` is set (> 0), bounding
concurrent device-program dispatch the way the reference bounds
goroutine parallelism.

Counterpart of cockroach_tpu/util/admission.py, a copy (stdlib only):
`WorkQueue`, `flow_queue`, `session_queue` and `IOLoadListener` (over the
port's storage engine, whose `stats()` reports its run count). The
setting keys are the JAX package's, and both slot settings default to 0
(admission off). exec/operators.py `run_flow` takes one flow slot per
flow; sql/session.py takes one session slot per work statement (53300
on a shed). A fused run's replays serialize on their runner's lock
(exec/fused.py), which is taken after the flow slot and never held
while waiting for one.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from contextlib import contextmanager

from cockroach_tpu_torch.util.metric import Gauge, default_registry
from cockroach_tpu_torch.util.settings import Settings

ADMISSION_SLOTS = Settings.register(
    "sql.tpu.admission_slots",
    0,
    "max concurrently admitted flows (0 = admission control off)",
)

# priorities (higher admits first; reference admissionpb work priorities)
HIGH = 2
NORMAL = 1
LOW = 0


class WorkQueue:
    """Condition-variable design: enqueue-then-wait under ONE lock, so
    there is no lost-wakeup window and a timeout can't strand a slot —
    the slot count is only ever changed by the thread that proceeds.

    Ordering is priority-FIFO with an anti-starvation rotation: every
    ANTI_STARVATION_EVERY-th grant goes to the OLDEST waiter regardless
    of priority (the reference's epoch-LIFO queues solve the same
    problem from the other end), so sustained HIGH traffic cannot pin a
    LOW waiter in the queue until its timeout sheds it.

    Waits are sliced so a queued statement polls its cancel context: a
    CancelRequest (or statement deadline) aborts work that is still
    WAITING for a slot, not just work that is running."""

    ANTI_STARVATION_EVERY = 4
    _WAIT_SLICE = 0.05

    def __init__(self, slots: int, name: str = "admission"):
        self.slots = slots
        self._cv = threading.Condition()
        self._available = slots
        self._waiters: list = []  # heap of (-prio, seq); head admits next
        self._seq = itertools.count()
        self._grants = 0
        self._retired = False
        # gauges come from the registry so a slot-count swap REUSES the
        # same metric objects instead of leaking orphaned ones (and they
        # show on /_status/vars); the retired flag keeps a swapped-out
        # queue's in-flight releases from clobbering its successor's view
        reg = default_registry()
        self.used = reg.gauge(f"{name}.slots_used",
                              "admission slots currently held")
        self.waiting = reg.gauge(f"{name}.waiting",
                                 "waiters queued for an admission slot")
        self.queue_wait = reg.histogram(
            f"{name}.queue_wait_seconds",
            "time spent queued before a slot was granted (or shed)",
            buckets=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     5.0, 30.0))
        self.timeouts = reg.counter(
            "admission.timeouts_total",
            "admission waits that timed out (work shed under overload)")
        self._publish()

    def retire(self) -> None:
        """Stop publishing gauges (the successor queue owns them now);
        slots held here still release correctly."""
        with self._cv:
            self._retired = True

    def _publish(self) -> None:
        if self._retired:
            return
        self.used.set(self.slots - self._available)
        self.waiting.set(len(self._waiters))

    def _head(self):
        """The waiter the next free slot belongs to."""
        if not self._waiters:
            return None
        if self._grants % self.ANTI_STARVATION_EVERY == \
                self.ANTI_STARVATION_EVERY - 1:
            return min(self._waiters, key=lambda w: w[1])  # oldest seq
        return self._waiters[0]  # highest priority, then FIFO

    def _remove(self, me) -> None:
        self._waiters.remove(me)
        heapq.heapify(self._waiters)
        self._publish()

    def acquire(self, priority: int = NORMAL,
                timeout: float = 60.0) -> None:
        """Block until a slot is granted; raises TimeoutError (shed) or
        QueryCancelled (statement cancelled while queued). The caller
        owns exactly one release() on success — the session layer pairs
        them in try/finally so shed/cancel cannot leak a slot."""
        import time as _time

        from cockroach_tpu_torch.util import cancel as _cancel

        start = _time.monotonic()
        me = (-priority, next(self._seq))
        deadline = start + timeout
        with self._cv:
            heapq.heappush(self._waiters, me)
            self._publish()
            while not (self._available > 0 and self._head() == me):
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    # the timeout races with a release(): the slot may
                    # have become ours between the wait expiring and
                    # reacquiring the lock — re-check before shedding,
                    # or an available slot would sit idle while we fail
                    if self._available > 0 and self._head() == me:
                        break
                    self._remove(me)
                    self._cv.notify_all()  # head may have changed
                    self.timeouts.inc()
                    self.queue_wait.observe(_time.monotonic() - start)
                    raise TimeoutError("admission wait timed out")
                # adaptive wait slice: bounded by the admission timeout
                # AND the statement's own cancel deadline, so a 20 ms
                # statement_timeout aborts at ~20 ms instead of at the
                # next 50 ms slice boundary (a 2.5x overshoot while
                # queued)
                wait = min(remaining, self._WAIT_SLICE)
                ctx = _cancel.current()
                if ctx is not None and ctx.deadline is not None:
                    wait = min(wait, max(
                        ctx.deadline - _time.monotonic(), 0.0) + 0.001)
                self._cv.wait(max(wait, 0.001))
                try:
                    _cancel.checkpoint()
                except BaseException:
                    self._remove(me)
                    self._cv.notify_all()
                    raise
            self._remove(me)
            self._available -= 1
            self._grants += 1
            self._publish()
        self.queue_wait.observe(_time.monotonic() - start)

    @contextmanager
    def admit(self, priority: int = NORMAL, timeout: float = 60.0):
        self.acquire(priority, timeout)
        try:
            yield
        finally:
            self.release()

    def release(self) -> None:
        with self._cv:
            self._available += 1
            self._publish()
            self._cv.notify_all()


_queue = None
_queue_slots = None
_queue_mu = threading.Lock()


def flow_queue():
    """Process-wide flow admission queue per the setting; None = off.
    (Changing the slot count mid-flight swaps in a fresh queue — slots
    held on the old queue drain independently, matching the reference's
    lazy application of admission setting changes. The old queue is
    retired so the registry gauges — shared by name with its successor —
    publish only the live queue's state.)"""
    global _queue, _queue_slots
    slots = int(Settings().get(ADMISSION_SLOTS))
    if slots <= 0:
        return None
    with _queue_mu:
        if _queue is None or _queue_slots != slots:
            if _queue is not None:
                _queue.retire()
            _queue = WorkQueue(slots, "flow")
            _queue_slots = slots
        return _queue


# ------------------------------------------------- session-layer admission

SESSION_SLOTS = Settings.register(
    "sql.admission.session_slots",
    0,
    "max concurrently executing statements across all sessions "
    "(0 = session admission off); excess waiters queue by priority and "
    "shed with SQLSTATE 53300 after sql.admission.queue_timeout_s",
)

SESSION_QUEUE_TIMEOUT = Settings.register(
    "sql.admission.queue_timeout_s",
    5.0,
    "how long a statement may wait for a session admission slot before "
    "being shed",
)

_session_queue = None
_session_queue_slots = None


def session_queue():
    """Process-wide statement admission queue gating sql/session.py
    execution (the frontend analog of flow_queue, which bounds device
    dispatch below it); None = off."""
    global _session_queue, _session_queue_slots
    slots = int(Settings().get(SESSION_SLOTS))
    if slots <= 0:
        return None
    with _queue_mu:
        if _session_queue is None or _session_queue_slots != slots:
            if _session_queue is not None:
                _session_queue.retire()
            _session_queue = WorkQueue(slots, "sql.admission")
            _session_queue_slots = slots
        return _session_queue


# ------------------------------------------------------------- IO tokens --

IO_RUNS_OVERLOAD = Settings.register(
    "admission.io.runs_overload_threshold",
    6,
    "LSM run count at which write admission begins throttling "
    "(io_load_listener.go's L0 sublevel threshold analog)",
)

IO_TOKENS_PER_TICK = Settings.register(
    "admission.io.tokens_per_tick",
    4096,
    "write tokens granted per tick when the engine is healthy",
)


class IOLoadListener:
    """Derive write-admission tokens from storage-engine health — the
    io_load_listener.go design: each tick inspects the LSM shape (run
    count = the L0 sublevel analog, memtable bytes) and grants the next
    tick's write tokens; overload shrinks grants multiplicatively so
    compactions catch up instead of the run stack growing without bound.

    Deterministic (tick-driven, no wall clock): callers pump `tick()`
    (the kvserver Cluster pump or a store maintenance loop) and writes
    `acquire(n)` tokens; `False` means shed/defer the write."""

    def __init__(self, engine, name: str = "io"):
        self.engine = engine
        self._mu = threading.Lock()
        self._tokens = float(int(Settings().get(IO_TOKENS_PER_TICK)))
        self.granted = Gauge(f"{name}.tokens_granted")
        self.throttled = Gauge(f"{name}.tokens_exhausted_denials")
        self._denials = 0

    def tick(self) -> float:
        """Grant next-tick tokens from current engine health; returns the
        grant (also exposed via the gauge)."""
        base = float(int(Settings().get(IO_TOKENS_PER_TICK)))
        threshold = int(Settings().get(IO_RUNS_OVERLOAD))
        try:
            stats = self.engine.stats()
            runs = int(stats.get("runs", 0))
        except Exception:
            runs = 0
        if runs <= threshold:
            grant = base
        else:
            # multiplicative backoff with run-count overload depth, with
            # a floor so writers always make SOME progress (the reference
            # never fully stalls regular writes either)
            grant = max(base / (2.0 ** (runs - threshold)), base / 64.0)
        with self._mu:
            self._tokens = min(self._tokens + grant, 2 * base)
        self.granted.set(int(grant))
        return grant

    def acquire(self, n: int = 1) -> bool:
        """Consume n write tokens; False = throttled (caller defers)."""
        with self._mu:
            if self._tokens >= n:
                self._tokens -= n
                return True
            self._denials += 1
            self.throttled.set(self._denials)
            return False
