"""Stopper: structured task lifecycle + quiescence.

A copy of cockroach_tpu/util/stop.py (host-only). Reference:
pkg/util/stop (stopper.go:152): every background thread registers with
a Stopper; stop() signals quiescence, waits for tasks to drain, then
runs closers LIFO. The flow runtime's prefetch threads
(exec/operators.py _prefetch) register here.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List


class StopperStopped(Exception):
    """Task refused: the stopper is already stopping (ErrUnavailable)."""


class Stopper:
    def __init__(self):
        self._mu = threading.Lock()
        self._stopping = threading.Event()
        self._tasks = 0
        self._idle = threading.Condition(self._mu)
        self._closers: List[Callable[[], None]] = []

    # -- tasks -------------------------------------------------------------

    @contextmanager
    def task(self, name: str = ""):
        """Run a unit of work that Stop() must wait for."""
        with self._mu:
            if self._stopping.is_set():
                raise StopperStopped(name)
            self._tasks += 1
        try:
            yield self
        finally:
            with self._mu:
                self._tasks -= 1
                if self._tasks == 0:
                    self._idle.notify_all()

    def run_worker(self, fn: Callable[[], None], name: str = "") -> threading.Thread:
        """Spawn a worker thread tracked as a task (RunAsyncTask)."""

        def body():
            try:
                with self.task(name):
                    fn()
            except StopperStopped:
                pass

        t = threading.Thread(target=body, name=name or "stopper-worker")
        t.start()
        return t

    # -- lifecycle ---------------------------------------------------------

    @property
    def should_stop(self) -> bool:
        """Workers poll this (ShouldQuiesce channel analog)."""
        return self._stopping.is_set()

    def add_closer(self, fn: Callable[[], None]) -> None:
        with self._mu:
            self._closers.append(fn)

    @property
    def num_tasks(self) -> int:
        with self._mu:
            return self._tasks

    def wait_idle(self, timeout: float) -> bool:
        """Wait (bounded) for in-flight tasks to reach zero WITHOUT
        quiescing — new tasks may still start. The drain path's first
        phase: give running statements their grace period, then decide
        whether stragglers need cancelling."""
        import time as _time

        deadline = _time.monotonic() + max(0.0, timeout)
        with self._mu:
            while self._tasks > 0:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    def stop(self, timeout: float = 30.0) -> None:
        """Quiesce: refuse new tasks, wait for in-flight ones, run closers
        LIFO (stopper.go Stop())."""
        self._stopping.set()
        with self._mu:
            while self._tasks > 0:
                if not self._idle.wait(timeout):
                    raise TimeoutError("stopper: tasks did not drain")
            closers = list(reversed(self._closers))
            self._closers.clear()
        for c in closers:
            c()
