"""Hierarchical memory accounting.

A copy of cockroach_tpu/util/mon.py (host-only). Reference:
pkg/util/mon/bytes_usage.go:174 (`mon.BytesMonitor`) and :904
(`BoundAccount`). An allocation is accounted against a monitor;
exceeding the budget raises BudgetExceededError. The port accounts the
device memory its resident scan images hold this way
(exec/operators.py hbm_cache_monitor).
"""

from __future__ import annotations

import threading
from typing import Optional


class BudgetExceededError(MemoryError):
    """Raised when an allocation would exceed the monitor budget.

    The execution-layer analog of the reference's budget-exceeded panic that
    `CatchVectorizedRuntimeError` converts into a spill
    (colexecerror/error.go:45).
    """

    def __init__(self, monitor_name: str, requested: int, budget: int, used: int):
        super().__init__(
            f"memory budget exceeded in {monitor_name}: "
            f"requested {requested}, used {used}, budget {budget}"
        )
        self.monitor_name = monitor_name
        self.requested = requested
        self.budget = budget
        self.used = used


class BytesMonitor:
    """A node in the memory-accounting tree (reference mon.BytesMonitor:174)."""

    def __init__(
        self,
        name: str,
        budget: Optional[int] = None,
        parent: Optional["BytesMonitor"] = None,
    ):
        self.name = name
        self.budget = budget  # None = unlimited (inherits parent's limit)
        self.parent = parent
        self._mu = threading.Lock()
        self._used = 0
        self._peak = 0

    @property
    def used(self) -> int:
        return self._used

    @property
    def peak(self) -> int:
        return self._peak

    def child(self, name: str, budget: Optional[int] = None) -> "BytesMonitor":
        return BytesMonitor(name, budget=budget, parent=self)

    def make_account(self) -> "BoundAccount":
        return BoundAccount(self)

    def _grow(self, n: int) -> None:
        with self._mu:
            if self.budget is not None and self._used + n > self.budget:
                raise BudgetExceededError(self.name, n, self.budget, self._used)
            self._used += n
            self._peak = max(self._peak, self._used)
        if self.parent is not None:
            try:
                self.parent._grow(n)
            except BudgetExceededError:
                with self._mu:
                    self._used -= n
                raise

    def _shrink(self, n: int) -> None:
        with self._mu:
            self._used = max(0, self._used - n)
        if self.parent is not None:
            self.parent._shrink(n)


class BoundAccount:
    """A single consumer's slice of a monitor (reference BoundAccount:904)."""

    def __init__(self, monitor: BytesMonitor):
        self.monitor = monitor
        self.used = 0

    def grow(self, n: int) -> None:
        self.monitor._grow(n)
        self.used += n

    def shrink(self, n: int) -> None:
        n = min(n, self.used)
        self.monitor._shrink(n)
        self.used -= n

    def resize(self, new_size: int) -> None:
        if new_size > self.used:
            self.grow(new_size - self.used)
        else:
            self.shrink(self.used - new_size)

    def clear(self) -> None:
        self.shrink(self.used)

    def close(self) -> None:
        self.clear()

    def __enter__(self) -> "BoundAccount":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
