"""Per-tier circuit breakers for the execution ladder.

A host-only copy of cockroach_tpu/util/circuit.py (reference:
pkg/util/circuit). Each tier of exec/operators.py run_flow (flow.fused,
flow.streaming) has a process-wide breaker: after `threshold`
CONSECUTIVE failures the tier trips OPEN and later queries skip to the
next rung. After `cooldown_s` it goes HALF-OPEN and admits one probe
query; a probe success closes it, a probe failure opens it again. The
JAX package's state gauges wait for util/metric.py (ROADMAP.md queue 1,
item 8); `state()` reads the state.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from cockroach_tpu_torch.util.settings import Settings

BREAKER_THRESHOLD = Settings.register(
    "sql.resilience.breaker_threshold",
    5,
    "consecutive tier failures before its breaker trips open",
)
BREAKER_COOLDOWN = Settings.register(
    "sql.resilience.breaker_cooldown_s",
    10.0,
    "seconds an open breaker waits before admitting a half-open probe",
)

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"


class CircuitBreaker:
    """Consecutive-failure breaker with a timed half-open probe."""

    def __init__(self, name: str, threshold: int = 0,
                 cooldown_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        s = Settings()
        self.name = name
        self.threshold = threshold or int(s.get(BREAKER_THRESHOLD))
        self.cooldown_s = (cooldown_s if cooldown_s > 0
                           else float(s.get(BREAKER_COOLDOWN)))
        self._clock = clock
        self._mu = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive
        self._opened_at = 0.0
        self._probing = False       # a half-open probe is in flight

    def state(self) -> str:
        with self._mu:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May the caller attempt this tier now? OPEN -> no; HALF_OPEN ->
        yes for exactly one in-flight probe; CLOSED -> yes."""
        with self._mu:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def success(self) -> None:
        with self._mu:
            self._failures = 0
            self._probing = False
            self._state = CLOSED

    def failure(self) -> None:
        with self._mu:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.threshold):
                self._state = OPEN
                self._opened_at = self._clock()

    def reset(self) -> None:
        with self._mu:
            self._state = CLOSED
            self._failures = 0
            self._probing = False

    def _maybe_half_open(self) -> None:
        # under self._mu
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = HALF_OPEN
            self._probing = False


_mu = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}


def breaker(name: str) -> CircuitBreaker:
    """The process-wide breaker for a named tier (created on first use)."""
    with _mu:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(name)
        return b


def reset_all() -> None:
    """Close every breaker (test hygiene between fault cases)."""
    with _mu:
        bs = list(_breakers.values())
    for b in bs:
        b.reset()
