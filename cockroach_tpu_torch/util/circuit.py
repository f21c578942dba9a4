"""Per-stage circuit breakers for the execution ladder.

Reference: pkg/util/circuit (circuitbreaker.go) — a breaker per failing
store/replica so callers stop re-paying a known-bad path. Here each
execution tier (flow.dist, flow.fused, flow.streaming, flow.spill) gets a
breaker: after `threshold` CONSECUTIVE infrastructure failures the tier
trips OPEN and subsequent queries skip straight to the next rung instead
of re-failing (and re-compiling) the bad one. After `cooldown_s` the
breaker goes HALF-OPEN and admits exactly one probe query; a probe
success closes it, a probe failure re-opens the cooldown clock.

State is process-global (like the metric registry) and exported as
gauges `sql_resilience_breaker_state_<name>` (0 closed / 1 half-open /
2 open) plus a `sql_resilience_breaker_trips_total` counter.

Counterpart of cockroach_tpu/util/circuit.py, a copy (stdlib only). The
port's ladder (exec/operators.py run_flow) has the fused, streaming and
spill tiers; the distributed tier waits for ROADMAP.md queue 1, item 7.
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
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


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
        self._export_state()

    # ------------------------------------------------------------ state --

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
            if self._state != CLOSED:
                self._state = CLOSED
                self._export_state()

    def failure(self) -> None:
        with self._mu:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.threshold):
                self._trip()

    def reset(self) -> None:
        with self._mu:
            self._state = CLOSED
            self._failures = 0
            self._probing = False
            self._export_state()

    # --------------------------------------------------------- internal --

    def _trip(self) -> None:
        # under self._mu
        self._state = OPEN
        self._opened_at = self._clock()
        from cockroach_tpu_torch.util.metric import default_registry

        default_registry().counter(
            "sql_resilience_breaker_trips_total",
            "execution-tier circuit breakers tripped open").inc()
        self._export_state()

    def _maybe_half_open(self) -> None:
        # under self._mu
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = HALF_OPEN
            self._probing = False
            self._export_state()

    def _export_state(self) -> None:
        from cockroach_tpu_torch.util.metric import default_registry

        default_registry().gauge(
            "sql_resilience_breaker_state_" + self.name.replace(".", "_"),
            "breaker state: 0 closed / 1 half-open / 2 open",
        ).set(_STATE_GAUGE[self._state])


_mu = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}


def breaker(name: str) -> CircuitBreaker:
    """The process-wide breaker for a named stage (created on first use)."""
    with _mu:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(name)
        return b


def all_breakers() -> Dict[str, CircuitBreaker]:
    with _mu:
        return dict(_breakers)


def reset_all() -> None:
    """Close every breaker (test hygiene between chaos cases)."""
    with _mu:
        bs = list(_breakers.values())
    for b in bs:
        b.reset()
