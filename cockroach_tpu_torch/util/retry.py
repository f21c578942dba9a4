"""Retry with exponential backoff, and the execution-error classifier.

A host-only copy of cockroach_tpu/util/retry.py. The classifier splits
transient faults (retry in place under the backoff policy) from
resource exhaustion (step the degradation ladder of exec/operators.py
run_flow down a tier) and terminal errors (propagate unchanged). It
keeps only the branches whose exception types the port has:

- RESOURCE: torch.cuda.OutOfMemoryError, MemoryError (the memory
  monitor's BudgetExceededError is one), and a message naming an
  out-of-memory condition;
- TERMINAL: a cancelled statement (util/cancel.py QueryCancelled,
  checked first: its "statement timeout reached" must not read as a
  transient fault, be retried, step the ladder down or trip a
  breaker), a CUDA error (a failed launch, an illegal address), checked
  before the message tokens, and everything not listed;
- RETRYABLE: an injected fault (util/fault.py InjectedFault), FlowRestart
  (surfaced only after the widening attempts ran out), ConnectionError,
  TimeoutError and the transient tokens.

A retry counts in the metric registry (`sql_resilience_retries_total`,
`sql_resilience_retry_backoff_seconds`), in the per-query stats as
`resilience.retry.<name>` and as a `retry` event on the active trace
span; `with_retry` polls the statement's cancel context before each
backoff. The JAX package's RetriesExhausted wrapper is not used: the
last error is raised again, unwrapped, in both packages' loops.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, TypeVar

import torch

from cockroach_tpu_torch.util import cancel
from cockroach_tpu_torch.util.settings import Settings

# -------------------------------------------------------------- settings

RESILIENCE_MAX_RETRIES = Settings.register(
    "sql.resilience.max_retries",
    6,
    "in-place retries of a transient fault before degrading/failing",
)
RESILIENCE_INITIAL_BACKOFF = Settings.register(
    "sql.resilience.initial_backoff_s",
    0.01,
    "first retry backoff in seconds (doubles per attempt up to the max)",
)
RESILIENCE_MAX_BACKOFF = Settings.register(
    "sql.resilience.max_backoff_s",
    1.0,
    "backoff ceiling in seconds",
)
RESILIENCE_BACKOFF_MULTIPLIER = Settings.register(
    "sql.resilience.backoff_multiplier",
    2.0,
    "backoff growth factor per retry",
)
RESILIENCE_JITTER = Settings.register(
    "sql.resilience.jitter",
    0.25,
    "backoff jitter fraction (sleep in [b*(1-j), b*(1+j)])",
)

# ------------------------------------------------------- classification

RETRYABLE = "retryable"   # transient: retry in place under backoff
RESOURCE = "resource"     # capacity: step the degradation ladder down
TERMINAL = "terminal"     # user/logic error: propagate unchanged

_OOM_TOKENS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_TRANSIENT_TOKENS = ("UNAVAILABLE", "ABORTED", "DATA_LOSS",
                     "transfer failed", "DEADLINE_EXCEEDED")
# a fault of the device or of a kernel: the same program would fail
# again, and no cheaper tier may hide it
_CUDA_ERROR_TOKENS = ("CUDA error", "illegal memory access",
                      "illegal address", "launch failed")


def classify(exc: BaseException) -> str:
    """One verdict per exception: RETRYABLE / RESOURCE / TERMINAL."""
    if isinstance(exc, cancel.QueryCancelled):
        # checked before the token matchers: the cancellation reason may
        # mention "timeout", which must not read as a transient fault —
        # a cancelled statement is dead, not retryable
        return TERMINAL
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return RESOURCE
    from cockroach_tpu_torch.util.fault import InjectedFault

    if isinstance(exc, InjectedFault):
        return RETRYABLE
    from cockroach_tpu_torch.exec.operators import FlowRestart

    if isinstance(exc, FlowRestart):
        return RETRYABLE
    msg = str(exc)
    if any(tok in msg for tok in _CUDA_ERROR_TOKENS):
        return TERMINAL
    if any(tok in msg for tok in _OOM_TOKENS):
        return RESOURCE
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return RETRYABLE
    if any(tok in msg for tok in _TRANSIENT_TOKENS):
        return RETRYABLE
    return TERMINAL


# ------------------------------------------------------------- Options

@dataclass
class Options:
    """Backoff policy (reference: retry.Options, pkg/util/retry/retry.go).
    `sleep` is injectable so tests run clockless."""

    initial_backoff: float = 0.05
    max_backoff: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.15
    max_retries: int = 5          # attempts = max_retries + 1
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=lambda: random.Random(0x5eed))

    def backoffs(self):
        """The jittered sleep for each retry, in order (len = max_retries)."""
        b = self.initial_backoff
        for _ in range(self.max_retries):
            j = self.jitter
            yield max(0.0, b * (1 + self.rng.uniform(-j, j)))
            b = min(b * self.multiplier, self.max_backoff)


def options_from_settings() -> Options:
    """The process-wide `sql.resilience.*` policy."""
    s = Settings()
    return Options(
        initial_backoff=float(s.get(RESILIENCE_INITIAL_BACKOFF)),
        max_backoff=float(s.get(RESILIENCE_MAX_BACKOFF)),
        multiplier=float(s.get(RESILIENCE_BACKOFF_MULTIPLIER)),
        jitter=float(s.get(RESILIENCE_JITTER)),
        max_retries=int(s.get(RESILIENCE_MAX_RETRIES)),
    )


T = TypeVar("T")


def with_retry(fn: Callable[[], T], opts: Optional[Options] = None,
               name: str = "op") -> T:
    """Run `fn`, retrying RETRYABLE failures under `opts` backoff. RESOURCE
    and TERMINAL errors propagate at once (the ladder, not the local loop,
    decides what a capacity error means). When the budget runs out the
    LAST error is raised again, unwrapped."""
    if opts is None:
        opts = options_from_settings()
    backoffs = opts.backoffs()
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classifier decides
            if classify(e) != RETRYABLE:
                raise
            pause = next(backoffs, None)
            if pause is None:
                raise  # retry budget exhausted: surface the last error
            # a cancel/deadline must not sit out a backoff sleep: poll
            # before committing to the pause (QueryCancelled is TERMINAL
            # so it propagates out of the loop, not back into it)
            cancel.checkpoint()
            record_retry(name, pause)
            opts.sleep(pause)


def record_retry(name: str, pause: float) -> None:
    """Count one retry in the metric registry, the per-query stats and
    the active trace span (if a query is being traced)."""
    from cockroach_tpu_torch.exec import stats
    from cockroach_tpu_torch.util import tracing
    from cockroach_tpu_torch.util.metric import default_registry

    reg = default_registry()
    reg.counter("sql_resilience_retries_total",
                "in-place retries of transient faults").inc()
    reg.histogram(
        "sql_resilience_retry_backoff_seconds",
        "backoff slept before each retry",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
    ).observe(pause)
    stats.add(f"resilience.retry.{name}", seconds=pause)
    tracing.record("retry", name=name, backoff_s=round(pause, 4))
