"""Execution insights: per-fingerprint latency baselines + anomaly ring.

Reference: pkg/sql/sqlstats/insights — each statement fingerprint keeps a
streaming latency baseline; executions that are anomalous against their
OWN history (not a global threshold) are captured with their cause and
surfaced on `crdb_internal.cluster_execution_insights` and as structured
log events. Causes here: `slow` (latency beyond the EWMA baseline by
`sql.insights.latency_sigma` standard deviations), `shed` (admission
rejected the statement, 53300), `degraded` (the resilience ladder
dropped a tier mid-statement), `batch_fallback` (a serving-queue batch
declined/fell apart and the statement re-ran serially).

The baseline is an exponentially-weighted mean + variance (EWMA alpha
0.2): cheap, O(1) per execution, and it tracks drift — a fingerprint
that gets permanently slower stops flagging once the baseline catches
up, which is exactly the "anomalous vs own history" contract.

Counterpart of cockroach_tpu/sql/insights.py, a copy. One departure: a
slow or degraded execution does not flag its fingerprint's placement
dirty, since the port's placement pass keeps no per-fingerprint cache
(sql/plan_compile.py has no `mark_degraded`). `batch_fallback` comes
from sql/session.py `execute_spec`, when the serving queue declines a
bound statement.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cockroach_tpu_torch.util.settings import Settings

INSIGHTS_CAPACITY = Settings.register(
    "sql.insights.capacity",
    256,
    "max retained execution insights (oldest evicted first)",
)

INSIGHTS_SIGMA = Settings.register(
    "sql.insights.latency_sigma",
    3.0,
    "flag an execution as slow when its latency exceeds the "
    "fingerprint's EWMA baseline by this many standard deviations",
)

INSIGHTS_MIN_SAMPLES = Settings.register(
    "sql.insights.min_samples",
    5,
    "executions of a fingerprint before its baseline can flag slowness",
)

INSIGHTS_MIN_LATENCY = Settings.register(
    "sql.insights.min_latency_s",
    0.01,
    "absolute floor: executions faster than this are never flagged "
    "slow regardless of baseline (sub-ms statements beat their own "
    "baseline on scheduler jitter alone)",
)

_EWMA_ALPHA = 0.2


class Baseline:
    """Streaming latency model for one fingerprint. __slots__ + plain
    init: one EWMA update runs per statement on the warm path."""

    __slots__ = ("count", "mean", "var")

    def __init__(self, count: int = 0, mean: float = 0.0,
                 var: float = 0.0):
        self.count = count
        self.mean = mean
        self.var = var

    def observe(self, x: float) -> None:
        if self.count == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += _EWMA_ALPHA * d
            self.var = ((1 - _EWMA_ALPHA)
                        * (self.var + _EWMA_ALPHA * d * d))
        self.count += 1

    def is_slow(self, x: float, sigma: float, min_samples: int) -> bool:
        """Judged against the baseline BEFORE folding x in (the caller
        observes after judging): anomalous = beyond mean + sigma*stddev
        AND at least 2x the mean, the second guard keeping microsecond
        statements from flagging on scheduler jitter."""
        if self.count < min_samples:
            return False
        thresh = self.mean + sigma * math.sqrt(max(self.var, 0.0))
        return x > thresh and x > 2.0 * self.mean


@dataclass
class Insight:
    fingerprint: str
    kinds: tuple  # subset of (slow, shed, degraded, batch_fallback)
    elapsed_s: float
    baseline_mean_s: float
    session_id: int
    query_id: int
    at_unix: float = field(default_factory=time.time)
    detail: str = ""

    def as_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "kinds": ",".join(self.kinds),
            "elapsed_s": round(self.elapsed_s, 4),
            "baseline_mean_s": round(self.baseline_mean_s, 4),
            "session_id": self.session_id,
            "query_id": self.query_id,
            "at_unix": round(self.at_unix, 3),
            "detail": self.detail,
        }


def _fp(sql: str) -> str:
    # lazy module binding: sqlstats.fingerprint is lru-cached; resolving
    # it through the import system on every call costs ~0.5us
    global _fingerprint
    if _fingerprint is None:
        from cockroach_tpu_torch.sql.sqlstats import fingerprint
        _fingerprint = fingerprint
    return _fingerprint(sql)


_fingerprint = None


class InsightsRegistry:
    def __init__(self):
        self._mu = threading.Lock()
        self._baselines: Dict[str, Baseline] = {}
        self._ring: deque = deque()
        self._st = Settings()

    def min_latency_floor(self) -> float:
        """Current `sql.insights.min_latency_s` — callers on the warm
        path cache this and only route executions at/above it (or
        flagged ones, or a 1-in-N baseline sample) through observe()."""
        return float(self._st.get(INSIGHTS_MIN_LATENCY))

    def observe(self, sql: str, elapsed_s: float, session_id: int = 0,
                query_id: int = 0, shed: bool = False,
                degraded: bool = False, batch_fallback: bool = False,
                error: bool = False) -> Optional[Insight]:
        """Record one execution; returns the Insight if it was anomalous.
        Error executions (including sheds) do NOT feed the baseline —
        a failed statement's latency says nothing about the
        fingerprint's healthy profile."""
        fp = _fp(sql)
        st = self._st
        if not (shed or degraded or batch_fallback or error):
            # hot path: a healthy execution below the latency floor can
            # never flag anything — feed the baseline and get out
            # (one settings read, no list/Insight allocation)
            if elapsed_s < float(st.get(INSIGHTS_MIN_LATENCY)):
                with self._mu:
                    base = self._baselines.get(fp)
                    if base is None:
                        self._baselines[fp] = Baseline(1, elapsed_s)
                    else:  # Baseline.observe, inlined
                        d = elapsed_s - base.mean
                        base.mean += _EWMA_ALPHA * d
                        base.var = ((1 - _EWMA_ALPHA)
                                    * (base.var + _EWMA_ALPHA * d * d))
                        base.count += 1
                return None
        kinds = []
        if shed:
            kinds.append("shed")
        if degraded:
            kinds.append("degraded")
        if batch_fallback:
            kinds.append("batch_fallback")
        # settings reads are ~1us each: the hot no-insight path reads at
        # most ONE (the latency floor), and only healthy executions at
        # or above the floor pay for the sigma/min_samples judgement
        judge = (not error
                 and elapsed_s >= float(st.get(INSIGHTS_MIN_LATENCY)))
        sigma = float(st.get(INSIGHTS_SIGMA)) if judge else 0.0
        min_samples = int(st.get(INSIGHTS_MIN_SAMPLES)) if judge else 0
        with self._mu:
            base = self._baselines.get(fp)
            if base is None:
                base = self._baselines[fp] = Baseline()
            if judge and base.is_slow(elapsed_s, sigma, min_samples):
                kinds.append("slow")
            mean = base.mean
            if not error:
                base.observe(elapsed_s)
            if not kinds:
                return None
            ins = Insight(fp, tuple(kinds), elapsed_s, mean, session_id,
                          query_id)
            self._ring.append(ins)
            cap = max(int(st.get(INSIGHTS_CAPACITY)), 1)
            while len(self._ring) > cap:
                self._ring.popleft()
        self._log(ins)
        return ins

    def _log(self, ins: Insight) -> None:
        from cockroach_tpu_torch.util.log import Channel, Redactable, get_logger

        get_logger().structured(
            Channel.SQL_EXEC, "WARNING", "execution_insight",
            fingerprint=Redactable(ins.fingerprint),
            kinds=",".join(ins.kinds),
            latency_s=round(ins.elapsed_s, 4),
            baseline_mean_s=round(ins.baseline_mean_s, 4),
            session=ins.session_id, query=ins.query_id)

    def insights(self) -> List[dict]:
        with self._mu:
            return [i.as_dict() for i in self._ring]

    def baseline(self, sql: str) -> Optional[Baseline]:
        with self._mu:
            return self._baselines.get(_fp(sql))

    def reset(self) -> None:
        with self._mu:
            self._baselines.clear()
            self._ring.clear()


_default = InsightsRegistry()


def default_insights() -> InsightsRegistry:
    return _default
