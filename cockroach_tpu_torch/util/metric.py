"""Metric registry: counters, gauges, histograms + Prometheus text export.

Reference: pkg/util/metric (registry.go:64 Registry, histograms with fixed
buckets) exported at /_status/vars for Prometheus scrape; the internal ts
database and DB-console charts consume the same registry. This slice is
the per-process registry + export format.

Counterpart of cockroach_tpu/util/metric.py, a copy (stdlib only). The
port's callers register the JAX package's metric names: the ladder's
`sql_flow_restarts_total`, `sql_resilience_degradations_total`,
`sql_resilience_retries_total`, the breakers' gauges, the admission
queues' gauges, `sql_first_execution_seconds` (exec/fused.py: prime,
capture and the first replay of a prepared plan) and
`sqlstats_fingerprints_evicted_total`. The time-series store and the
status HTTP endpoint wait for ROADMAP.md queue 1, item 8e; the registry
is read through `crdb_internal.node_metrics` (sql/vtable.py).
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0
        self._mu = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._v += n

    def value(self) -> int:
        return self._v

    def export(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter",
                f"{self.name} {self._v}"]


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0.0
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        with self._mu:
            self._v = v

    def inc(self, n: float = 1) -> None:
        with self._mu:
            self._v += n

    def dec(self, n: float = 1) -> None:
        with self._mu:
            self._v -= n

    def value(self) -> float:
        with self._mu:
            return self._v

    def export(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {self.value()}"]


class FunctionGauge:
    """Pull-style gauge: `fn` is sampled at scrape/poll time. Used for
    values another subsystem already owns (BytesMonitor high-water marks,
    cache occupancy) so there is no push site to keep in sync."""

    def __init__(self, name: str, fn: Callable[[], float], help_: str = ""):
        self.name = name
        self.help = help_
        self._fn = fn

    def value(self) -> float:
        try:
            return float(self._fn())
        except Exception:  # noqa: BLE001 — a scrape must not raise
            return 0.0

    def export(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {self.value()}"]


DEFAULT_BUCKETS = [1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0]


class Histogram:
    """Fixed-bucket histogram (the reference uses HDR-style histograms;
    fixed buckets serve the same scrape contract)."""

    def __init__(self, name: str, help_: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        self.buckets = list(buckets or DEFAULT_BUCKETS)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._mu = threading.Lock()

    def observe(self, v: float) -> None:
        with self._mu:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._n += 1

    def export(self) -> List[str]:
        # Snapshot under the lock: a scrape racing observe() must not
        # emit a torn histogram (count bumped, sum not yet).
        with self._mu:
            counts = list(self._counts)
            total = self._sum
            n = self._n
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {n}')
        out.append(f"{self.name}_sum {total}")
        out.append(f"{self.name}_count {n}")
        return out

    def snapshot(self) -> Dict[str, object]:
        """Consistent point-in-time view for bench JSON and the
        node_metrics virtual table: count/sum/mean plus CUMULATIVE
        bucket counts keyed by upper bound (the same semantics the
        Prometheus export emits)."""
        with self._mu:
            counts = list(self._counts)
            total = self._sum
            n = self._n
        cum = 0
        buckets: Dict[str, int] = {}
        for b, c in zip(self.buckets, counts):
            cum += c
            buckets[str(b)] = cum
        buckets["+Inf"] = n
        return {"count": n, "sum": total,
                "mean": total / n if n else 0.0, "buckets": buckets}


class Registry:
    """Named metric registry (registry.go:64)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, buckets),
                         Histogram)

    def function_gauge(self, name: str, fn: Callable[[], float],
                       help_: str = "") -> FunctionGauge:
        return self._get(name, lambda: FunctionGauge(name, fn, help_),
                         FunctionGauge)

    def _get(self, name, make, cls):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def metrics(self) -> List:
        """[(name, metric)] sorted snapshot — the iteration surface for
        the metrics lint (scripts/check_metrics_lint.py) and the
        crdb_internal.node_metrics provider."""
        with self._mu:
            return sorted(self._metrics.items())

    def export_prometheus(self) -> str:
        """The /_status/vars payload."""
        with self._mu:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for _, m in metrics:
            lines.extend(m.export())
        return "\n".join(lines) + "\n"


_default = Registry()


def default_registry() -> Registry:
    return _default
