"""Channelized structured logging with redaction.

Reference: pkg/util/log — logs are split into CHANNELS (DEV, OPS, HEALTH,
SQL_EXEC, SENSITIVE_ACCESS, ...) with independent sinks and severities,
and user data is wrapped in redaction markers so support bundles can be
scrubbed. This slice implements channels, severities, redactable values,
and pluggable sinks (self-contained; no stdlib-logging coupling).

Counterpart of cockroach_tpu/util/log.py, a copy (stdlib only). The
SQL_EXEC channel carries the JAX package's lines: a flow restart, a
ladder tier's degradation and a fused fallback (exec/operators.py
run_flow, exec/fused.py), the slow-query log and the execution insights
(sql/session.py, sql/insights.py).
"""

from __future__ import annotations

import enum
import json
import sys
import time
from typing import Any, Dict, Optional


class Channel(enum.Enum):
    DEV = "dev"
    OPS = "ops"
    HEALTH = "health"
    STORAGE = "storage"
    SQL_EXEC = "sql_exec"
    SENSITIVE_ACCESS = "sensitive_access"


REDACT_OPEN, REDACT_CLOSE = "‹", "›"  # same markers as the ref


class Redactable:
    """User-provided data wrapped in redaction markers; `redact()` on a
    formatted line replaces every marked span (util/log redact.go)."""

    def __init__(self, v: Any):
        self.v = v

    def __str__(self):
        # escape embedded markers so sensitive data cannot break out of
        # its redaction span (util/log redact.go does the same)
        inner = (str(self.v).replace(REDACT_OPEN, "?")
                 .replace(REDACT_CLOSE, "?"))
        return f"{REDACT_OPEN}{inner}{REDACT_CLOSE}"


def redact(line: str) -> str:
    out = []
    depth = 0
    for ch in line:
        if ch == REDACT_OPEN:
            depth += 1
            if depth == 1:
                out.append(REDACT_OPEN + "x" + REDACT_CLOSE)
        elif ch == REDACT_CLOSE:
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


class Sink:
    def emit(self, entry: Dict[str, Any]) -> None:
        raise NotImplementedError


class StderrSink(Sink):
    def emit(self, entry: Dict[str, Any]) -> None:
        print(f"{entry['severity'][0]}{entry['ts']:.6f} "
              f"[{entry['channel']}] {entry['msg']}", file=sys.stderr)


class MemorySink(Sink):
    """Capture sink (tests + support-bundle assembly)."""

    def __init__(self):
        self.entries: list = []

    def emit(self, entry: Dict[str, Any]) -> None:
        self.entries.append(entry)

    def json_lines(self, redacted: bool = False) -> str:
        out = []
        for e in self.entries:
            e = dict(e)
            if redacted:
                e["msg"] = redact(e["msg"])
            out.append(json.dumps(e))
        return "\n".join(out)


class Logger:
    # entries retained in the recent-log ring (debug-zip's
    # "recent logs" section; pkg/cli/zip collects the log tail)
    RECENT_CAP = 512

    def __init__(self):
        self._sinks: Dict[Channel, list] = {c: [] for c in Channel}
        self._default = StderrSink()
        self._severity = "INFO"
        self._levels = {"DEBUG": 0, "INFO": 1, "WARNING": 2, "ERROR": 3}
        from collections import deque

        # severity-independent ring: even below the sink threshold an
        # entry lands here, so a support bundle sees recent activity
        # without the operator having to raise verbosity first
        self._recent = deque(maxlen=self.RECENT_CAP)

    def recent(self, n: int = 0) -> list:
        """Most recent log entries (oldest first); n=0 returns all."""
        out = list(self._recent)
        return out[-n:] if n else out

    def add_sink(self, channel: Channel, sink: Sink) -> None:
        self._sinks[channel].append(sink)

    def set_severity(self, severity: str) -> None:
        assert severity in self._levels
        self._severity = severity

    def _log(self, channel: Channel, severity: str, msg: str,
             *args) -> None:
        entry = {
            "ts": time.time(),
            "channel": channel.value,
            "severity": severity,
            "msg": msg.format(*args) if args else msg,
        }
        self._recent.append(entry)
        if self._levels[severity] < self._levels[self._severity]:
            return
        sinks = self._sinks[channel] or [self._default]
        for s in sinks:
            s.emit(entry)

    def structured(self, channel: Channel, severity: str, event: str,
                   **fields) -> None:
        """Structured event (reference: log.Structured / eventpb): the
        entry carries machine-readable fields next to a formatted msg.
        Redactable field values stay wrapped for later `redact()`."""
        entry = {
            "ts": time.time(),
            "channel": channel.value,
            "severity": severity,
            "event": event,
            "msg": event + (" " if fields else "") + " ".join(
                f"{k}={v}" for k, v in fields.items()),
        }
        entry.update({k: str(v) if isinstance(v, Redactable) else v
                      for k, v in fields.items()})
        self._recent.append(entry)
        if self._levels[severity] < self._levels[self._severity]:
            return
        sinks = self._sinks[channel] or [self._default]
        for s in sinks:
            s.emit(entry)

    def info(self, channel: Channel, msg: str, *args) -> None:
        self._log(channel, "INFO", msg, *args)

    def warning(self, channel: Channel, msg: str, *args) -> None:
        self._log(channel, "WARNING", msg, *args)

    def error(self, channel: Channel, msg: str, *args) -> None:
        self._log(channel, "ERROR", msg, *args)

    def dev(self, msg: str, *args) -> None:
        self._log(Channel.DEV, "DEBUG", msg, *args)


_logger: Optional[Logger] = None


def get_logger() -> Logger:
    global _logger
    if _logger is None:
        _logger = Logger()
        _logger.set_severity("WARNING")  # quiet by default under bench
    return _logger
