"""Fault injection: named probabilistic/counted injection points, plus
the crash-point shim for durable-write seams.

A copy of cockroach_tpu/util/fault.py (stdlib only). KNOWN_POINTS lists
the injection points the port wires, each where the JAX package has it:
the scan's transfer and stack (exec/operators.py), the resident tier
(storage/mvcc.py), the fused program's compile and run (exec/fused.py:
before the capture or the replay, never inside a CUDA graph capture),
the scan-image cache's insert (exec/scan_cache.py, swallowed as a
miss), the spill blocks' write and read (exec/spill.py), ALTER
TABLE's backfill (sql/session.py), a changefeed's envelope emission
(sql/changefeed.py) and a materialized view's delta fold
(sql/matview.py). The JAX points of modules the port does not have yet
(dist.a2a, dtxn.before_resolve) wait for their ROADMAP.md queue 1
items. The jobs registry's
checkpoint passes the crash point `jobs.checkpoint` (server/jobs.py, in
DURABLE_POINTS). The durable-write seams the port's engines pass
through (wal.append, wal.sync, engine.flush) are the JAX package's.

Reference: pkg/util/fault (fault_strategy.go probabilistic injection
points) + the TestingKnobs pattern — every subsystem exposes seams that
tests arm to place deterministic faults.

Usage: production code calls `maybe_fail("scan.transfer")` at its
injection point (a no-op unless armed — zero cost in the common case);
tests arm points with a probability, a countdown, or a custom exception
factory, then assert recovery behavior.

Crash points (`crash_point` / `DurableFile`) are the durable-write
analog: every persistence seam (WAL append/sync, snapshot ingest, jobs
checkpoints, plan-vault stores, backup span files) passes through a
named point that tests and the crash nemesis arm to die — either a
`SimulatedCrash` (BaseException, so production `except Exception`
handlers can't absorb a "dead process") or a real `kill -9` of the
current process — at a deterministic write number N, optionally after a
torn write (a prefix of the final record reaches the file) or with the
un-fsynced tail dropped (the power-loss model: only synced bytes
survive). Recovery code is then hardened against exactly what the shim
produces.
"""

from __future__ import annotations

import os
import random
import signal
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional


class InjectedFault(RuntimeError):
    pass


class SimulatedCrash(BaseException):
    """An injected process death. Derives BaseException on purpose: a
    crash must never be swallowed by the production `except Exception`
    fallbacks (plan-vault store degradation, job failure handling) —
    a dead process doesn't run handlers."""


# Every seam the execution pipeline arms (tests iterate this catalog;
# production code is the source of truth — a point listed here must
# have a matching maybe_fail() call).
KNOWN_POINTS = (
    "scan.transfer",      # host->device piece copy (ScanOp._pack_stream)
    "scan.stack",         # stacked-image build (ScanOp._stack)
    "scan.resident",      # resident visibility materialize (MVCCStore)
    "fused.compile",      # eager warm-up + capture, or the first trace
    "fused.exec",         # fused run: replay or eager run (FusedRunner)
    "spill.block_write",  # grace-partition block append (HostPartition)
    "spill.block_read",   # spilled-block replay (BlockSource.batches)
    "cache.insert",       # scan-image cache insert (ScanImageCache.put)
    "alter.backfill_chunk",  # ALTER TABLE's column backfill (sql/session.py)
    "changefeed.emit",    # per-envelope sink emission (sql/changefeed.py)
    "view.fold",          # incremental matview delta fold (sql/matview.py)
)

# Durable-write seams the crash shim wraps (crash_point()/DurableFile
# call sites; the crash nemesis and tests/test_crash.py iterate this).
DURABLE_POINTS = (
    "wal.append",        # engine WAL record append (both engine formats)
    "wal.sync",          # engine WAL fsync (storage/engine.py sync())
    "engine.flush",      # memtable -> durable run/snapshot fold
    "snapshot.ingest",   # range-snapshot chunk application (kvserver)
    "jobs.checkpoint",   # job progress persisted (server/jobs.py)
    "vault.store",       # plan-vault artifact tmp write -> rename
    "backup.span",       # backup span file tmp write -> rename
    "backup.manifest",   # backup manifest tmp write -> rename
    "changefeed.segment",  # changefeed file-sink segment tmp write -> rename
)


@dataclass
class _Point:
    name: str
    probability: float = 0.0
    after: Optional[int] = None  # fire once after N passes
    count: int = 0
    fires: int = 0
    make: Optional[Callable[[], BaseException]] = None


@dataclass
class _CrashPoint:
    name: str
    at: int                   # fire on the at-th pass (1-based)
    mode: str = "raise"       # "raise" -> SimulatedCrash, "kill" -> SIGKILL
    tear: Optional[int] = None  # bytes of the final record that land
    lose_unsynced: bool = False  # drop everything after the last fsync
    count: int = 0
    fires: int = 0


class FaultRegistry:
    def __init__(self, seed: int = 0):
        self._mu = threading.Lock()
        self._points: Dict[str, _Point] = {}
        self._crash_points: Dict[str, _CrashPoint] = {}
        self._rng = random.Random(seed)
        self._armed = False
        self._crash_armed = False

    def arm(self, name: str, probability: float = 0.0,
            after: Optional[int] = None,
            make: Optional[Callable[[], BaseException]] = None) -> None:
        with self._mu:
            self._points[name] = _Point(name, probability, after,
                                        make=make)
            self._armed = True

    def disarm(self, name: Optional[str] = None) -> None:
        with self._mu:
            if name is None:
                self._points.clear()
                self._crash_points.clear()
            else:
                self._points.pop(name, None)
                self._crash_points.pop(name, None)
            self._armed = bool(self._points)
            self._crash_armed = bool(self._crash_points)

    # ------------------------------------------------------ crash points --

    def arm_crash(self, name: str, at: int = 1, mode: str = "raise",
                  tear: Optional[int] = None,
                  lose_unsynced: bool = False) -> None:
        """Arm a durable-write crash: the `at`-th pass through `name`
        dies. `mode="raise"` raises SimulatedCrash (in-process tests);
        `mode="kill"` SIGKILLs the process (real crash children).
        `tear=k` lets the first k bytes of the final write reach the
        file first (a torn record); `lose_unsynced` truncates the file
        back to its last-synced length first (the power-loss model) —
        both only apply at DurableFile-wrapped seams."""
        if mode not in ("raise", "kill"):
            raise ValueError(f"bad crash mode {mode!r}")
        if name not in DURABLE_POINTS:
            raise ValueError(
                f"unknown crash point {name!r}; durable seams: "
                f"{', '.join(DURABLE_POINTS)}")
        with self._mu:
            self._crash_points[name] = _CrashPoint(
                name, int(at), mode, tear, lose_unsynced)
            self._crash_armed = True

    def check_crash(self, name: str) -> Optional[_CrashPoint]:
        """Count one pass through crash point `name`; returns the armed
        point iff the crash fires NOW (the caller applies tear/truncate
        side effects, then calls `crash(point)`)."""
        if not self._crash_armed:  # fast path: nothing armed anywhere
            return None
        with self._mu:
            cp = self._crash_points.get(name)
            if cp is None:
                return None
            cp.count += 1
            if cp.count != cp.at:
                return None
            cp.fires += 1
            return cp

    def crash(self, cp: _CrashPoint) -> None:
        """Die per the armed mode. Never returns for mode="kill"."""
        if cp.mode == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(
            f"simulated crash at {cp.name!r} (write #{cp.at})")

    def crash_fires(self, name: str) -> int:
        with self._mu:
            cp = self._crash_points.get(name)
            return cp.fires if cp else 0

    def crash_counts(self, name: str) -> int:
        """Passes observed through crash point `name` (armed only)."""
        with self._mu:
            cp = self._crash_points.get(name)
            return cp.count if cp else 0

    def maybe_fail(self, name: str) -> None:
        if not self._armed:  # fast path: nothing armed anywhere
            return
        with self._mu:
            p = self._points.get(name)
            if p is None:
                return
            p.count += 1
            fire = False
            if p.after is not None:
                if p.count > p.after:
                    fire = True
                    p.after = None  # once
            elif p.probability > 0:
                fire = self._rng.random() < p.probability
            if not fire:
                return
            p.fires += 1
            make = p.make
        # build the exception OUTSIDE the lock: blocking make() hooks
        # (tests stall a query inside one) must not serialize every
        # other thread's pass through unrelated fault points
        raise (make() if make is not None
               else InjectedFault(f"injected fault at {name!r}"))

    def fires(self, name: str) -> int:
        with self._mu:
            p = self._points.get(name)
            return p.fires if p else 0

    def total_fires(self) -> int:
        with self._mu:
            return sum(p.fires for p in self._points.values())

    def set_seed(self, seed: int) -> None:
        """Re-seed the probability RNG (chaos runs want reproducible fire
        sequences independent of what ran earlier in the process)."""
        with self._mu:
            self._rng = random.Random(seed)


_registry = FaultRegistry()


def registry() -> FaultRegistry:
    return _registry


def maybe_fail(name: str) -> None:
    _registry.maybe_fail(name)


def crash_point(name: str) -> None:
    """Durable-write seam without a wrapped file: dies here when the
    armed crash fires (jobs checkpoints, vault stores, snapshot ingest,
    backup renames). No-op unless armed — zero cost in production."""
    cp = _registry.check_crash(name)
    if cp is not None:
        _registry.crash(cp)


class DurableFile:
    """Append-only file wrapper that routes every record write and every
    fsync through the crash-point registry — the filesystem shim durable
    WALs write through (PyEngine's WAL; any future durable log).

    Crash semantics it can inject, deterministically at write #N:
      - clean crash at a record boundary (the default): the final record
        never reaches the file;
      - torn write (`tear=k`): the first k bytes of the final record
        land, then the process dies — recovery must detect the partial
        record (CRC) and truncate, never fatally mis-parse;
      - lost un-fsynced tail (`lose_unsynced`): the file reverts to its
        last fsync'd length — the power-loss model; only acknowledged
        (synced) writes survive.

    Tracks `synced_len` so the lost-tail model is exact."""

    def __init__(self, path: str, point: str = "wal"):
        self.path = path
        self._append_pt = point + ".append"
        self._sync_pt = point + ".sync"
        self._f = open(path, "ab")
        self._f.seek(0, os.SEEK_END)
        self.synced_len = self._f.tell()

    def tell(self) -> int:
        return self._f.tell()

    def append(self, record: bytes) -> int:
        """Write one record; returns the offset it starts at. Dies here
        (honoring tear/lose_unsynced) when an armed crash fires."""
        cp = _registry.check_crash(self._append_pt)
        off = self._f.tell()
        if cp is not None:
            if cp.tear:
                self._f.write(record[:cp.tear])
            self._f.flush()
            if cp.lose_unsynced:
                self._f.truncate(self.synced_len)
            _registry.crash(cp)
        self._f.write(record)
        return off

    def sync(self) -> None:
        """flush + fsync; everything appended so far becomes crash-safe.
        An armed crash at the sync point dies BEFORE the fsync (the
        write was never acknowledged)."""
        cp = _registry.check_crash(self._sync_pt)
        if cp is not None:
            self._f.flush()
            if cp.lose_unsynced:
                self._f.truncate(self.synced_len)
            _registry.crash(cp)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.synced_len = self._f.tell()

    def truncate(self, size: int = 0) -> None:
        self._f.flush()
        self._f.truncate(size)
        self._f.seek(size)
        os.fsync(self._f.fileno())
        self.synced_len = size

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()
            self._f = None


def tear_file(path: str, nbytes: int) -> int:
    """Chop `nbytes` off the end of `path` (simulating a write torn by a
    crash mid-record, from outside the process — the native-engine WAL
    case where the writer is C++). Returns the new size."""
    size = os.path.getsize(path)
    new = max(0, size - int(nbytes))
    with open(path, "r+b") as f:
        f.truncate(new)
        f.flush()
        os.fsync(f.fileno())
    return new


def corrupt_file(path: str, offset: int, xor: int = 0xFF) -> None:
    """Flip bits of one byte mid-file (bit-rot / silent corruption the
    per-record CRC must catch)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        if not b:
            raise ValueError(f"offset {offset} beyond EOF of {path}")
        f.seek(offset)
        f.write(bytes([b[0] ^ (xor & 0xFF)]))
        f.flush()
        os.fsync(f.fileno())
