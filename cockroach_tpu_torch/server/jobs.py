"""Async job framework: persisted records, leases, adoption, checkpoints.

Counterpart of cockroach_tpu/server/jobs.py, host only (no device
work): the port's MVCC store keeps the records, and `checkpoint`
passes the crash point `jobs.checkpoint` (util/fault.py
DURABLE_POINTS).

Reference: pkg/jobs — `Registry` (registry.go:93) runs jobs; records +
progress live in system tables so ANY node can adopt an orphaned job
after its lease expires (adopt.go); long operations checkpoint progress
(progress.go, job_info_storage.go) and resume from it.

Here job records are JSON values in a system keyspace of the MVCC store
(the system.jobs analog — same storage engine as user data, so backups
and jobs share durability). Adoption is epoch-based: a registry claims a
job by bumping its lease epoch; a stale holder's checkpoints are
rejected by epoch mismatch (the fencing the reference gets from
epoch-based leases).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cockroach_tpu_torch.storage.mvcc import MVCCStore
from cockroach_tpu_torch.util.fault import crash_point
from cockroach_tpu_torch.util.hlc import Timestamp

JOBS_TABLE = 0xFFF0  # system keyspace (pkg/keys: system table IDs)


class States:
    RUNNING = "running"
    PAUSED = "paused"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    CANCELLED = "cancelled"

    TERMINAL = (SUCCEEDED, FAILED, CANCELLED)


@dataclass
class JobRecord:
    id: int
    kind: str
    state: str
    payload: dict = field(default_factory=dict)
    progress: dict = field(default_factory=dict)
    lease_epoch: int = 0
    lease_exp: int = 0  # wall time; 0 = unclaimed
    error: str = ""

    def encode(self) -> bytes:
        return json.dumps(self.__dict__, sort_keys=True).encode()

    @staticmethod
    def decode(b: bytes) -> "JobRecord":
        return JobRecord(**json.loads(b.decode()))


class StaleLease(RuntimeError):
    """A checkpoint/state change from a registry that lost the lease."""


def _key(job_id: int) -> bytes:
    return struct.pack(">HQ", JOBS_TABLE, job_id)


class Registry:
    """One node's job registry over the shared store."""

    def __init__(self, store: MVCCStore, node_id: int = 1,
                 lease_ttl: int = 100):
        self.store = store
        self.node_id = node_id
        self.lease_ttl = lease_ttl
        self._resumers: Dict[str, Callable] = {}
        self._next_local = 0

    # ---------------------------------------------------------- storage --

    def _now(self) -> Timestamp:
        return self.store.clock.now()

    def _load(self, job_id: int) -> Optional[JobRecord]:
        hit = self.store.engine.get(_key(job_id), Timestamp.MAX)
        if hit is None or not hit[0]:
            return None
        return JobRecord.decode(hit[0])

    def _save(self, rec: JobRecord) -> None:
        self.store.engine.put(_key(rec.id), self._now(), rec.encode())
        # job state transitions must be durable the moment they are
        # observable: an un-fsynced checkpoint that vanishes in a crash
        # re-opens the work it recorded (the double-execution window —
        # the resumer would redo steps the lost checkpoint covered)
        self.store.sync()

    def list_jobs(self) -> List[JobRecord]:
        keys = self.store.engine.scan_keys(
            _key(0), struct.pack(">HQ", JOBS_TABLE + 1, 0), Timestamp.MAX)
        out = []
        for k in keys:
            hit = self.store.engine.get(k, Timestamp.MAX)
            if hit and hit[0]:
                out.append(JobRecord.decode(hit[0]))
        return out

    # ------------------------------------------------------------- jobs --

    def register_resumer(self, kind: str,
                         fn: Callable[["Registry", JobRecord], None]):
        """fn(registry, record) runs/continues the job; it must call
        checkpoint() as it goes and may raise to fail the job."""
        self._resumers[kind] = fn

    def create(self, kind: str, payload: dict) -> int:
        # ids must survive registry restarts (records are durable, the
        # counter is not): probe past any persisted id for this node
        while True:
            self._next_local += 1
            job_id = (self.node_id << 32) | self._next_local
            if self._load(job_id) is None:
                break
        rec = JobRecord(job_id, kind, States.RUNNING, payload)
        self._save(rec)
        return job_id

    def get(self, job_id: int) -> JobRecord:
        rec = self._load(job_id)
        if rec is None:
            raise KeyError(f"no job {job_id}")
        return rec

    def _check_lease(self, rec: JobRecord, epoch: int):
        if rec.lease_epoch != epoch:
            raise StaleLease(
                f"job {rec.id}: lease epoch {epoch} superseded by "
                f"{rec.lease_epoch}")

    def checkpoint(self, job_id: int, epoch: int, progress: dict) -> None:
        """Persist progress under the lease epoch (fenced + fsynced).
        The crash point fires AFTER the durable write: it models a node
        dying between checkpointing and releasing the lease — recovery
        must resume exactly at this checkpoint once the lease expires,
        never re-running the steps it covers."""
        rec = self.get(job_id)
        self._check_lease(rec, epoch)
        rec.progress = dict(progress)
        self._save(rec)
        crash_point("jobs.checkpoint")

    def _finish(self, job_id: int, epoch: int, state: str,
                error: str = ""):
        rec = self.get(job_id)
        self._check_lease(rec, epoch)
        rec.state = state
        rec.error = error
        rec.lease_exp = 0
        self._save(rec)

    def pause(self, job_id: int) -> None:
        rec = self.get(job_id)
        if rec.state == States.RUNNING:
            rec.state = States.PAUSED
            rec.lease_epoch += 1  # fence the current holder
            rec.lease_exp = 0
            self._save(rec)

    def resume(self, job_id: int) -> None:
        rec = self.get(job_id)
        if rec.state == States.PAUSED:
            rec.state = States.RUNNING
            rec.lease_exp = 0
            self._save(rec)

    def cancel(self, job_id: int) -> None:
        rec = self.get(job_id)
        if rec.state not in States.TERMINAL:
            rec.state = States.CANCELLED
            rec.lease_epoch += 1
            rec.lease_exp = 0
            self._save(rec)

    # --------------------------------------------------------- adoption --

    def adopt_and_run(self, max_jobs: int = 16) -> List[int]:
        """Claim runnable jobs whose lease is unheld/expired, then run
        their resumers to completion or failure (adopt.go's loop, run
        synchronously — the caller decides scheduling)."""
        ran = []
        now_wall = self._now().wall
        for rec in self.list_jobs():
            if len(ran) >= max_jobs:
                break
            if rec.state != States.RUNNING:
                continue
            if rec.kind not in self._resumers:
                continue
            if rec.lease_exp and rec.lease_exp > now_wall:
                continue  # someone holds a live lease
            # claim: bump epoch + set expiry
            rec.lease_epoch += 1
            rec.lease_exp = now_wall + self.lease_ttl
            self._save(rec)
            epoch = rec.lease_epoch
            try:
                self._resumers[rec.kind](self, rec)
            except StaleLease:
                continue  # lost the lease mid-run; new holder owns it
            except Exception as e:  # job failure is a job state
                try:
                    self._finish(rec.id, epoch, States.FAILED, str(e))
                except StaleLease:
                    pass
                ran.append(rec.id)
                continue
            try:
                self._finish(rec.id, epoch, States.SUCCEEDED)
            except StaleLease:
                continue
            ran.append(rec.id)
        return ran
