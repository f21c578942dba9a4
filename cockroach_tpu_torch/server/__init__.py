"""Server-side services: the jobs registry.

Counterpart of cockroach_tpu/server/, for server/jobs.py (`JobRecord`,
`Registry`, `States`). Backup and restore, the debug zip, node status,
the pre-warm job and the time series wait for ROADMAP.md queue 1, item
8e.

Reference: pkg/jobs (registry.go:93, adopt.go, progress.go).
"""

from cockroach_tpu_torch.server.jobs import JobRecord, Registry, States

__all__ = ["JobRecord", "Registry", "States"]
