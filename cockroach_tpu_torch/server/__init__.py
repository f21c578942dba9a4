"""Server-side services: the jobs registry, the query registry and the
statement bundle.

Counterpart of cockroach_tpu/server/, for server/jobs.py (`JobRecord`,
`Registry`, `States`), server/registry.py (`QueryRegistry`, the live
sessions and statements behind SHOW QUERIES and CANCEL QUERY) and
server/debugzip.py's `write_statement_bundle`. Backup and restore, the
debug zip, node status, the pre-warm job and the time series wait for
ROADMAP.md queue 1, item 8e.

Reference: pkg/jobs (registry.go:93, adopt.go, progress.go).
"""

from cockroach_tpu_torch.server.jobs import JobRecord, Registry, States

__all__ = ["JobRecord", "Registry", "States"]
