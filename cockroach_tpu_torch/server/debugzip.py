"""Diagnostics bundles: the per-statement bundle of EXPLAIN ANALYZE (DEBUG).

Reference: sql/instrumentation.go's EXPLAIN ANALYZE (DEBUG), which writes
a per-statement bundle (plan, trace, environment).

Counterpart of cockroach_tpu/server/debugzip.py, with only
`write_statement_bundle` and the `stmt_bundles_written_total` counter.
The node-wide debug zip (`write_debug_zip`, `collect_http`) reads the
status plane and the time series, which wait for ROADMAP.md queue 1,
item 8e.
"""

from __future__ import annotations

import json
import zipfile
from typing import Optional

_bundles_counter = None


def _bundles():
    global _bundles_counter
    if _bundles_counter is None:
        from cockroach_tpu_torch.util.metric import default_registry

        _bundles_counter = default_registry().counter(
            "stmt_bundles_written_total",
            "EXPLAIN ANALYZE (DEBUG) statement bundles written")
    return _bundles_counter


def _write_json(zf: zipfile.ZipFile, name: str, payload) -> None:
    zf.writestr(name, json.dumps(payload, sort_keys=True, indent=1,
                                 default=str))


def write_statement_bundle(out_path: str, sql: str, plan_lines,
                           span=None, operators=None,
                           digest: Optional[dict] = None) -> str:
    """EXPLAIN ANALYZE (DEBUG)'s per-statement bundle: the plan, the
    full span tree (structured + rendered), the operator breakdown, and
    the resilience digest."""
    with zipfile.ZipFile(out_path, "w",
                         compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("stmt.sql", sql + "\n")
        zf.writestr("plan.txt", "\n".join(plan_lines) + "\n")
        if span is not None:
            _write_json(zf, "trace.json", span.as_dict())
            zf.writestr("trace.txt", span.render() + "\n")
        if operators is not None:
            _write_json(zf, "operators.json", operators)
        if digest is not None:
            _write_json(zf, "digest.json", digest)
    _bundles().inc()
    return out_path
