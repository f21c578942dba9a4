"""SQL layer: parser -> binder -> logical plans -> operator building
(counterpart of cockroach_tpu/sql). `run_sql` is the text-in,
columns-out entry point; the session (sql/session.py) and the shell
(cli.py) run statements through sql/explain.py."""

from cockroach_tpu_torch.sql.plan import (
    Aggregate, Catalog, Distinct, Filter, Join, Limit, OrderBy, Plan,
    Project, Scan, TPCHCatalog, Window, build, normalize, run,
)

__all__ = ["Aggregate", "Catalog", "Distinct", "Filter", "Join", "Limit",
           "OrderBy", "Plan", "Project", "Scan", "TPCHCatalog", "Window",
           "build", "normalize", "run", "parse_sql", "plan_sql",
           "run_sql"]


def parse_sql(sql: str):
    """SQL text -> AST (no catalog needed)."""
    from cockroach_tpu_torch.sql.parser import parse

    return parse(sql)


def plan_sql(sql: str, catalog):
    from cockroach_tpu_torch.sql.bind import plan_sql as _plan

    return _plan(sql, catalog)


def run_sql(sql: str, catalog, capacity: int = 1 << 17, mesh=None,
            device=None):
    from cockroach_tpu_torch.sql.bind import run_sql as _run

    return _run(sql, catalog, capacity, mesh=mesh, device=device)
