"""SQL layer: logical plans -> operator building (counterpart of
cockroach_tpu/sql)."""

from cockroach_tpu_torch.sql.plan import (
    Aggregate, Catalog, Filter, OrderBy, Plan, Project, Scan, TPCHCatalog,
    build, normalize,
)

__all__ = ["Aggregate", "Catalog", "Filter", "OrderBy", "Plan", "Project",
           "Scan", "TPCHCatalog", "build", "normalize"]
