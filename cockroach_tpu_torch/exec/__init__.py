"""Flow runtime (counterpart of cockroach_tpu/exec): a tree of streaming
operators over device batches, driven by the host."""

from cockroach_tpu_torch.exec.operators import (
    HashAggOp, MapOp, Operator, ScanOp, SortOp, collect,
)

__all__ = ["Operator", "ScanOp", "MapOp", "HashAggOp", "SortOp", "collect"]
