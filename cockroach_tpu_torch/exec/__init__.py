"""Flow runtime (counterpart of cockroach_tpu/exec): a tree of streaming
operators over device batches, driven by the host."""

from cockroach_tpu_torch.exec.operators import (
    DistinctOp, FlowRestart, HashAggOp, JoinOp, LimitOp, MapOp, Operator,
    OrderedAggOp, ScanOp, SortOp, TopKOp, WindowOp, collect,
)

__all__ = ["Operator", "ScanOp", "MapOp", "HashAggOp", "OrderedAggOp",
           "JoinOp", "DistinctOp", "SortOp", "TopKOp", "LimitOp",
           "WindowOp", "FlowRestart", "collect"]
