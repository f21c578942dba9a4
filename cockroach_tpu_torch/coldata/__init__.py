"""Columnar batch format (counterpart of cockroach_tpu/coldata)."""

from cockroach_tpu_torch.coldata.batch import (
    Batch,
    Column,
    ColType,
    Field,
    Kind,
    Schema,
    full_sel,
)
from cockroach_tpu_torch.coldata.arrow import numpy_to_batch

__all__ = ["Batch", "Column", "ColType", "Field", "Kind", "Schema",
           "full_sel", "numpy_to_batch"]
