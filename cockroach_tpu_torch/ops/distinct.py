"""Unordered DISTINCT over one batch.

Counterpart of cockroach_tpu/ops/distinct.py. A row survives where its
key-sorted position starts an equal-key run (ops/hashtable.py
sorted_groups' boundary), mapped back through the inverse permutation:
one gather. The survivor of each duplicate set is the first row in key
order, not in row order; SQL DISTINCT does not say which duplicate
survives.
"""

from __future__ import annotations

from typing import Sequence

from cockroach_tpu_torch.coldata.batch import Batch
from cockroach_tpu_torch.ops.hashtable import sorted_groups


def distinct(batch: Batch, key_names: Sequence[str]) -> Batch:
    sg = sorted_groups(batch, key_names)
    keep = sg.boundary[sg.inv]
    return batch.with_sel(batch.sel & keep)
