"""ORDER BY over a Batch.

Counterpart of cockroach_tpu/ops/sort.py. Multi-column ORDER BY is a
lexicographic sort over per-column sortable integer keys:

- ints/decimals/dates/dict-codes sort as themselves (string codes through
  a lexicographic rank table); DESC via bitwise NOT;
- float32 maps through the IEEE-754 total-order trick;
- NULLs get a validity key (NULLS FIRST for ASC, NULLS LAST for DESC);
- deselected lanes always sort last, so the output is compact.

`jnp.lexsort` becomes a chain of stable argsorts, least significant key
first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import Batch


@dataclass(frozen=True)
class SortKey:
    col: str
    descending: bool = False
    # None => SQL default (nulls first for ASC, last for DESC)
    nulls_first: bool | None = None


def _sortable_int(values: torch.Tensor) -> torch.Tensor:
    """Map a column to an int64 key with the same ordering."""
    dt = values.dtype
    if dt == torch.bool:
        return values.to(torch.int32)
    if dt.is_floating_point:
        # one positive NaN above +inf (NaN sorts greater than all numbers).
        # The bit work runs in int64 on the zero-extended 32-bit pattern:
        # PyTorch's unsigned shifts are incomplete.
        v = values.to(torch.float32)
        v = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), v)
        bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        negative = (bits >> 31) != 0
        return torch.where(negative, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return values.to(torch.int64)


def _string_rank_table(schema, name, device):
    """Lexicographic rank of each dictionary code (codes are assigned in
    first-occurrence order, so ORDER BY must not compare them directly)."""
    d = schema.dictionary(name)
    if d is None:
        return None
    rank = np.argsort(np.argsort(d.astype(str))).astype(np.int32)
    return torch.from_numpy(rank).to(device)


def lex_keys(batch: Batch, keys: Sequence[SortKey], schema=None) -> List[torch.Tensor]:
    """Least-significant-first integer key columns whose lexicographic
    sort implements ORDER BY `keys` (selected rows first)."""
    lex = []
    for k in reversed(keys):
        c = batch.col(k.col)
        values = c.values
        if schema is not None:
            try:
                rank = _string_rank_table(schema, k.col, batch.device)
            except KeyError:
                rank = None
            if rank is not None:
                values = rank[values.clamp(0, rank.shape[0] - 1).long()]
        kv = _sortable_int(values)
        if k.descending:
            kv = ~kv
        lex.append(kv)
        if c.validity is not None:
            nulls_first = (not k.descending) if k.nulls_first is None else k.nulls_first
            valid = c.validity.to(torch.int32)
            lex.append(valid if nulls_first else 1 - valid)
    lex.append((~batch.sel).to(torch.int32))  # primary: selected rows first
    return lex


def sort_permutation(batch: Batch, keys: Sequence[SortKey],
                     schema=None) -> torch.Tensor:
    """Stable permutation: selected rows first in key order, dead lanes
    last. Pass `schema` when any key is a dictionary-encoded STRING
    column."""
    perm = torch.arange(batch.capacity, device=batch.device)
    for key in lex_keys(batch, keys, schema):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def sort_batch(batch: Batch, keys: Sequence[SortKey], schema=None) -> Batch:
    """ORDER BY. Output is compact: live rows are a prefix."""
    perm = sort_permutation(batch, keys, schema)
    sel = torch.arange(batch.capacity, device=batch.device) < batch.length
    return batch.gather(perm, sel=sel, length=batch.length)
