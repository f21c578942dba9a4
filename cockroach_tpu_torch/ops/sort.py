"""ORDER BY over a Batch.

Counterpart of cockroach_tpu/ops/sort.py. Multi-column ORDER BY is a
lexicographic sort over per-column sortable integer keys:

- ints/decimals/dates/dict-codes sort as themselves (string codes through
  a lexicographic rank table); DESC via bitwise NOT;
- float32 maps through the IEEE-754 total-order trick;
- NULLs get a validity key (NULLS FIRST for ASC, NULLS LAST for DESC);
- deselected lanes always sort last, so the output is compact.

`jnp.lexsort` becomes a chain of stable argsorts, least significant key
first. top_k_batch sorts the keys and moves only the k winning rows.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import Batch, mask_padding


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


# (id of the dictionary, device) -> (the dictionary, its rank table on
# the device): built and copied once, as ops/expr.py `_table` caches an
# operator's tables. Holding the dictionary keeps its id from being
# reused.
_RANK_TABLES: Dict[tuple, tuple] = {}
_RANK_TABLES_MAX = 256
# A CUDA graph that captured a sort reads its rank table by address,
# past the cache's eviction: while `_HOLD.into` is a list, every table
# handed out is appended to it, and the graph's holder keeps the list.
_HOLD = threading.local()


def hold_rank_tables(into: Optional[list]) -> None:
    """Append every rank table handed out on this thread to `into` until
    the next call (None stops)."""
    _HOLD.into = into


def _string_rank_table(schema, name, device):
    """Lexicographic rank of each dictionary code (codes are assigned in
    first-occurrence order, so ORDER BY must not compare them directly)."""
    d = schema.dictionary(name)
    if d is None:
        return None
    key = (id(d), str(torch.device(device)))
    hit = _RANK_TABLES.get(key)
    if hit is not None and hit[0] is d:
        table = hit[1]
    else:
        rank = np.argsort(np.argsort(d.astype(str))).astype(np.int32)
        table = torch.from_numpy(rank).to(device)
        if len(_RANK_TABLES) >= _RANK_TABLES_MAX:
            _RANK_TABLES.pop(next(iter(_RANK_TABLES)))
        _RANK_TABLES[key] = (d, table)
    into = getattr(_HOLD, "into", None)
    if into is not None:
        into.append(table)
    return table


# the same for the inverse of a rank table (the code of each rank): the
# window functions' string min/max map a winning rank back to its code
_INVERSE_TABLES: Dict[tuple, tuple] = {}


def string_rank_tables(schema, name, device):
    """(rank table, its inverse) of a STRING column's dictionary on
    `device`, or None; both cached and held as `_string_rank_table`'s."""
    rank = _string_rank_table(schema, name, device)
    if rank is None:
        return None
    d = schema.dictionary(name)
    key = (id(d), str(torch.device(device)))
    hit = _INVERSE_TABLES.get(key)
    if hit is not None and hit[0] is d:
        inv = hit[1]
    else:
        order = np.argsort(d.astype(str)).astype(np.int32)
        inv = torch.from_numpy(order).to(device)
        if len(_INVERSE_TABLES) >= _RANK_TABLES_MAX:
            _INVERSE_TABLES.pop(next(iter(_INVERSE_TABLES)))
        _INVERSE_TABLES[key] = (d, inv)
    into = getattr(_HOLD, "into", None)
    if into is not None:
        into.append(inv)
    return rank, inv


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


def top_k_batch(batch: Batch, keys: Sequence[SortKey], k: int,
                schema=None) -> Batch:
    """ORDER BY ... LIMIT k with a static output capacity of k rows: sort
    the keys, then move only the k winning rows. Ties keep input order
    (the sort is stable)."""
    perm = sort_permutation(batch, keys, schema)
    if k <= batch.capacity:
        kidx = perm[:k]
    else:
        kidx = torch.cat([perm, torch.zeros(k - batch.capacity,
                                            dtype=perm.dtype,
                                            device=perm.device)])
    length = torch.clamp(batch.length, max=k).to(torch.int32)
    sel = torch.arange(k, device=batch.device) < length
    out = batch.gather(kidx, sel=sel, length=length)
    return Batch(mask_padding(out.columns, sel), sel, length)


def range_top_k(values: torch.Tensor, pks: torch.Tensor, lo, hi, *,
                k: int, window: int, pk0: Optional[int] = None):
    """Top-k (descending) of `values` restricted to rows whose sorted
    primary key falls in [lo, hi), with hi - lo bounded by the static
    `window` — the kernel of a YCSB-E scan+top-K micro-query (JAX
    ops/sort.py range_top_k, bit for bit).

    A searchsorted locates the range start and a static `window`-row
    gather covers it; out-of-range lanes get the dtype's minimum as a
    sentinel. When the key column is known contiguous (`pk0` given:
    pks[i] == pk0 + i), the search and the validity pk reads collapse to
    arithmetic. `lo` and `hi` are scalars (one op) or (B,) tensors (B
    ops at once: one (B, window) gather and one sort along dim 1, what
    the JAX package's `jax.vmap` gives).

    Returns (top values (..., k), valid mask (..., k), matched-row count
    (...,) int32)."""
    dev = values.device
    lo = torch.as_tensor(lo, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=dev)
    n = int(pks.shape[0])
    if pk0 is None:
        start = torch.searchsorted(pks, lo.reshape(-1)).reshape(lo.shape)
    else:
        start = torch.clamp(lo - pk0, 0, n)
    idx = start.unsqueeze(-1) + torch.arange(window, device=dev)
    cidx = torch.clamp(idx, max=max(n - 1, 0))
    if n == 0:
        pk = torch.zeros_like(idx)
        vals = torch.zeros(idx.shape, dtype=values.dtype, device=dev)
    else:
        pk = pks[cidx] if pk0 is None else cidx + pk0
        vals = values[cidx]
    valid = (idx < n) & (pk >= lo.unsqueeze(-1)) & (pk < hi.unsqueeze(-1))
    sentinel = torch.iinfo(values.dtype).min
    masked = torch.where(valid, vals, sentinel)
    top = torch.sort(masked, dim=-1, descending=True).values[..., :k]
    count = valid.sum(-1, dtype=torch.int32)
    mask = (torch.arange(top.shape[-1], device=dev)
            < torch.clamp(count, max=k).unsqueeze(-1))
    return top, mask, count
