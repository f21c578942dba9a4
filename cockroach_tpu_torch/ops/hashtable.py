"""Group assignment for GROUP BY — sort-based, scatter-free.

Counterpart of cockroach_tpu/ops/hashtable.py. Grouping is a sort:

1. order the rows by the key columns themselves (method="lex", exact) or
   by one 64-bit key hash (method="hash"); dead lanes sort last;
2. group boundaries = any key column differs from the previous sorted
   row;
3. dense group id = cumsum(boundaries) - 1;
4. everything maps back through the inverse permutation.

With method="hash", distinct keys that share a hash could interleave and
split a group; that is detected exactly (an adjacent pair with equal
hashes and unequal keys) and reported as `collision`, which the flow
answers with a re-seeded rerun.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch
from cockroach_tpu_torch.ops.hash import flush_subnormal


class SortedGroups(NamedTuple):
    """Sorted-run view of a batch grouped by key columns.

    perm:        (cap,) int64 — sorted position -> original row (selected
                 rows first, ordered by key; dead lanes last); None for
                 method="ordered" (no sort).
    inv:         (cap,) int64 — original row -> sorted position, or None.
    boundary:    (cap,) bool — sorted position starts a new group.
    gid_sorted:  (cap,) int32 — group id per sorted position; `cap` on
                 dead lanes.
    num_groups:  0-d int32 tensor.
    collision:   0-d bool tensor — method="hash" only: two distinct key
                 tuples shared a 64-bit hash.
    """

    perm: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]
    boundary: torch.Tensor
    gid_sorted: torch.Tensor
    num_groups: torch.Tensor
    collision: Optional[torch.Tensor] = None


class GroupAssignment(NamedTuple):
    """Original-row-order view.

    group_id:    (cap,) int32 — dense group id per row, -1 if deselected
                 (ids in key-sorted order).
    leader_row:  (cap,) int64 — for g < num_groups, the first sorted row
                 of group g; 0 beyond.
    num_groups:  0-d int32 tensor.
    """

    group_id: torch.Tensor
    leader_row: torch.Tensor
    num_groups: torch.Tensor


def col_equal(va, vb, valid_a, valid_b):
    """GROUP BY equality of two aligned value vectors: NULL == NULL,
    float NaN == NaN, a subnormal float == 0.0 (ops/hash.py
    flush_subnormal)."""
    if va.dtype.is_floating_point:
        va, vb = flush_subnormal(va), flush_subnormal(vb)
    eq = va == vb
    if va.dtype.is_floating_point:
        eq = eq | (torch.isnan(va) & torch.isnan(vb))
    if valid_a is not None:
        eq = torch.where(valid_a & valid_b, eq, valid_a == valid_b)
    return eq


def keys_equal(batch: Batch, names: Sequence[str], rows_a: torch.Tensor,
               rows_b: torch.Tensor) -> torch.Tensor:
    """SQL GROUP BY equality of rows rows_a[i] and rows_b[i]."""
    eq = torch.ones(rows_a.shape[0], dtype=torch.bool, device=rows_a.device)
    for n in names:
        c = batch.col(n)
        va, vb = c.values[rows_a], c.values[rows_b]
        na = nb = None
        if c.validity is not None:
            na, nb = c.validity[rows_a], c.validity[rows_b]
        eq = eq & col_equal(va, vb, na, nb)
    return eq


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering by keys, the LAST key most significant
    (jnp.lexsort's convention): a chain of stable argsorts."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def sorted_groups(batch: Batch, key_names: Sequence[str], seed: int = 0,
                  method: str = "lex") -> SortedGroups:
    """Sort rows into equal-key runs (method "lex" or "hash")."""
    from cockroach_tpu_torch.ops.sort import _sortable_int

    cap = batch.capacity
    dev = batch.device
    if method == "hash":
        from cockroach_tpu_torch.ops.hash import (
            ALL_ONES, hash_columns, unsigned_order,
        )

        h = hash_columns(batch, key_names, seed=seed)
        h = torch.where(batch.sel, h, ALL_ONES)
        perm = torch.argsort(unsigned_order(h), stable=True)
    else:
        lex = []  # least-significant first
        for n in reversed(list(key_names)):
            c = batch.col(n)
            lex.append(_sortable_int(c.values))
            if c.validity is not None:
                lex.append(c.validity.to(torch.int32))  # NULL group first
        lex.append((~batch.sel).to(torch.int32))          # dead lanes last
        perm = lexsort(lex)
    inv = torch.argsort(perm, stable=True)

    idx = torch.arange(cap, device=dev)
    prev = torch.cat([perm[:1], perm[:-1]])
    sel_sorted = batch.sel[perm]
    same_as_prev = keys_equal(batch, key_names, perm, prev)
    first_live = sel_sorted & (torch.cumsum(sel_sorted, 0) == 1)
    boundary = sel_sorted & (first_live | ~same_as_prev)
    # row 0 of the sorted order (if live) always starts a group
    boundary = torch.cat([sel_sorted[:1], boundary[1:]])

    if method == "hash":
        prev_live = batch.sel[prev] & (idx > 0)
        collision = torch.any(sel_sorted & prev_live
                              & (h[perm] == h[prev]) & ~same_as_prev)
    else:
        collision = torch.zeros((), dtype=torch.bool, device=dev)

    gid_sorted = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    num_groups = boundary.sum(dtype=torch.int32)
    gid_sorted = torch.where(sel_sorted, gid_sorted, cap)
    return SortedGroups(perm, inv, boundary, gid_sorted, num_groups,
                        collision)


def group_assignment(batch: Batch, key_names: Sequence[str],
                     seed: int = 0) -> GroupAssignment:
    """Original-row-order group ids (key-sorted id order)."""
    sg = sorted_groups(batch, key_names)
    cap = batch.capacity
    dev = batch.device
    gid = torch.where(batch.sel, sg.gid_sorted[sg.inv], -1).to(torch.int32)
    lanes = torch.arange(cap, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sg.gid_sorted, lanes, side="left")
    leader_row = sg.perm[starts.clamp(max=cap - 1)]
    leader_row = torch.where(lanes < sg.num_groups, leader_row, 0)
    return GroupAssignment(gid, leader_row, sg.num_groups)
