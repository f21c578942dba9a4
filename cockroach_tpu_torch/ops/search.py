"""Searches over sorted arrays.

Counterpart of cockroach_tpu/ops/search.py. The JAX package avoids
jnp.searchsorted (a TPU lowering concern); here each function is the
torch op that computes the same thing.
"""

from __future__ import annotations

import torch


def counts_at_most(sorted_ints: torch.Tensor, out_len: int) -> torch.Tensor:
    """[k] = #{i : sorted_ints[i] <= k} for k in [0, out_len), int32 —
    searchsorted(sorted_ints, arange(out_len), side="right") for a
    non-decreasing integer array (negatives count everywhere, values
    >= out_len nowhere). A scatter-add histogram and a prefix sum: no
    read of the data's range on the host."""
    v = sorted_ints.clamp(-1, out_len).to(torch.int64) + 1
    hist = torch.zeros(out_len + 2, dtype=torch.int32,
                       device=sorted_ints.device)
    hist.scatter_add_(0, v, torch.ones_like(v, dtype=torch.int32))
    return torch.cumsum(hist, 0, dtype=torch.int32)[1:out_len + 1]


def searchsorted_left_via_sort(sorted_vals: torch.Tensor,
                               queries: torch.Tensor) -> torch.Tensor:
    """Index of the first element of sorted_vals >= query, per query
    (int32)."""
    return torch.searchsorted(sorted_vals, queries.to(sorted_vals.dtype),
                              side="left").to(torch.int32)


def run_ends(sorted_vals: torch.Tensor) -> torch.Tensor:
    """For each position of a sorted array, the index of the LAST element
    equal to it (int32): a flipped cummin over next-run-start indices."""
    n = sorted_vals.shape[0]
    dev = sorted_vals.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    prev = torch.cat([sorted_vals[:1], sorted_vals[:-1]])
    boundary = (sorted_vals != prev) | (idx == 0)
    start_or_inf = torch.where(boundary, idx, n)
    suffix_min = torch.flip(blocked_assoc_min(torch.flip(start_or_inf, (0,))),
                            (0,))
    next_start = torch.cat([suffix_min[1:],
                            torch.full((1,), n, dtype=torch.int32,
                                       device=dev)])
    return next_start - 1


def blocked_assoc_min(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running minimum."""
    return torch.cummin(x, 0).values
