"""Window functions over a batch sorted by (partition keys, order keys).

Counterpart of cockroach_tpu/ops/window.py: `WINDOW_FUNCS`, `WindowSpec`,
`compute_windows` and its helpers, as plain functions on tensors. The
input arrives sorted by (partition keys, order keys), and every window
function is a data-parallel pass over the flat columns:

- partition and peer boundaries: shifted-compare change masks;
- row_number, rank and dense_rank: index arithmetic against each row's
  segment start;
- running sum, count and avg: prefix sums minus the exclusive prefix at
  the segment start, gathered at the row's last peer (the default RANGE
  frame), in the reference's form: `cs - ex[seg_start]` at `peer_end`,
  then `f32(sum) / f32(max(cnt, 1))`;
- running min and max: a segmented scan (`_seg_scan_minmax`);
- first_value and last_value: gathers at the segment start and the last
  peer;
- lag and lead: rolls with a same-segment check.

Two departures in form, none in value:
- The JAX package finds segment and peer starts and ends with cummax and
  cummin over index lanes. Here a run's start and end come from its run
  id (one cumsum of the change mask), one scatter of the boundary lanes'
  positions and one gather (`_run_bounds`), the form of ops/sortjoin.py
  `_broadcast_heads`. Every run has exactly one first and one last lane,
  so the result is the cummax's and cummin's, exactly, and it avoids
  `torch.cummax`, the slowest op of the port's join probes on the card.
- `jax.lax.associative_scan` has no torch counterpart: the segmented
  min/max is a log-step (Hillis-Steele) scan, ceil(log2 n) steps of
  `torch.where` over shifted tensors. Min and max give the same value in
  any association, NaN included.

Float32 sums associate as torch's cumsum does, which need not be XLA's;
everything else (ints, decimals, counts, ranks, lag/lead, validity) is
bit for bit the JAX package's. String min/max compare lexicographic
ranks of the dictionary codes (the rank table and its inverse are the
sort's cached device tables, ops/sort.py), so a CUDA graph that captured
a window holds them.

No host synchronization and no host-built tensor anywhere: the body runs
inside the fused runner's graph capture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import (
    Batch, ColType, Column, FLOAT, INT, Kind, Schema,
)
from cockroach_tpu_torch.ops.sort import SortKey, string_rank_tables

WINDOW_FUNCS = ("row_number", "rank", "dense_rank", "lag", "lead",
                "first_value", "last_value", "sum", "count", "avg",
                "min", "max")
_AGG_FUNCS = ("sum", "count", "avg", "min", "max")


@dataclass(frozen=True)
class WindowSpec:
    func: str
    col: Optional[str]  # None for row_number/rank/dense_rank/count(*)
    out: str
    offset: int = 1     # lag/lead distance

    def __post_init__(self):
        if self.func not in WINDOW_FUNCS:
            raise ValueError(f"unsupported window function {self.func}")
        if self.func in ("lag", "lead", "first_value", "last_value") \
                and self.col is None:
            raise ValueError(f"{self.func} needs an argument column")

    def out_type(self, schema: Schema) -> ColType:
        if self.func in ("row_number", "rank", "dense_rank", "count"):
            return INT
        if self.func == "avg":
            return FLOAT
        ty = schema.field(self.col).type
        if self.func == "sum" and ty.kind is Kind.FLOAT:
            return FLOAT
        return ty


def _change_mask(cols: List[Column], first: torch.Tensor) -> torch.Tensor:
    """True where any key differs from the previous row (row 0 True).
    `first` is the mask of lane 0: a device tensor, since a scalar
    written into a lane is a host-to-device copy, which a CUDA graph
    capture refuses."""
    changed = first
    for c in cols:
        diff = c.values != torch.roll(c.values, 1)
        if c.validity is not None:
            diff = diff | (c.validity != torch.roll(c.validity, 1))
        changed = changed | diff
    return changed


def _run_bounds(new_mask: torch.Tensor, idx: torch.Tensor):
    """(run id, run start, run end) per lane of the runs that `new_mask`
    opens (lane 0 opens one). Equal to the reference's
    cummax(where(new, idx, 0)) and its reversed cummin of the lanes
    before each next opening."""
    n = new_mask.shape[0]
    rid = torch.cumsum(new_mask, 0, dtype=torch.int64) - 1
    last = torch.roll(new_mask, -1) | (idx == n - 1)
    dump = torch.full_like(rid, n)
    starts = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    starts.scatter_(0, torch.where(new_mask, rid, dump), idx)
    ends = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    ends.scatter_(0, torch.where(last, rid, dump), idx)
    return rid, starts[rid], ends[rid]


def _seg_scan_minmax(values: torch.Tensor, seg_new: torch.Tensor, op
                     ) -> torch.Tensor:
    """Segmented running min/max: the inclusive scan of the combiner
    ((fa, va), (fb, vb)) -> (fa | fb, vb if fb else op(va, vb)), in
    ceil(log2 n) steps (Hillis-Steele)."""
    n = values.shape[0]
    v, f = values, seg_new
    d = 1
    while d < n:
        head_v, head_f = v[:d], f[:d]
        v = torch.cat([head_v, torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([head_f, f[d:] | f[:-d]])
        d *= 2
    return v


def compute_windows(batch: Batch, partition_by: Sequence[str],
                    order_by: Sequence[SortKey],
                    specs: Sequence[WindowSpec],
                    schema: Schema) -> Dict[str, Column]:
    """batch: COMPACTED and sorted by (partition_by, order_by). Returns
    the new window columns (length = batch.capacity, padding masked by
    batch.sel)."""
    n = batch.capacity
    dev = batch.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    first = idx == 0
    part_cols = [batch.col(c) for c in partition_by]
    # padding rows must not join the last partition: fold sel into keys
    sel = batch.sel
    seg_new = (_change_mask(part_cols, first)
               | (sel != torch.roll(sel, 1)))
    order_cols = [batch.col(k.col) for k in order_by]
    peer_new = seg_new | _change_mask(order_cols, first)

    seg_id, seg_start, _ = _run_bounds(seg_new, idx)
    # the SQL default frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW:
    # the frame END is the last PEER row (ties share frame values).
    # Without ORDER BY every partition row is a peer, so peer_end ==
    # seg_end and the frame covers the whole partition — one rule.
    peer_id, peer_start, peer_end = _run_bounds(peer_new, idx)

    out: Dict[str, Column] = {}
    for spec in specs:
        out[spec.out] = _one_window(
            spec, batch, schema, idx, seg_start, peer_start, peer_end,
            peer_id, seg_id, n)
    return out


def _one_window(spec: WindowSpec, batch: Batch, schema: Schema, idx,
                seg_start, peer_start, peer_end, peer_id, seg_id,
                n: int) -> Column:
    if spec.func == "row_number":
        return Column(idx - seg_start + 1)
    if spec.func == "rank":
        return Column(peer_start - seg_start + 1)
    if spec.func == "dense_rank":
        # the peer run id is cumsum(peer_new) - 1
        return Column(peer_id - peer_id[seg_start] + 1)

    if spec.func in ("lag", "lead"):
        c = batch.col(spec.col)
        k = spec.offset if spec.func == "lag" else -spec.offset
        shifted_v = torch.roll(c.values, k)
        src = idx - k
        in_range = (src >= 0) & (src < n)
        same_seg = in_range & (torch.roll(seg_id, k) == seg_id)
        valid = same_seg
        if c.validity is not None:
            valid = valid & torch.roll(c.validity, k)
        return Column(torch.where(same_seg, shifted_v,
                                  torch.zeros_like(shifted_v)), valid)

    c = batch.col(spec.col) if spec.col is not None else None
    if spec.func == "first_value":
        # frame start = UNBOUNDED PRECEDING = partition start
        valid = (c.validity[seg_start] if c.validity is not None else None)
        return Column(c.values[seg_start], valid)
    if spec.func == "last_value":
        # frame end = CURRENT ROW under RANGE framing = last peer row
        valid = (c.validity[peer_end] if c.validity is not None else None)
        return Column(c.values[peer_end], valid)

    # aggregates over the default frame: RANGE UNBOUNDED
    # PRECEDING..CURRENT ROW — computed as a ROWS running value gathered
    # at each row's peer-group end, so ties share one frame value
    assert spec.func in _AGG_FUNCS
    if spec.func == "count" and c is None:
        return Column(peer_end - seg_start + 1)

    live = c.validity
    ones = (torch.ones(n, dtype=torch.int64, device=idx.device)
            if live is None else live.to(torch.int64))
    cs1 = torch.cumsum(ones, 0)
    run_cnt = (cs1 - (cs1 - ones)[seg_start])[peer_end]
    if spec.func in ("sum", "count", "avg"):
        ty = schema.field(spec.col).type
        acc_dtype = (torch.float32 if ty.kind is Kind.FLOAT
                     else torch.int64)
        v = c.values.to(acc_dtype)
        if live is not None:
            v = torch.where(live, v, torch.zeros_like(v))
        cs = torch.cumsum(v, 0)                  # inclusive prefix
        ex = cs - v                              # exclusive prefix
        run_sum = (cs - ex[seg_start])[peer_end]
        if spec.func == "count":
            return Column(run_cnt)
        if spec.func == "sum":
            return Column(run_sum, run_cnt > 0)
        mean = run_sum.to(torch.float32) / torch.clamp(
            run_cnt, min=1).to(torch.float32)
        return Column(mean, run_cnt > 0)

    # min / max
    op = torch.minimum if spec.func == "min" else torch.maximum
    v = c.values
    ty = schema.field(spec.col).type
    rank_inv = None
    if ty.kind is Kind.STRING:
        # dictionary codes are in first-occurrence order: compare
        # lexicographic RANKS, then map the winning rank back to a code
        # (ops/sort.py makes the same transform for ORDER BY)
        tables = string_rank_tables(schema, spec.col, idx.device)
        if tables is not None:
            rank, rank_inv = tables
            v = rank[torch.clamp(v, 0, rank.shape[0] - 1).long()]
    ident = _identity_for(spec.func, v.dtype)
    if live is not None:
        v = torch.where(live, v, torch.full_like(v, ident))
    run = _seg_scan_minmax(v, _starts_from(seg_start, idx), op)[peer_end]
    if rank_inv is not None:
        run = rank_inv[torch.clamp(run, 0, rank_inv.shape[0] - 1).long()
                       ].to(c.values.dtype)
    return Column(run, run_cnt > 0)


def _starts_from(seg_start, idx):
    return seg_start == idx


def _identity_for(func: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if func == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if func == "min" else info.min
