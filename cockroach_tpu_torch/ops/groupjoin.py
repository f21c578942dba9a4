"""Fused group-join: ONE sort performs an FK->PK equi-join AND the GROUP
BY that keys on the join column; and the single-int-key GROUP BY that
rides one sort.

Counterpart of cockroach_tpu/ops/groupjoin.py (`GJ_FUNCS`,
`GroupJoinResult`, `int_key_aggregate`, `group_join_aggregate`), bit
for bit on every output column, `sel`, `length` and both flags.

Pipeline of the group join (no scatters, no probe-side row gathers):
  1. pack (key - min_key) << 1 | side into ONE u32 (u64 on retry) sort
     key; dead and NULL-key lanes get top-region sentinels tagged as
     probe, so they never look like duplicate build keys;
  2. a stable sort of (key, value): build lanes carry their ROW INDEX as
     the value, probe lanes their packed aggregate inputs
     (ops/bitpack.py);
  3. runid = cumsum(new run); ONE cummax broadcasts (has_build, build
     row) to each run;
  4. per aggregate: extract the input bits, running sums by cumsum;
  5. matched run-END lanes compact to the group capacity; adjacent-end
     cumsum differences give exact group sums and counts, and the build
     GROUP BY columns gather from the build batch at those ends.

The JAX package's keys are uint32 or uint64 lanes. The port carries the
same bits in int64: a u32 key is a non-negative int64 and sorts as it
is; a u64 key sorts by ops/hash.py `unsigned_order`, and `TOP` (bit 63)
is the sign bit, so "below TOP" is "non-negative". `jax.lax.sort((k, v),
num_keys=1)` is stable: here a stable torch.sort of the key and a gather
of the value. The `fallback` and `overflow` flags are 0-d device
tensors, read once by the flow driver.

Departures from the JAX functions, where they give wrong rows (the port
takes its streaming tier's answer, as it does for float group-join
inputs in exec/fused.py):
  - `int_key_aggregate` takes a group's total by a gather of the running
    sum before the run's head, where the JAX function takes the previous
    end by a cummax, which assumes running sums that never decrease: a
    running sum past 2^63 - 1 wraps, and the JAX function then subtracts
    the wrong end (k = [0, 1, 2, 2], v = [2^62, 2^62, 1, 0] gives group
    2 the sum 2^62 + 1 there);
  - both functions raise the fallback flag when the live keys span 2^63
    or more, a span that wraps negative in int64 and passes the JAX
    functions' width test, which then fold distinct keys together.
Elsewhere, and wherever the JAX functions' flags are clear and their
running sums do not wrap, the outputs are the JAX functions' bit for
bit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column
from cockroach_tpu_torch.ops.agg import AggSpec
from cockroach_tpu_torch.ops.bitpack import (
    pack_lanes, plan_pack, srl, width_mask,
)
from cockroach_tpu_torch.ops.hash import SIGN, unsigned_order

GJ_FUNCS = ("sum", "count", "count_star")

_BIG = (1 << 62) - 1
_M32 = 0xFFFFFFFF


class GroupJoinResult(NamedTuple):
    batch: Batch              # group rows at `out_capacity` lanes
    fallback: torch.Tensor    # 0-d bool: rerun via the general join+agg path
    overflow: torch.Tensor    # 0-d bool: rerun with a larger out_capacity


class _Keys:
    """The unsigned key lanes of one width, carried in int64."""

    def __init__(self, key64: bool):
        self.key64 = key64
        self.budget = 62 if key64 else 30
        self.top = SIGN if key64 else 1 << 31

    def order(self, k: torch.Tensor) -> torch.Tensor:
        """An int64 whose signed order is the keys' unsigned order."""
        return unsigned_order(k) if self.key64 else k

    def below_top(self, k: torch.Tensor) -> torch.Tensor:
        return k >= 0 if self.key64 else k < self.top

    def sorted_by_key(self, gk: torch.Tensor, gv: torch.Tensor):
        """(keys, values) in ascending unsigned key order, stable."""
        _, perm = torch.sort(self.order(gk), stable=True)
        return gk[perm], gv[perm]


def _key_i64(batch: Batch, col: str):
    c = batch.col(col)
    live = batch.sel
    if c.validity is not None:
        live = live & c.validity
    return c.values.to(torch.int64), live


def _agg_cols(aggs: Sequence[AggSpec]) -> List[str]:
    out: List[str] = []
    for a in aggs:
        if a.col is not None and a.col not in out:
            out.append(a.col)
    return out


def _extract(sgv, aplan, name, live):
    """(values int64 biased, valid bool) of one packed input per lane."""
    i = aplan.names.index(name)
    raw = srl(sgv, aplan.offsets[i])
    valid = live
    if aplan.nullable[i]:
        valid = live & ((raw & 1) != 0)
        raw = srl(raw, 1)
    return raw & width_mask(aplan.widths[i]), valid


def _ends_first(is_end: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """The lanes of `is_end` in lane order, then the others, cut or padded
    (with lane 0) to `out_capacity` (the JAX package's sort of (lane or
    0xFFFFFFFF, lane))."""
    cidx = torch.argsort((~is_end).to(torch.uint8), stable=True)
    n = cidx.shape[0]
    if n >= out_capacity:
        return cidx[:out_capacity]
    return torch.cat([cidx, cidx.new_zeros(out_capacity - n)])


def _span_too_wide(span: torch.Tensor, budget: int) -> torch.Tensor:
    """Whether a live key span `khi - klo` (int64) needs more than
    `budget` bits. A span of 2^63 or more wraps negative in int64; it is
    too wide too."""
    return (span >= (1 << budget)) | (span < 0)


def _compact(cols: Dict[str, Column], is_end, n_groups, out_capacity):
    top = _ends_first(is_end, out_capacity)
    dev = is_end.device
    valid = torch.arange(out_capacity, device=dev) < n_groups
    ccols = {}
    for nme, col in cols.items():
        zero = torch.zeros((), dtype=col.values.dtype, device=dev)
        ccols[nme] = Column(torch.where(valid, col.values[top], zero),
                            None if col.validity is None
                            else (col.validity[top] & valid))
    length = torch.clamp(n_groups, max=out_capacity).to(torch.int32)
    return Batch(ccols, valid, length)


def int_key_aggregate(
    batch: Batch, key_col: str, aggs: Sequence[AggSpec],
    out_capacity: int = 0, key64: bool = False,
) -> GroupJoinResult:
    """GROUP BY a single integer column without hashing or permutation
    gathers: sort (biased key, packed aggregate inputs) directly, then
    per-group sums as cumsum differences.

    out_capacity == 0 returns the UNCOMPACTED run-ends view: a batch at
    input capacity whose sel marks one lane per group, for a selective
    filter or shrink downstream (Q18's HAVING). A group's total is its
    end lane's running sum less the running sum just before its run's
    head, which one scatter of the heads' positions and a gather find
    (ops/sortjoin.py `_broadcast_heads`'s form): exact mod 2^64 however
    the running sums wrap. A NULL key forms its own single group."""
    c = batch.col(key_col)
    dev = batch.device
    live = batch.sel
    k = c.values.to(torch.int64)
    valid_live = live if c.validity is None else (live & c.validity)
    null_live = live & ~valid_live

    keys = _Keys(key64)
    klo = torch.where(valid_live, k, _BIG).min()
    khi = torch.where(valid_live, k, -_BIG - 1).max()
    anyv = valid_live.any()
    klo = torch.where(anyv, klo, 0)
    key_flag = anyv & _span_too_wide(khi - klo, keys.budget)

    kb = (k - klo).clamp(0, 1 << keys.budget)
    # live NULL keys share ONE sentinel (one NULL group); dead lanes a
    # different one, so runs never mix liveness classes
    dead = keys.top | 2
    gk = torch.where(valid_live, kb,
                     torch.where(null_live, keys.top, dead))

    aplan = plan_pack(batch, _agg_cols(aggs))
    apayv = pack_lanes(batch, aplan)
    agg_flag = aplan.total_bits > 63

    sgk, sgv = keys.sorted_by_key(gk, apayv)
    prev = torch.cat([~sgk[:1], sgk[:-1]])
    newrun = sgk != prev
    newrun[:1].fill_(True)  # a fill, not a copy from the host
    live_s = sgk != dead
    nxt = torch.cat([newrun[1:], torch.ones(1, dtype=torch.bool,
                                            device=dev)])
    is_end = nxt & live_s

    # each lane's run head; the lane before it ends the previous run
    n = sgk.shape[0]
    runid = torch.cumsum(newrun, 0, dtype=torch.int32) - 1
    heads = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    heads.scatter_(0, torch.where(newrun, runid, n).long(),
                   torch.arange(n, dtype=torch.int32, device=dev))
    head = heads[runid.long()].long()
    first_run = head == 0
    before_head = (head - 1).clamp(min=0)

    def seg_total(cum):
        """Per-run totals at end lanes (uncompacted)."""
        prev_end = torch.where(first_run, 0, cum[before_head])
        return torch.where(is_end, cum - prev_end, 0)

    cnt_all = torch.cumsum(live_s.to(torch.int64), 0)
    cols: Dict[str, Column] = {}
    in_range = keys.below_top(sgk)
    kv = torch.where(live_s & in_range, sgk + klo, 0)
    key_validity = None
    if c.validity is not None:
        key_validity = is_end & in_range
    cols[key_col] = Column(torch.where(is_end, kv, 0).to(c.values.dtype),
                           key_validity)

    for a in aggs:
        if a.func == "count_star":
            cols[a.out] = Column(seg_total(cnt_all), None)
            continue
        v, avalid = _extract(sgv, aplan, a.col, live_s)
        i = aplan.names.index(a.col)
        # non-nullable inputs: the valid-count cumsum is cnt_all
        cum_valid = (torch.cumsum(avalid.to(torch.int64), 0)
                     if aplan.nullable[i] else cnt_all)
        nv = seg_total(cum_valid)
        if a.func == "count":
            cols[a.out] = Column(nv, None)
            continue
        s = seg_total(torch.cumsum(torch.where(avalid, v, 0), 0))
        tot = s + nv * aplan.los[i]
        cols[a.out] = Column(torch.where(nv > 0, tot, 0), nv > 0)

    n_groups = is_end.sum()
    fallback = key_flag | agg_flag
    if not out_capacity:
        out = Batch(cols, is_end, n_groups.to(torch.int32))
        return GroupJoinResult(out, fallback,
                               torch.zeros((), dtype=torch.bool, device=dev))
    out = _compact(cols, is_end, n_groups, out_capacity)
    return GroupJoinResult(out, fallback, n_groups > out_capacity)


def group_join_aggregate(
    probe: Batch, build: Batch,
    probe_on: str, build_on: str,
    key_out: str, key_dtype,
    build_cols: Sequence[str],
    aggs: Sequence[AggSpec],
    out_capacity: int,
    key64: bool = False,
    wide_payload: bool = False,
) -> GroupJoinResult:
    """Inner-join `probe` with unique-keyed `build` on single integer
    columns and aggregate probe rows grouped by the key (+`build_cols`).
    `aggs` are internal specs (sum/count/count_star over probe columns).

    Build lanes carry their ROW INDEX as the sort's value operand: the
    output is only `out_capacity` compacted group rows, so build columns
    gather from the build batch at the run ENDS. Wide mode is needed only
    for the KEY and for aggregate inputs wider than 31 bits. (The JAX
    function's unused `payload_ops` argument is left out.)"""
    rcap = build.capacity
    dev = probe.device
    bk, blive = _key_i64(build, build_on)
    pk, plive = _key_i64(probe, probe_on)
    keys = _Keys(key64)

    # ---- dynamic key bias + static-width check -------------------------
    klo = torch.minimum(torch.where(blive, bk, _BIG).min(),
                        torch.where(plive, pk, _BIG).min())
    khi = torch.maximum(torch.where(blive, bk, -_BIG - 1).max(),
                        torch.where(plive, pk, -_BIG - 1).max())
    any_live = blive.any() | plive.any()
    klo = torch.where(any_live, klo, 0)
    key_flag = any_live & _span_too_wide(khi - klo, keys.budget)

    bb = (bk - klo).clamp(0, 1 << keys.budget)
    pb = (pk - klo).clamp(0, 1 << keys.budget)
    sent = keys.top | 1
    gk_b = torch.where(blive, bb << 1, sent)
    gk_p = torch.where(plive, (pb << 1) | 1, sent)

    # ---- value operand: build row index | packed aggregate inputs ------
    aplan = plan_pack(probe, _agg_cols(aggs))
    apayv = pack_lanes(probe, aplan)
    agg_flag = aplan.total_bits > (62 if wide_payload else 31)
    if not wide_payload:
        apayv = apayv & _M32  # the u32 value operand
    gk = torch.cat([gk_b, gk_p])
    gv = torch.cat([torch.arange(rcap, dtype=torch.int64, device=dev),
                    apayv])
    sgk, sgv = keys.sorted_by_key(gk, gv)

    # ---- runs + broadcast of the build ROW INDEX ----------------------
    prev = torch.cat([sgk[:1] | 1, sgk[:-1]])
    # equality of the top 63 bits: the same under either shift
    newrun = (sgk >> 1) != (prev >> 1)
    newrun[:1].fill_(True)  # a fill, not a copy from the host
    live_lane = keys.below_top(sgk)
    is_b = ((sgk & 1) == 0) & live_lane
    dup_flag = (is_b & ~newrun).any()
    runid = torch.cumsum(newrun.to(torch.int32), 0,
                         dtype=torch.int32).to(torch.int64)
    # one narrow cummax always suffices: the payload is a row index
    enc = (runid << 32) | torch.where(is_b, sgv + 1, 0)
    m = torch.cummax(enc, 0).values
    low = m & _M32
    has_b = low > 0
    brow = low - 1  # build row per run (valid where has_b)
    matched = has_b & ~is_b & live_lane

    # ---- segmented aggregation via cumsum ------------------------------
    cums: List = []   # one per agg, in spec order
    cnt_all = torch.cumsum(matched.to(torch.int64), 0)
    for a in aggs:
        if a.func == "count_star":
            cums.append(cnt_all)
            continue
        v, avalid = _extract(sgv, aplan, a.col, matched)
        i = aplan.names.index(a.col)
        cnt_cum = (torch.cumsum(avalid.to(torch.int64), 0)
                   if aplan.nullable[i] else cnt_all)
        if a.func == "count":
            cums.append(cnt_cum)
        else:  # sum of biased values + bias * count afterwards
            cums.append((torch.cumsum(torch.where(avalid, v, 0), 0),
                         cnt_cum))

    # ---- compact matched run-END lanes ---------------------------------
    nxt = torch.cat([newrun[1:], torch.ones(1, dtype=torch.bool,
                                            device=dev)])
    is_end = nxt & matched
    C = out_capacity
    top = _ends_first(is_end, C)
    n_ends = is_end.sum()
    valid = torch.arange(C, device=dev) < n_ends
    overflow = n_ends > C

    e_sgk = sgk[top]
    e_key = (srl(e_sgk, 1) if key64 else e_sgk >> 1) + klo

    def ends_diff(c):
        e = c[top]
        p = torch.cat([e.new_zeros(1), e[:-1]])
        return torch.where(valid, e - p, 0)

    cols: Dict[str, Column] = {}
    zero_key = torch.zeros((), dtype=key_dtype, device=dev)
    cols[key_out] = Column(torch.where(valid, e_key.to(key_dtype), zero_key),
                           None)
    # build columns: <= out_capacity gathers from the build batch
    e_brow = torch.where(valid, brow[top], 0).clamp(0, rcap - 1)
    for nme in build_cols:
        c = build.col(nme)
        zero = torch.zeros((), dtype=c.values.dtype, device=dev)
        v = torch.where(valid, c.values[e_brow], zero)
        vy = valid if c.validity is None else (c.validity[e_brow] & valid)
        cols[nme] = Column(v, vy)
    for a, c in zip(aggs, cums):
        if a.func in ("count", "count_star"):
            cols[a.out] = Column(ends_diff(c), None)
        else:
            i = aplan.names.index(a.col)
            s = ends_diff(c[0])
            cnt = ends_diff(c[1])
            sv = s + cnt * aplan.los[i]
            # SQL: SUM over zero non-NULL inputs is NULL
            cols[a.out] = Column(torch.where(cnt > 0, sv, 0), cnt > 0)

    out = Batch(cols, valid, torch.clamp(n_ends, max=C).to(torch.int32))
    fallback = key_flag | agg_flag | dup_flag
    return GroupJoinResult(out, fallback, overflow)
