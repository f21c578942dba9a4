"""Aggregation: the dense (sort-free) GROUP BY for small static key domains.

Counterpart of the dense route of cockroach_tpu/ops/agg.py. When every
GROUP BY column has a statically known small domain (dictionary codes,
bools), the group space is a fixed D = prod(sizes) lanes, and the group
with packed code g lives at lane g: partials from different batches merge
lane-wise (dense_merge), with no sort and no data-dependent shapes.

Integer sums and counts go through one pass of the CUDA kernel K1
(ops/cuda_kernels.py dense_sums) on a CUDA tensor, or its plain version on
a CPU tensor; every other aggregate (and every aggregate with the
sql.gpu.kernels setting off) takes the masked (rows, D) broadcast path.

The sort-based route (hash_aggregate, ordered_aggregate) is the
counterpart of the JAX package's: group rows into contiguous runs by a
sort (ops/hashtable.py), then evaluate every aggregate as a prefix
operation over the sorted view, read at each run's end:

- sum/count:    cumsum, then the difference at run ends;
- min/max/bool: segmented scan (reset at run boundaries);
- any_not_null: segmented "first live value" scan.

Integer sums wrap mod 2^64 exactly as the JAX package's do; group order
(the hash order with method="hash") equals the JAX package's bit for bit.

range_dense_aggregate is the direct-address GROUP BY over one integer
key of a known value range: a scatter of each row into the lane of its
key. HashAggOp takes it when given `dense_range`; the JAX planner's hint
that would give it stays off (sql/plan.py ENABLE_RANGE_DENSE_HINT).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column, Kind, mask_padding
from cockroach_tpu_torch.ops import cuda_kernels
from cockroach_tpu_torch.ops.hashtable import (
    SortedGroups, col_equal, sorted_groups,
)
from cockroach_tpu_torch.ops.prefix import blocked_assoc_scan, blocked_cumsum
from cockroach_tpu_torch.util.settings import KERNELS, Settings

SUPPORTED = ("sum", "count", "count_star", "min", "max", "avg",
             "bool_and", "bool_or", "any_not_null",
             # two-lane wide-sum halves: exact accumulation beyond int64,
             # recombined host-side (exec/operators.py assemble_wide_sums)
             "sum_hi32", "sum_lo32")


@dataclass(frozen=True)
class AggSpec:
    """One aggregate: func over input column `col`, output named `out`.

    `wide=True` (sum only) requests exact accumulation beyond int64: the
    flow layer decomposes it into sum_hi32/sum_lo32 halves whose host
    recombination `hi * 2**32 + lo` is exact for any row count < 2^31.
    """

    func: str
    col: Optional[str]  # None for count_star
    out: str
    wide: bool = False

    def __post_init__(self):
        if self.func not in SUPPORTED:
            raise ValueError(f"unsupported aggregate {self.func}")
        if self.col is None and self.func != "count_star":
            raise ValueError(f"{self.func} needs an input column")
        if self.wide and self.func != "sum":
            raise ValueError("wide accumulation applies to sum only")


RANGE_DENSE_FUNCS = ("sum", "count", "count_star", "min", "max",
                     "sum_hi32", "sum_lo32")


def range_dense_aggregate(batch: Batch, key_name: str, lo: int, span: int,
                          aggs: Sequence[AggSpec]):
    """GROUP BY over ONE integer key with a known value range
    [lo, lo + span): the group of key k lives at lane k - lo, a pure
    scatter aggregation (index_add_ / scatter_reduce_ into span + 1 lanes,
    whose last is the drop slot of dead and out-of-range rows). No sort,
    no gather, no hash.

    -> (Batch of span lanes, 0-d out-of-range flag). A live row whose key
    falls outside the range, or is NULL, raises the deferred flag; the
    restart disables this path. Output merges lane-wise with dense_merge.
    Integer sums wrap mod 2^64 exactly; a float32 sum on CUDA adds in an
    order the atomics choose."""
    c = batch.col(key_name)
    dev = batch.device
    key = c.values.to(torch.int64)
    live = batch.sel if c.validity is None else (batch.sel & c.validity)
    idx = key - lo
    in_range = (idx >= 0) & (idx < span)
    flag = torch.any(live & ~in_range)
    if c.validity is not None:
        # SQL groups NULL keys as their own group; the direct-address
        # space has no NULL slot: a live NULL key disables this path
        flag = flag | torch.any(batch.sel & ~c.validity)
    ok = live & in_range
    at = torch.where(ok, idx, span)

    present = torch.zeros(span + 1, dtype=torch.bool, device=dev)
    present.index_fill_(0, at, True)
    present = present[:span]
    out_cols: dict = {key_name: Column(
        (torch.arange(span, dtype=torch.int64, device=dev) + lo)
        .to(c.values.dtype))}
    counts_cache: dict = {}

    def scatter_add(src_ok, vals, dtype):
        out = torch.zeros(span + 1, dtype=dtype, device=dev)
        out.index_add_(0, torch.where(src_ok, at, span), vals)
        return out[:span]

    def live_count(col: Optional[str]):
        if col not in counts_cache:
            src = ok if col is None else (ok & batch.col(col).valid_mask())
            counts_cache[col] = scatter_add(
                src, torch.ones_like(at), torch.int64)
        return counts_cache[col]

    for a in aggs:
        if a.func not in RANGE_DENSE_FUNCS:
            raise AssertionError(f"range-dense unsupported: {a.func}")
        if a.func == "count_star":
            out_cols[a.out] = Column(live_count(None))
            continue
        vc = batch.col(a.col)
        vlive = ok & vc.valid_mask()
        any_live = live_count(a.col) > 0
        if a.func == "count":
            out_cols[a.out] = Column(live_count(a.col))
        elif a.func in ("sum", "sum_hi32", "sum_lo32"):
            v = vc.values
            if a.func != "sum":
                v = _wide_half(a.func, v)
            acc = torch.float32 if v.dtype.is_floating_point else v.dtype
            vv = torch.where(vlive, v, torch.zeros((), dtype=v.dtype,
                                                   device=dev)).to(acc)
            out_cols[a.out] = Column(scatter_add(vlive, vv, acc), any_live)
        else:  # min / max
            ident = _identity(a.func, vc.values.dtype)
            init = torch.full((span + 1,), ident, dtype=vc.values.dtype,
                              device=dev)
            vv = torch.where(vlive, vc.values, ident)
            init.scatter_reduce_(0, torch.where(vlive, at, span), vv,
                                 reduce="amin" if a.func == "min"
                                 else "amax")
            out_cols[a.out] = Column(init[:span], any_live)
    out_cols = mask_padding(out_cols, present)
    return Batch(out_cols, present, present.sum(dtype=torch.int32)), flag


def _identity(func: str, dtype: torch.dtype):
    """The fill value a masked-out row contributes to min/max."""
    if func in ("min", "bool_and"):
        if dtype == torch.bool:
            return True
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    if func in ("max", "bool_or"):
        if dtype == torch.bool:
            return False
        if dtype.is_floating_point:
            return float("-inf")
        return torch.iinfo(dtype).min
    raise AssertionError(func)


def _wide_half(func: str, v: torch.Tensor) -> torch.Tensor:
    """Exact two's-complement split: v == (v >> 32) * 2**32 + (v & mask)
    with arithmetic shift, for any signed int64 v."""
    v = v.to(torch.int64)
    if func == "sum_hi32":
        return v >> 32
    return v & 0xFFFFFFFF


# ------------------------------------------------------- sort-based route

def _shift1(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one lane (lane 0 keeps its own value)."""
    return torch.cat([x[:1], x[:-1]])


def _seg_scan(op, vals: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan: combine resets at run boundaries.
    combine((a,f1),(b,f2)) = (f2 ? b : op(a,b), f1|f2) — associative."""

    def combine(x, y):
        a, f1 = x
        b, f2 = y
        return torch.where(f2, b, op(a, b)), f1 | f2

    out, _ = blocked_assoc_scan(combine, (vals, boundary))
    return out


def _seg_first_live(vals, live, boundary):
    """Per run: first value where live is True (value, found)."""

    def combine(x, y):
        av, ah, f1 = x
        bv, bh, f2 = y
        nv = torch.where(ah, av, bv)
        nh = ah | bh
        return (torch.where(f2, bv, nv), torch.where(f2, bh, nh), f1 | f2)

    v, h, _ = blocked_assoc_scan(combine, (vals, live, boundary))
    return v, h


def _run_boundaries(cols: dict, group_by: Sequence[str],
                    sel_sorted: torch.Tensor) -> torch.Tensor:
    """Run starts of sorted (or already grouped) columns: a live lane
    whose keys differ from the previous lane's, or the first live lane.
    -> (boundary, same-as-previous)."""
    cap = sel_sorted.shape[0]
    idx = torch.arange(cap, device=sel_sorted.device)
    same = torch.ones(cap, dtype=torch.bool, device=sel_sorted.device)
    for n in group_by:
        v, valid = cols[n]
        same = same & col_equal(v, _shift1(v), valid,
                                None if valid is None else _shift1(valid))
    same = same & (idx > 0)
    first_live = sel_sorted & (torch.cumsum(sel_sorted, 0) == 1)
    boundary = sel_sorted & (first_live | ~same)
    boundary = torch.cat([sel_sorted[:1], boundary[1:]])
    return boundary, same


class _SortedView:
    """Per-(batch, group_by) state shared by all aggregates.

    method="hash": sort (hash, iota) — the int64 image of the uint64 key
    hash, stable, dead lanes last — then move every column once as a
    (cap, W) row matrix (ops/rowmat.py). Boundaries come from adjacent
    comparison of the sorted columns, and collisions are detected exactly
    as in sorted_groups.

    method="lex": the exact multi-key lexsort (sorted_groups) with
    per-column gathers.

    method="ordered": the input is already grouped in contiguous runs
    (SortOp output); no sort at all.
    """

    def __init__(self, batch: Batch, group_by: Sequence[str],
                 seed: int = 0, method: str = "lex"):
        cap = batch.capacity
        dev = batch.device
        self.cap = cap
        self._sorted: dict = {}
        no_collision = torch.zeros((), dtype=torch.bool, device=dev)

        if method == "ordered":
            self.perm = None
            self.sel_sorted = batch.sel
            for n, c in batch.columns.items():
                self._sorted[n] = (c.values, c.validity)
            boundary, _same = _run_boundaries(self._sorted, group_by,
                                              self.sel_sorted)
            self.sg = self._groups(boundary, None, no_collision)
        elif method == "hash":
            from cockroach_tpu_torch.ops.hash import (
                ALL_ONES, hash_columns, unsigned_order,
            )
            from cockroach_tpu_torch.ops.rowmat import pack_rows, unpack_rows

            group_by = list(group_by)
            h = hash_columns(batch, group_by, seed=seed)
            h = torch.where(batch.sel, h, ALL_ONES)
            h_sorted, perm = torch.sort(unsigned_order(h), stable=True)
            self.perm = perm
            mat, plan = pack_rows(batch)
            cols_sorted, self.sel_sorted = unpack_rows(mat[perm], plan)
            for n, c in cols_sorted.items():
                self._sorted[n] = (c.values, c.validity)
            boundary, same = _run_boundaries(self._sorted, group_by,
                                             self.sel_sorted)
            prev_live = _shift1(self.sel_sorted) & (
                torch.arange(cap, device=dev) > 0)
            collision = torch.any(self.sel_sorted & prev_live
                                  & (h_sorted == _shift1(h_sorted)) & ~same)
            self.sg = self._groups(boundary, perm, collision)
        else:
            sg = sorted_groups(batch, group_by, seed=seed, method=method)
            self.sg = sg
            self.perm = sg.perm
            self.sel_sorted = batch.sel[sg.perm]
        self._init_extents(cap)

    def _groups(self, boundary, perm, collision) -> SortedGroups:
        gid = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
        num_groups = boundary.sum(dtype=torch.int32)
        gid = torch.where(self.sel_sorted, gid, self.cap)
        return SortedGroups(perm, None, boundary, gid, num_groups, collision)

    def _init_extents(self, cap: int):
        from cockroach_tpu_torch.ops.search import counts_at_most

        g = torch.arange(cap, device=self.sel_sorted.device)
        # group extents from a histogram prefix (gid_sorted is
        # non-decreasing): starts[g] = #{gid < g}, ends[g] = #{gid <= g}-1
        cam = counts_at_most(self.sg.gid_sorted, cap)
        zero = torch.zeros(1, dtype=torch.int32, device=cam.device)
        self.starts = torch.cat([zero, cam[:-1]]).clamp(max=cap - 1)
        self.ends = (cam - 1).clamp(max=cap - 1)
        self.out_sel = g < self.sg.num_groups

    def sorted_col(self, batch: Batch, name: str):
        if name in self._sorted:
            v, valid = self._sorted[name]
            live = (self.sel_sorted if valid is None
                    else (self.sel_sorted & valid))
            return v, live
        c = batch.col(name)
        v = c.values[self.perm]
        live = self.sel_sorted if c.validity is None else (
            self.sel_sorted & c.validity[self.perm])
        return v, live


def _eval_aggs(aggs: Sequence[AggSpec], batch: Batch, view: _SortedView,
               group_keys: Sequence[str] = ()) -> dict:
    """Evaluate every aggregate and the group-key output columns with ONE
    row gather: the per-aggregate prefix arrays (and each key's sorted
    values) are stacked into a (cap, L) int64 matrix whose rows are read
    at run ends. The prefix row before group g is the end row of group
    g-1 (runs are contiguous among live lanes and dead lanes add zero to
    every masked prefix)."""
    if not aggs and not group_keys:
        return {}
    lanes: list = []
    dec: list = []

    def add_lane(arr) -> int:
        dt = arr.dtype
        if dt.is_floating_point:
            lanes.append(arr.to(torch.float32).view(torch.int32)
                         .to(torch.int64) & 0xFFFFFFFF)
            dec.append("f32")
        elif dt == torch.bool:
            lanes.append(arr.to(torch.int64))
            dec.append("bool")
        else:
            lanes.append(arr.to(torch.int64))
            dec.append("i32" if dt == torch.int32 else "i64")
        return len(lanes) - 1

    cnt_lane: dict = {}  # col name (or None=sel) -> live-count lane index

    def count_lane_of(col: Optional[str]) -> int:
        if col not in cnt_lane:
            live = (view.sel_sorted if col is None
                    else view.sorted_col(batch, col)[1])
            cnt_lane[col] = add_lane(blocked_cumsum(live.to(torch.int64)))
        return cnt_lane[col]

    specs = []  # (agg, kind, lane indices...)
    for a in aggs:
        if a.func == "count_star":
            specs.append((a, "diff", count_lane_of(None)))
            continue
        v, live = view.sorted_col(batch, a.col)
        ci = count_lane_of(a.col)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if a.func == "count":
            specs.append((a, "diff", ci))
        elif a.func in ("sum_hi32", "sum_lo32"):
            half = _wide_half(a.func, v)
            i = add_lane(blocked_cumsum(torch.where(live, half, 0)))
            specs.append((a, "diff_valid", i, ci))
        elif a.func in ("sum", "avg"):
            # integers accumulate in their own dtype, anything else in
            # float32 (as the JAX package does)
            acc = (torch.float32 if v.dtype.is_floating_point
                   or v.dtype == torch.bool else v.dtype)
            i = add_lane(blocked_cumsum(torch.where(live, v, zero).to(acc)))
            specs.append((a, "sum" if a.func == "sum" else "avg", i, ci))
        elif a.func in ("min", "max"):
            ident = _identity(a.func, v.dtype)
            op = torch.minimum if a.func == "min" else torch.maximum
            i = add_lane(_seg_scan(op, torch.where(live, v, ident),
                                   view.sg.boundary))
            specs.append((a, "end_valid", i, ci))
        elif a.func in ("bool_and", "bool_or"):
            ident = a.func == "bool_and"
            op = torch.minimum if a.func == "bool_and" else torch.maximum
            i = add_lane(_seg_scan(
                op, torch.where(live, v, ident).to(torch.int32),
                view.sg.boundary))
            specs.append((a, "end_bool", i, ci))
        elif a.func == "any_not_null":
            sv, sh = _seg_first_live(v, live, view.sg.boundary)
            i = add_lane(sv)
            j = add_lane(sh)
            specs.append((a, "first_live", i, j, ci))
        else:
            raise AssertionError(a.func)

    key_specs = []  # (name, value lane, validity lane or None)
    for name in group_keys:
        v, _live = view.sorted_col(batch, name)
        vi = add_lane(v)
        c = batch.col(name)
        if c.validity is not None:
            valid_sorted = (c.validity if view.perm is None
                            else c.validity[view.perm])
            key_specs.append((name, vi, add_lane(valid_sorted)))
        else:
            key_specs.append((name, vi, None))

    P = torch.stack(lanes, dim=1)                     # (cap, L) int64
    end_rows = P[view.ends]
    prev_rows = torch.cat([torch.zeros((1, P.shape[1]), dtype=P.dtype,
                                       device=P.device), end_rows[:-1]])
    has_prev = view.starts > 0

    def decode(v, i):
        if dec[i] == "f32":
            return v.to(torch.int32).view(torch.float32)
        if dec[i] == "bool":
            return v != 0
        return v.to(torch.int32) if dec[i] == "i32" else v

    def at_end(i):
        return decode(end_rows[:, i], i)

    def diff(i):
        e, b = at_end(i), prev_rows[:, i]
        b = decode(b, i) if dec[i] in ("f32", "i32") else b
        return e - torch.where(has_prev, b, torch.zeros((), dtype=e.dtype,
                                                        device=e.device))

    out: dict = {}
    for name, vi, validi in key_specs:
        out[name] = Column(at_end(vi),
                           None if validi is None else at_end(validi))
    for spec in specs:
        a, kind = spec[0], spec[1]
        if kind == "diff":
            out[a.out] = Column(diff(spec[2]))
            continue
        cnt = diff(spec[-1])
        any_live = cnt > 0
        if kind in ("diff_valid", "sum"):
            out[a.out] = Column(diff(spec[2]), any_live)
        elif kind == "avg":
            s = diff(spec[2]).to(torch.float32)
            out[a.out] = Column(s / cnt.clamp(min=1).to(torch.float32),
                                any_live)
        elif kind == "end_valid":
            out[a.out] = Column(at_end(spec[2]), any_live)
        elif kind == "end_bool":
            out[a.out] = Column(at_end(spec[2]) > 0, any_live)
        elif kind == "first_live":
            found = at_end(spec[3])
            found = found if found.dtype == torch.bool else found != 0
            out[a.out] = Column(at_end(spec[2]), found & any_live)
        else:
            raise AssertionError(kind)
    return out


def _scalar_agg(agg: AggSpec, batch: Batch) -> Column:
    """Aggregation without GROUP BY: plain masked reductions, one lane."""
    sel = batch.sel
    if agg.func == "count_star":
        return Column(sel.sum(dtype=torch.int64)[None])
    c = batch.col(agg.col)
    live = sel if c.validity is None else (sel & c.validity)
    v = c.values
    any_live = live.any()[None]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    if agg.func == "count":
        return Column(live.sum(dtype=torch.int64)[None])
    if agg.func in ("sum_hi32", "sum_lo32"):
        half = _wide_half(agg.func, v)
        return Column(torch.where(live, half, 0).sum()[None], any_live)
    if agg.func in ("sum", "avg"):
        if v.dtype.is_floating_point or v.dtype == torch.bool:
            s = torch.where(live, v, zero).to(torch.float32).sum()
        else:
            # integers sum in int64, as jnp.sum does
            s = torch.where(live, v, zero).sum()
        if agg.func == "sum":
            return Column(s[None], any_live)
        cnt = live.sum(dtype=torch.int64).clamp(min=1)
        return Column((s.to(torch.float32) / cnt.to(torch.float32))[None],
                      any_live)
    if agg.func in ("min", "max"):
        filled = torch.where(live, v, _identity(agg.func, v.dtype))
        r = filled.min() if agg.func == "min" else filled.max()
        return Column(r[None], any_live)
    if agg.func in ("bool_and", "bool_or"):
        filled = torch.where(live, v, agg.func == "bool_and")
        r = filled.all() if agg.func == "bool_and" else filled.any()
        return Column(r[None], any_live)
    if agg.func == "any_not_null":
        first = live.to(torch.uint8).argmax()  # first True (0 if none)
        return Column(v[first][None], any_live)
    raise AssertionError(agg.func)


def hash_aggregate(batch: Batch, group_by: Sequence[str],
                   aggs: Sequence[AggSpec], seed: int = 0,
                   method: str = "lex", with_flag: bool = False):
    """GROUP BY group_by. Output: group g at lane g (key-sorted order, or
    hash order with method="hash"), live lanes [0, num_groups). Scalar
    aggregation (group_by=[]) emits one row even over zero input rows.
    With `with_flag`, also returns the 0-d collision flag (method="hash"),
    a device tensor the caller reads once at the end of its stream."""
    if not group_by:
        dev = batch.device
        out_cols = {a.out: _scalar_agg(a, batch) for a in aggs}
        out = Batch(out_cols, torch.ones(1, dtype=torch.bool, device=dev),
                    torch.ones((), dtype=torch.int32, device=dev))
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        return (out, flag) if with_flag else out

    view = _SortedView(batch, group_by, seed=seed, method=method)
    out_cols = dict(_eval_aggs(aggs, batch, view, group_keys=group_by))
    out_cols = mask_padding(out_cols, view.out_sel)
    out = Batch(out_cols, view.out_sel, view.sg.num_groups)
    return (out, view.sg.collision) if with_flag else out


def ordered_aggregate(batch: Batch, group_by: Sequence[str],
                      aggs: Sequence[AggSpec]) -> Batch:
    """Aggregation over input already grouped in contiguous runs (SortOp
    output): no sort at all. Groups keep input run order. Precondition:
    equal group keys are adjacent among selected rows."""
    return hash_aggregate(batch, group_by, aggs, method="ordered")


DENSE_MAX_GROUPS = 256  # (rows x D) broadcast traffic bound


def dense_key_sizes(schema, group_by: Sequence[str]):
    """Per-key domain sizes (incl. a NULL slot) if every group column has a
    statically known small domain; None otherwise."""
    sizes = []
    for n in group_by:
        f = schema.field(n)
        if f.type.kind is Kind.STRING:
            d = schema.dictionary(n)
            if d is None:
                return None
            sizes.append(len(d) + 1)  # +1 = NULL slot
        elif f.type.kind is Kind.BOOL:
            sizes.append(3)  # false, true, NULL
        else:
            return None
    prod = 1
    for s in sizes:
        prod *= s
    if not sizes or prod > DENSE_MAX_GROUPS:
        return None
    return sizes


def _dense_packed(batch: Batch, group_by: Sequence[str],
                  sizes: Sequence[int]) -> Tuple[torch.Tensor, int]:
    """(cap,) packed group code in [0, D); D for dead lanes. NULL keys
    take the last slot of their column's domain."""
    D = 1
    for s in sizes:
        D *= s
    packed = torch.zeros(batch.capacity, dtype=torch.int32, device=batch.device)
    for n, size in zip(group_by, sizes):
        c = batch.col(n)
        code = c.values.to(torch.int32)
        if c.validity is not None:
            code = torch.where(c.validity, code, size - 1)
        packed = packed * size + code
    return torch.where(batch.sel, packed, D).to(torch.int32), D


def _kernel_plan(batch: Batch, aggs: Sequence[AggSpec]):
    """Which aggregates K1 computes, and its columns. -> (values, live,
    plan, rest): column 0 is the implicit row count (values None); plan
    rows are (agg, kind, column index, count column index); rest are the
    aggregates left for the broadcast path."""
    values: List[Optional[torch.Tensor]] = [None]
    live: List[Optional[torch.Tensor]] = [None]
    index: dict = {}

    def add(v, m, key):
        if key not in index:
            values.append(v)
            live.append(m)
            index[key] = len(values) - 1
        return index[key]

    plan = []
    rest = []
    for a in aggs:
        if a.func == "count_star":
            plan.append((a, "count_star", 0, 0))
            continue
        if a.func not in ("count", "sum", "sum_hi32", "sum_lo32"):
            rest.append(a)
            continue
        c = batch.col(a.col)
        if a.func != "count" and c.values.dtype != torch.int64:
            # float sums stay on the f32 broadcast path; narrower int
            # columns keep the broadcast path's own-dtype wrap semantics
            rest.append(a)
            continue
        m = None if c.validity is None else c.validity.contiguous()
        cnt_idx = 0 if m is None else add(None, m, ("cnt", a.col))
        if a.func == "count":
            plan.append((a, "count", cnt_idx, cnt_idx))
            continue
        v = c.values
        if a.func in ("sum_hi32", "sum_lo32"):
            v = _wide_half(a.func, v)
        vi = add(v.contiguous(), m, (a.func, a.col))
        plan.append((a, "sum", vi, cnt_idx))
    return values, live, plan, rest


def dense_kernel_inputs(batch: Batch, group_by: Sequence[str],
                        aggs: Sequence[AggSpec], sizes: Sequence[int]):
    """The arguments dense_aggregate hands to K1 for this batch:
    (packed, values, live, D)."""
    packed, D = _dense_packed(batch, list(group_by), sizes)
    values, live, _plan, _rest = _kernel_plan(batch, aggs)
    return packed, values, live, D


def _dense_kernel_sums(batch: Batch, aggs, packed, D):
    """Route integer sum/count aggregates through K1 (one fused pass).
    Returns (counts, {out: Column}, leftover aggregates for the broadcast
    path); (None, {}, aggs) if nothing qualifies."""
    values, live, plan, rest = _kernel_plan(batch, aggs)
    if not plan:
        return None, {}, list(aggs)
    sums = cuda_kernels.dense_sums(packed, values, live, D)
    counts = sums[0]
    out = {}
    for a, kind, i, cnt_idx in plan:
        if kind == "count_star":
            out[a.out] = Column(counts)
        elif kind == "count":
            out[a.out] = Column(sums[i])
        else:
            out[a.out] = Column(sums[i], sums[cnt_idx] > 0)
    return counts, out, rest


def dense_aggregate(batch: Batch, group_by: Sequence[str],
                    aggs: Sequence[AggSpec], sizes: Sequence[int]) -> Batch:
    """GROUP BY over the dense key space. Output: capacity D, group with
    packed code g at LANE g; sel marks groups with >= 1 selected row."""
    group_by = list(group_by)
    packed, D = _dense_packed(batch, group_by, sizes)
    dev = batch.device

    kernel_cols: dict = {}
    rest = list(aggs)
    counts = None
    if Settings().get(KERNELS) != "off":
        counts, kernel_cols, rest = _dense_kernel_sums(batch, aggs, packed, D)
    mask = None
    lanes = torch.arange(D, dtype=torch.int32, device=dev)
    if rest or counts is None:
        mask = packed[:, None] == lanes[None, :]      # (cap, D)
        if counts is None:
            counts = mask.sum(0, dtype=torch.int64)

    out_cols: dict = {}
    # decode lane -> per-column codes; NULL slot clears validity
    rem = lanes
    codes = []
    for size in reversed(sizes):
        codes.append(rem % size)
        rem = rem // size
    codes.reverse()
    for n, size, code in zip(group_by, sizes, codes):
        c = batch.col(n)
        if c.validity is None:
            out_cols[n] = Column(code.to(c.values.dtype))
        else:
            is_null = code == (size - 1)
            out_cols[n] = Column(
                torch.where(is_null, 0, code).to(c.values.dtype), ~is_null)

    for a in rest:
        out_cols[a.out] = _dense_one(a, batch, mask, counts)
    out_cols.update(kernel_cols)
    sel = counts > 0
    out_cols = mask_padding(out_cols, sel)
    return Batch(out_cols, sel, sel.sum(dtype=torch.int32))


def _dense_one(agg: AggSpec, batch: Batch, mask, counts) -> Column:
    if agg.func == "count_star":
        return Column(counts)
    c = batch.col(agg.col)
    v = c.values
    live = mask if c.validity is None else (mask & c.validity[:, None])
    n_live = live.sum(0, dtype=torch.int64)
    any_live = n_live > 0
    if agg.func == "count":
        return Column(n_live)
    if agg.func in ("sum_hi32", "sum_lo32"):
        half = _wide_half(agg.func, v)
        return Column(torch.where(live, half[:, None], 0).sum(0), any_live)
    if agg.func in ("sum", "avg"):
        masked = torch.where(live, v[:, None], 0)
        # integers accumulate in int64 (narrower ones promote, as jnp.sum
        # does); floats in float32
        s = (masked.to(torch.float32).sum(0) if v.dtype.is_floating_point
             else masked.sum(0))
        if agg.func == "sum":
            return Column(s, any_live)
        mean = s.to(torch.float32) / n_live.clamp(min=1).to(torch.float32)
        return Column(mean, any_live)
    if agg.func in ("min", "max"):
        ident = _identity(agg.func, v.dtype)
        filled = torch.where(live, v[:, None], ident)
        r = filled.amin(0) if agg.func == "min" else filled.amax(0)
        return Column(r, any_live)
    if agg.func in ("bool_and", "bool_or"):
        ident = agg.func == "bool_and"
        filled = torch.where(live, v[:, None], ident)
        r = filled.all(0) if agg.func == "bool_and" else filled.any(0)
        return Column(r, any_live)
    if agg.func == "any_not_null":
        first = live.to(torch.uint8).argmax(0)
        return Column(v[first], any_live)
    raise AssertionError(agg.func)


_DENSE_MERGE = {
    "sum": "sum", "count": "sum", "count_star": "sum",
    "sum_hi32": "sum", "sum_lo32": "sum",
    "min": "min", "max": "max", "bool_and": "bool_and",
    "bool_or": "bool_or", "any_not_null": "any_not_null",
}


def dense_merge(a: Batch, b: Batch, group_by: Sequence[str],
                aggs: Sequence[AggSpec]) -> Batch:
    """Lane-aligned merge of two dense_aggregate outputs (same key space):
    elementwise combines, no sort, no concat."""
    sel = a.sel | b.sel
    out_cols: dict = {}
    for n in group_by:
        ca, cb = a.col(n), b.col(n)
        # mask_padding zeroes key values on lanes dead in a partial: a
        # lane live only in b must take b's values
        if ca.validity is None:
            out_cols[n] = Column(torch.where(a.sel, ca.values, cb.values))
        else:
            out_cols[n] = Column(torch.where(a.sel, ca.values, cb.values),
                                 torch.where(a.sel, ca.validity, cb.validity))
    for spec in aggs:
        f = _DENSE_MERGE[spec.func]
        ca, cb = a.col(spec.out), b.col(spec.out)
        va = ca.valid_mask() if ca.validity is not None else a.sel
        vb = cb.valid_mask() if cb.validity is not None else b.sel
        if f == "sum":
            if ca.validity is None and cb.validity is None:
                out_cols[spec.out] = Column(ca.values + cb.values)
            else:
                out_cols[spec.out] = Column(
                    torch.where(va, ca.values, 0) + torch.where(vb, cb.values, 0),
                    va | vb)
        elif f in ("min", "max"):
            ident = _identity(f, ca.values.dtype)
            xa = torch.where(va, ca.values, ident)
            xb = torch.where(vb, cb.values, ident)
            op = torch.minimum if f == "min" else torch.maximum
            out_cols[spec.out] = Column(op(xa, xb), va | vb)
        elif f in ("bool_and", "bool_or"):
            ident = f == "bool_and"
            xa = torch.where(va, ca.values, ident)
            xb = torch.where(vb, cb.values, ident)
            out_cols[spec.out] = Column(
                xa & xb if f == "bool_and" else xa | xb, va | vb)
        elif f == "any_not_null":
            out_cols[spec.out] = Column(
                torch.where(va, ca.values, cb.values), va | vb)
        else:
            raise AssertionError(f)
    out_cols = mask_padding(out_cols, sel)
    return Batch(out_cols, sel, sel.sum(dtype=torch.int32))
