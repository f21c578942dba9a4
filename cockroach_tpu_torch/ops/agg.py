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

The sort-based hash_aggregate, ordered_aggregate and
range_dense_aggregate are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column, Kind, mask_padding
from cockroach_tpu_torch.ops import cuda_kernels
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


def _not_ported(name: str):
    raise NotImplementedError(
        f"{name} is not ported yet (ROADMAP.md queue 1: the hash, ordered "
        f"and range-dense aggregates)")


def hash_aggregate(*args, **kwargs):
    _not_ported("hash_aggregate")


def ordered_aggregate(*args, **kwargs):
    _not_ported("ordered_aggregate")


def range_dense_aggregate(*args, **kwargs):
    _not_ported("range_dense_aggregate")


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
