"""Equi-join kernels: inner / left / right / full outer / semi / anti.

Counterpart of cockroach_tpu/ops/join.py. Three build modes, the rungs
JoinOp.widen walks down:

- "unique" (ops/sortjoin.py, the payload carry): the sort join for
  unique integer build keys whose other columns bit-pack into 62 bits;
- "unique-mat" (ops/sortjoin.py): the sort join for unique build keys
  with a row-matrix gather — every FK->PK join; a duplicate key raises
  the deferred fallback flag;
- "expand": the general many-to-many path here:
  1. hash the build keys, argsort the build rows by hash;
  2. per probe row, a search gives the [lo, hi) candidate range;
  3. expand candidate pairs into an `out_capacity`-sized pair list with
     the cumsum / counts_at_most ragged-expand;
  4. verify true key equality per pair (NULL keys never match);
  5. outer variants append unmatched-row regions with a NULL-padded far
     side.
  Matches beyond `out_capacity` set the `overflow` flag; the flow doubles
  the capacity and reruns.

Hashes are int64 lanes holding uint64 bits; every sort and search runs on
their int64 image `^ SIGN` (ops/hash.py unsigned_order), which keeps the
JAX package's unsigned order.

merge_join probes a build side already sorted on its single integer key
with the same core, searching the raw key values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column, concat_batches
from cockroach_tpu_torch.ops.hash import (
    ALL_ONES, flush_subnormal, hash_columns, unsigned_order,
)
from cockroach_tpu_torch.ops.prefix import blocked_cumsum

JOIN_TYPES = ("inner", "left", "right", "outer", "semi", "anti")


class JoinResult(NamedTuple):
    batch: Batch
    overflow: torch.Tensor      # 0-d bool: matches exceeded out_capacity
    # (rcap,) bool: build rows matched by THIS probe batch; streaming
    # right/full-outer joins OR these across probe batches
    matched_build: Optional[torch.Tensor] = None


class BuildTable(NamedTuple):
    """A hash-prepared build side: batch + hash-sorted order + per-position
    run extents. The probe hashes with the same `seed`."""

    batch: Batch
    order: torch.Tensor        # int64 (rcap,): build rows by ascending hash
    hash_sorted: torch.Tensor  # int64 (rcap,): sorted hashes, unsigned_order
    run_end: torch.Tensor      # int32 (rcap,): last index of each equal run
    seed: int = 0


def effective_build_mode(mode: str, build_names: Sequence[str],
                         build_on: Sequence[str]) -> str:
    """Static downgrade of the unique fast paths: the row matrix's
    packed-boolean lane holds at most 64 bits (1 sel + 2 per column), so
    build sides of more than 31 columns go straight to expand."""
    if mode not in ("unique", "unique-mat"):
        return mode
    if len(set(build_names) | set(build_on)) > 31:
        return "expand"
    return mode


def prepare_build(right: Batch, right_on: Sequence[str], seed: int = 0,
                  mode: str = "expand"):
    """Prepare the build side for probing: "unique" -> the payload-carry
    sort join, "unique-mat" -> the row-matrix sort join (ops/sortjoin.py);
    "expand" -> the general hash-sort path."""
    if mode in ("unique", "unique-mat"):
        from cockroach_tpu_torch.ops.sortjoin import prepare_unique

        return prepare_unique(right, right_on, seed=seed,
                              carry=(mode == "unique"))
    from cockroach_tpu_torch.ops.search import run_ends

    hr = hash_columns(right, right_on, seed=seed)
    hr = unsigned_order(torch.where(right.sel, hr, ALL_ONES))
    hr_sorted, order = torch.sort(hr, stable=True)
    return BuildTable(right, order, hr_sorted, run_ends(hr_sorted), seed)


def _null_columns(batch: Batch, rows: torch.Tensor,
                  valid_mask: torch.Tensor) -> dict:
    """Gather columns at `rows` but mark validity by `valid_mask` (NULLs
    out the far side of outer-join regions)."""
    out = {}
    for n, c in batch.columns.items():
        vals = torch.where(valid_mask, c.values[rows],
                           torch.zeros((), dtype=c.values.dtype,
                                       device=c.values.device))
        base = (c.validity[rows] if c.validity is not None
                else torch.ones_like(valid_mask))
        out[n] = Column(vals, base & valid_mask)
    return out


def hash_join(left: Batch, right: Batch, left_on: Sequence[str],
              right_on: Sequence[str], how: str = "inner",
              out_capacity: Optional[int] = None, seed: int = 0,
              mode: str = "expand") -> JoinResult:
    """Join left (probe) with right (build). Column names must be
    disjoint except for semi/anti (which emit only left columns)."""
    return hash_join_prepared(left, prepare_build(right, right_on, seed, mode),
                              left_on, right_on, how=how,
                              out_capacity=out_capacity)


def merge_join(left: Batch, right: Batch, left_on: Sequence[str],
               right_on: Sequence[str], how: str = "inner",
               out_capacity: Optional[int] = None) -> JoinResult:
    """Equi-join when the BUILD side is already sorted on its single join
    key (reference NewMergeJoinOp, colexecjoin/mergejoiner.go:302): no
    hashing and no build hash sort; probe positions come from one search
    on the raw key values, run extents from adjacency. Multi-column or
    float keys go to hash_join.

    Precondition: right's selected rows are sorted ascending (NULLs
    anywhere — they never match). left need not be sorted."""
    if how not in JOIN_TYPES:
        raise ValueError(f"unknown join type {how}")
    lc = left.col(left_on[0]) if len(left_on) == 1 else None
    rc = right.col(right_on[0]) if len(right_on) == 1 else None
    if (lc is None or rc is None or lc.values.dtype.is_floating_point
            or rc.values.dtype.is_floating_point):
        return hash_join(left, right, left_on, right_on, how=how,
                         out_capacity=out_capacity)
    from cockroach_tpu_torch.ops.search import run_ends

    top = torch.iinfo(torch.int64).max
    rkey = torch.where(right.sel & rc.valid_mask(),
                       rc.values.to(torch.int64), top)
    # dead and NULL lanes may interleave the sorted live rows: one stable
    # argsort restores a clean layout
    rkey_sorted, order = torch.sort(rkey, stable=True)
    lkey = torch.where(left.sel & lc.valid_mask(),
                       lc.values.to(torch.int64), top - 1)
    return _probe_sorted(left, right, order, rkey_sorted,
                         run_ends(rkey_sorted), lkey, left_on, right_on,
                         how, out_capacity)


def hash_join_prepared(left: Batch, build, left_on: Sequence[str],
                       right_on: Sequence[str], how: str = "inner",
                       out_capacity: Optional[int] = None,
                       track_build: bool = False) -> JoinResult:
    """Probe a prepared build side (BuildTable or UniqueBuild).
    `track_build` forces the matched_build flags (streaming right/outer
    joins consume them at the end of the stream)."""
    if how not in JOIN_TYPES:
        raise ValueError(f"unknown join type {how}")
    from cockroach_tpu_torch.ops.sortjoin import UniqueBuild, probe_unique

    if isinstance(build, UniqueBuild):
        return probe_unique(left, build, tuple(left_on), how=how,
                            track_build=track_build)
    hl = unsigned_order(hash_columns(left, left_on, seed=build.seed))
    return _probe_sorted(left, build.batch, build.order, build.hash_sorted,
                         build.run_end, hl, left_on, right_on, how,
                         out_capacity, track_build)


def _scatter_flags(n: int, at: torch.Tensor,
                   hit: torch.Tensor) -> torch.Tensor:
    """(n,) bool: True at every `at[i]` with hit[i] (lanes without a hit
    drop)."""
    idx = torch.where(hit, at.to(torch.int64), n)
    flags = torch.zeros(n + 1, dtype=torch.bool, device=at.device)
    # a fill of the indexed lanes: no copy of a host value, so a CUDA
    # graph can capture it
    flags.index_fill_(0, idx, True)
    return flags[:n]


def _probe_sorted(left: Batch, right: Batch, order, key_sorted, run_end, lq,
                  left_on, right_on, how: str, out_capacity: Optional[int],
                  track_build: bool = False) -> JoinResult:
    """Shared probe core: `key_sorted` is the build rows' key (hash image)
    in ascending order via permutation `order`; `lq` is each probe row's
    key in the same space. True-key verification makes the key space only
    a candidate filter."""
    from cockroach_tpu_torch.ops.rowmat import pack_rows, unpack_rows
    from cockroach_tpu_torch.ops.search import (
        counts_at_most, searchsorted_left_via_sort,
    )

    lcap, rcap = left.capacity, right.capacity
    dev = left.device
    if out_capacity is None:
        out_capacity = max(lcap, rcap)

    lo = searchsorted_left_via_sort(key_sorted, lq)
    at = lo.clamp(max=rcap - 1).to(torch.int64)
    found = key_sorted[at] == lq
    hi = torch.where(found, run_end[at] + 1, lo)
    # int64 counters: a skewed many-to-many join can exceed 2^31 pairs
    counts = torch.where(left.sel, (hi - lo).to(torch.int64), 0)

    cum = blocked_cumsum(counts)                   # inclusive
    total = cum[-1]

    out_rows = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    probe_of_out = counts_at_most(cum, out_capacity)
    probe_safe = probe_of_out.clamp(max=lcap - 1).to(torch.int64)
    prev_cum = torch.where(probe_safe > 0, cum[(probe_safe - 1).clamp(min=0)],
                           0)
    j = out_rows - prev_cum
    in_range = out_rows < total
    build_pos = torch.where(in_range, lo[probe_safe] + j.to(torch.int32), 0)
    build_row = order[build_pos.clamp(max=rcap - 1).to(torch.int64)]

    overflow = total > out_capacity

    # whole candidate rows move once per side, as row matrices
    lmat, lplan = pack_rows(left)
    rmat, rplan = pack_rows(right)
    lcols_raw, lsel = unpack_rows(lmat[probe_safe], lplan)
    rcols_raw, rsel = unpack_rows(rmat[build_row], rplan)

    eq = torch.ones(out_capacity, dtype=torch.bool, device=dev)
    for ln, rn in zip(left_on, right_on):
        lc, rc = lcols_raw[ln], rcols_raw[rn]
        lv, rv = lc.values, rc.values
        if lv.dtype.is_floating_point:
            lv, rv = flush_subnormal(lv), flush_subnormal(rv)
        col_eq = lv == rv
        if lv.dtype.is_floating_point:
            col_eq = col_eq | (torch.isnan(lv) & torch.isnan(rv))
        if lc.validity is not None:
            col_eq = col_eq & lc.validity
        if rc.validity is not None:
            col_eq = col_eq & rc.validity
        eq = eq & col_eq
    match = in_range & eq & lsel & rsel

    need_l = how in ("semi", "anti", "left", "outer")
    need_r = track_build or how in ("right", "outer")
    matched_l = _scatter_flags(lcap, probe_safe, match) if need_l else None
    matched_r = _scatter_flags(rcap, build_row, match) if need_r else None

    if how == "semi":
        return JoinResult(left.filter(matched_l), overflow, matched_r)
    if how == "anti":
        return JoinResult(left.filter(left.sel & ~matched_l), overflow,
                          matched_r)

    def masked(cols_raw):
        return {n: Column(
            torch.where(match, c.values,
                        torch.zeros((), dtype=c.values.dtype, device=dev)),
            match if c.validity is None else (c.validity & match))
            for n, c in cols_raw.items()}

    cols = {}
    cols.update(masked(lcols_raw))
    cols.update(masked(rcols_raw))
    pieces = [Batch(cols, match, match.sum(dtype=torch.int32))]

    if how in ("left", "outer"):
        unmatched = left.sel & ~matched_l
        rows = torch.arange(lcap, device=dev)
        cols_l = {}
        cols_l.update(_null_columns(left, rows, unmatched))
        cols_l.update(_null_columns(
            right, torch.zeros(lcap, dtype=torch.int64, device=dev),
            torch.zeros(lcap, dtype=torch.bool, device=dev)))
        pieces.append(Batch(cols_l, unmatched,
                            unmatched.sum(dtype=torch.int32)))

    if how in ("right", "outer"):
        unmatched = right.sel & ~matched_r
        rows = torch.arange(rcap, device=dev)
        cols_r = {}
        cols_r.update(_null_columns(
            left, torch.zeros(rcap, dtype=torch.int64, device=dev),
            torch.zeros(rcap, dtype=torch.bool, device=dev)))
        cols_r.update(_null_columns(right, rows, unmatched))
        pieces.append(Batch(cols_r, unmatched,
                            unmatched.sum(dtype=torch.int32)))

    if len(pieces) == 1:
        return JoinResult(pieces[0], overflow, matched_r)
    return JoinResult(concat_batches(pieces), overflow, matched_r)
