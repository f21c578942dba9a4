"""Unique-build equi-join: two narrow sorts, one cummax broadcast and one
row-matrix gather.

Counterpart of the row-matrix path of cockroach_tpu/ops/sortjoin.py
(prepare_unique with carry=False, probe_unique down its `mat` branch):

  1. pack each row's join key and a build/probe tag bit into ONE 64-bit
     sort key (the raw biased value for a single integer key — exact; a
     62-bit hash otherwise). Dead and NULL-key lanes get per-lane keys in
     the top region (_TOP = bit 63);
  2. sort [build ++ probe] by that key (its int64 image `^ SIGN`, so the
     unsigned order holds and the top region sorts last), stable, keeping
     the source index. Equal keys become adjacent, build row first;
  3. a cummax over (runid << 32 | build index + 1) broadcasts each run's
     build row to the run: a probe lane matches iff its run has one;
  4. a build lane that does not start its run means a duplicate build key
     (or a 62-bit hash collision): the deferred `fallback` flag tells the
     flow to restart the join in the general expand mode (ops/join.py);
  5. each lane's (matched build row << 1 | match) goes back to its probe
     position — a scatter by destination, which is a permutation, in
     place of the JAX package's second sort;
  6. ONE (lcap, W) row gather pulls each matched build row's columns from
     the build side's row matrix (ops/rowmat.py).

Output capacity == probe capacity; the probe's columns never move.

The payload-carry path (_probe_carry, ops/bitpack.py) is not ported: the
streaming JoinOp never takes it (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column
from cockroach_tpu_torch.ops.hash import SIGN, flush_subnormal, unsigned_order
from cockroach_tpu_torch.ops.rowmat import RowPlan, pack_rows, unpack_rows

_TOP = SIGN                    # uint64 1 << 63: sentinel region
_BIAS = 1 << 61                # int-key bias: [-2^61, 2^61) -> u62
_MASK62 = (1 << 62) - 1


class UniqueBuild(NamedTuple):
    """A build side prepared for the unique-key sort join."""

    batch: Batch
    packed: torch.Tensor      # int64 (rcap,) holding the uint64 key, tag 0
    mat: torch.Tensor         # (rcap, W) int64 row matrix
    key_kind: str             # "int" (exact) | "hash" (verify via key cols)
    range_flag: torch.Tensor  # 0-d bool: an int key fell outside ±2^61
    build_on: tuple
    plan: RowPlan
    seed: int


def _int_key_col(batch: Batch, on: Sequence[str]) -> Optional[Column]:
    """The single integer key column, or None if keys need hashing."""
    if len(on) != 1:
        return None
    c = batch.col(on[0])
    v = c.values
    if not v.dtype.is_floating_point and v.dtype != torch.bool:
        return c
    return None


def _key_live(batch: Batch, on: Sequence[str]) -> torch.Tensor:
    """Live lanes whose key has no NULL: only these can ever match."""
    live = batch.sel
    for n in on:
        c = batch.col(n)
        if c.validity is not None:
            live = live & c.validity
    return live


def _pack_keys(batch: Batch, on: Sequence[str], tag: int, seed: int,
               kind: str):
    """-> (packed keys as int64 uint64 bits, range_flag). Sentinel lanes
    (dead/NULL key) get per-lane keys in the top region: a dead probe lane
    can only pair with the same-index dead build lane, and the key-liveness
    guard kills that match downstream."""
    cap = batch.capacity
    dev = batch.device
    live = _key_live(batch, on)
    if kind == "int":
        kc = _int_key_col(batch, on)
        if kc is None:
            # this side's key is not a single integer column: sentinels
            # only, i.e. no matches (the hash path would not match such
            # pairs either)
            live = torch.zeros(cap, dtype=torch.bool, device=dev)
            v = torch.zeros(cap, dtype=torch.int64, device=dev)
        else:
            v = kc.values.to(torch.int64)
        in_range = (v >= -_BIAS) & (v < _BIAS)
        range_flag = torch.any(live & ~in_range)
        packed = ((v + _BIAS) << 1) | tag
    else:
        from cockroach_tpu_torch.ops.hash import hash_columns

        h = hash_columns(batch, on, seed=seed)
        packed = ((h & _MASK62) << 1) | tag
        range_flag = torch.zeros((), dtype=torch.bool, device=dev)
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    sentinel = _TOP | (lane << 1) | tag
    return torch.where(live, packed, sentinel), range_flag


def prepare_unique(build: Batch, build_on: Sequence[str],
                   seed: int = 0) -> UniqueBuild:
    """The row-matrix unique build (the JAX package's carry=False)."""
    kind = "int" if _int_key_col(build, build_on) is not None else "hash"
    packed, range_flag = _pack_keys(build, build_on, 0, seed, kind)
    mat, plan = pack_rows(build)
    return UniqueBuild(build, packed, mat, kind, range_flag,
                       tuple(build_on), plan, seed)


def _run_build_broadcast(newrun, is_build, perm):
    """-> (has_build, build_perm) per sorted lane: whether this lane's
    run contains a build lane, and that build lane's `perm` value. runid
    is non-decreasing, so the cummax of (runid << 32 | build_perm + 1)
    never leaks a value across run boundaries."""
    runid = torch.cumsum(newrun, 0, dtype=torch.int32)
    enc = (runid.to(torch.int64) << 32) | torch.where(is_build, perm + 1, 0)
    m = torch.cummax(enc, 0).values
    low = (m & 0xFFFFFFFF).to(torch.int32)
    return low > 0, low - 1


def probe_unique(probe: Batch, ub: UniqueBuild, probe_on: Sequence[str],
                 how: str = "inner", track_build: bool = False):
    """Join `probe` against a prepared unique build. Returns a JoinResult
    (ops/join.py) whose batch capacity == probe.capacity (right/outer:
    probe + build capacity). The overflow flag is the fallback signal
    (duplicate build keys, hash collision, int key out of range)."""
    from cockroach_tpu_torch.ops.join import JoinResult, _scatter_flags

    build = ub.batch
    dev = probe.device
    lcap, rcap = probe.capacity, build.capacity
    n = lcap + rcap
    p_packed, p_range = _pack_keys(probe, probe_on, 1, ub.seed, ub.key_kind)

    packed = torch.cat([ub.packed, p_packed])
    s_img, perm = torch.sort(unsigned_order(packed), stable=True)
    s_packed = unsigned_order(s_img)

    prev_packed = torch.cat([s_packed[:1], s_packed[:-1]])
    same_key = (s_packed >> 1) == (prev_packed >> 1)
    pos = torch.arange(n, device=dev)
    newrun = (pos == 0) | ~same_key
    is_build = (s_packed & 1) == 0
    dup = torch.any(is_build & ~newrun)
    fallback = dup | ub.range_flag | p_range

    has_build, build_perm = _run_build_broadcast(newrun, is_build, perm)
    match_sorted = ~is_build & has_build

    # destination: probe lanes -> their probe position [0, lcap), build
    # lanes -> lcap + row; the payload is (matched build row << 1 | match)
    dest = torch.where(perm < rcap, perm + lcap, perm - rcap)
    brow_sorted = build_perm.clamp(0, rcap - 1)
    res_payload = (brow_sorted << 1) | match_sorted.to(torch.int32)
    o_payload = torch.empty_like(res_payload)
    o_payload[dest] = res_payload
    o_match = (o_payload[:lcap] & 1).to(torch.bool)
    o_brow = o_payload[:lcap] >> 1

    key_live = _key_live(probe, probe_on)
    match = o_match & key_live

    emit_build = how in ("inner", "left", "right", "outer")
    bcols = None
    if emit_build or ub.key_kind == "hash":
        rows = torch.where(match, o_brow, 0)
        bcols, _bsel = unpack_rows(ub.mat[rows], ub.plan, valid_and=match)

    if ub.key_kind == "hash":
        # a collision is a verified miss, which is exact: if the probe key
        # WERE in the build, the collision would have been two build
        # lanes in one run -> dup
        verified = match
        for pn, bn in zip(probe_on, ub.build_on):
            pvals, bvals = probe.col(pn).values, bcols[bn].values
            if pvals.dtype.is_floating_point:
                # compare in float32 on both sides (the row matrix
                # carries floats as float32 bits), subnormals as 0.0
                pvals = flush_subnormal(pvals.to(torch.float32))
                bvals = flush_subnormal(bvals.to(torch.float32))
                col_eq = (pvals == bvals) | (torch.isnan(pvals)
                                             & torch.isnan(bvals))
            else:
                if bvals.dtype != pvals.dtype:
                    bvals = bvals.to(pvals.dtype)
                col_eq = pvals == bvals
            verified = verified & col_eq
        match = verified
        if emit_build:
            bcols = {
                nm: Column(
                    torch.where(match, c.values,
                                torch.zeros((), dtype=c.values.dtype,
                                            device=dev)),
                    match if c.validity is None else (c.validity & match))
                for nm, c in bcols.items()}

    matched_build = None
    if track_build or how in ("right", "outer"):
        matched_build = _scatter_flags(rcap, o_brow, match)

    if how == "semi":
        return JoinResult(probe.with_sel(probe.sel & match), fallback,
                          matched_build)
    if how == "anti":
        return JoinResult(probe.with_sel(probe.sel & ~match), fallback,
                          matched_build)

    if how in ("right", "outer"):
        # one batch: lanes [0:lcap] carry the probe side, lanes [lcap:]
        # the unmatched build rows (NULL probe side). The streaming JoinOp
        # probes with the inner/left leg instead and emits unmatched build
        # rows at the end of the stream from `matched_build`.
        cols = {}
        zb = torch.zeros(rcap, dtype=torch.bool, device=dev)
        for nm, c in probe.columns.items():
            vals = torch.cat([c.values, torch.zeros(rcap, dtype=c.values.dtype,
                                                    device=dev)])
            cols[nm] = Column(vals, torch.cat([c.valid_mask(), zb]))
        tail_sel = build.sel & ~matched_build
        for nm, c in build.columns.items():
            mc = bcols[nm]
            vals = torch.cat([mc.values, c.values])
            valid = torch.cat([mc.valid_mask(), c.valid_mask() & tail_sel])
            cols[nm] = Column(vals, valid)
        head_sel = probe.sel if how == "outer" else (probe.sel & match)
        sel = torch.cat([head_sel, tail_sel])
        return JoinResult(Batch(cols, sel, sel.sum(dtype=torch.int32)),
                          fallback, matched_build)

    cols = dict(probe.columns)
    cols.update(bcols)
    sel = probe.sel if how == "left" else (probe.sel & match)
    return JoinResult(Batch(cols, sel, sel.sum(dtype=torch.int32)),
                      fallback, matched_build)
