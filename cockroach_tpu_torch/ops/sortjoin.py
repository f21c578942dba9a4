"""Unique-build equi-join: two narrow sorts, a cummax broadcast and, on
the row-matrix path, one row gather.

Counterpart of cockroach_tpu/ops/sortjoin.py (`prepare_unique`,
`_probe_carry`, `probe_unique`):

  1. pack each row's join key and a build/probe tag bit into ONE sort key
     (the raw biased value for a single integer key — exact; a 62-bit
     hash otherwise). Dead and NULL-key lanes get per-lane keys in the
     top region;
  2. sort [build ++ probe] by that key, stable. Equal keys become
     adjacent, build row first;
  3. a cummax over (runid << 32 | value) broadcasts each run's build
     lane to the run: a probe lane matches iff its run has one;
  4. a build lane that does not start its run means a duplicate build key
     (or a 62-bit hash collision): the deferred `fallback` flag tells the
     flow to restart the join one rung down (ops/join.py);
  5. each probe lane's result goes back to its probe position — a
     scatter by destination in place of the JAX package's second sort.

Two ways to move the build columns:

- the payload carry ("unique", `prepare_unique(carry=True)`,
  `_probe_carry`): an integer-keyed build whose non-key columns bit-pack
  (ops/bitpack.py) rides the sort as one 64-bit payload, broadcast to its
  run by two cummaxes over 31-bit halves; no row gather. Its keys pack
  narrow, as u32 values in [0, 2^30) (a key outside raises the range
  flag), and sort as int32 in signed order (value - 2^31); a payload
  over 62 bits raises the fallback flag;
- the row matrix ("unique-mat"): the source index rides the sort, and
  ONE (lcap, W) row gather pulls each matched build row's columns from
  the build side's row matrix (ops/rowmat.py). A carry-prepared build
  that reaches a path the carry does not cover (matched-build tracking,
  right/outer) builds its row matrix and 64-bit keys there.

Output capacity == probe capacity; the probe's columns never move. The
JAX package's u64 lanes are int64 lanes here, shifted logically
(ops/bitpack.py srl), sorted in unsigned order (ops/hash.py
unsigned_order).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column
from cockroach_tpu_torch.ops.bitpack import srl
from cockroach_tpu_torch.ops.hash import SIGN, flush_subnormal, unsigned_order
from cockroach_tpu_torch.ops.rowmat import RowPlan, pack_rows, unpack_rows

_TOP = SIGN                    # uint64 1 << 63: sentinel region
_BIAS = 1 << 61                # int-key bias: [-2^61, 2^61) -> u62
_MASK62 = (1 << 62) - 1


class UniqueBuild(NamedTuple):
    """A build side prepared for the unique-key sort join: the row matrix
    (`mat`, `plan`), or the packed payload (`payv`, `pay_plan`) of the
    carry, with u32 keys when `narrow`."""

    batch: Batch
    packed: torch.Tensor      # int64 (rcap,): the uint64 (u32) key, tag 0
    mat: Optional[torch.Tensor]  # (rcap, W) int64 row matrix, or None
    key_kind: str             # "int" (exact) | "hash" (verify via key cols)
    range_flag: torch.Tensor  # 0-d bool: an int key fell out of range
    build_on: tuple
    plan: Optional[RowPlan]
    seed: int
    payv: Optional[torch.Tensor] = None   # int64 (rcap,) packed payload
    pay_plan: object = None               # ops/bitpack.py DynPack
    narrow: bool = False                  # keys are u32 values


def _sort_image(packed: torch.Tensor, narrow: bool) -> torch.Tensor:
    """A key whose signed order is the unsigned order of `packed`: u32
    values as int32 (value - 2^31), 64-bit ones as int64 ^ SIGN."""
    if narrow:
        return (packed - (1 << 31)).to(torch.int32)
    return unsigned_order(packed)


def _from_image(img: torch.Tensor, narrow: bool) -> torch.Tensor:
    if narrow:
        return img.to(torch.int64) + (1 << 31)
    return unsigned_order(img)


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
               kind: str, narrow: bool = False):
    """-> (packed keys as int64 uint64 bits, range_flag). Sentinel lanes
    (dead/NULL key) get per-lane keys in the top region: a dead probe lane
    can only pair with the same-index dead build lane, and the key-liveness
    guard kills that match downstream.

    `narrow` (the carry): u32 values, for keys in [0, 2^30); a live key
    outside raises range_flag, and the restart ladder reverts to the
    64-bit row-matrix path."""
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
        if narrow:
            in_range = (v >= 0) & (v < (1 << 30))
            range_flag = torch.any(live & ~in_range)
            packed = (v.clamp(0, (1 << 30) - 1) << 1) | tag
            lane = torch.arange(cap, dtype=torch.int64, device=dev)
            sentinel = (1 << 31) | (lane << 1) | tag
            return torch.where(live, packed, sentinel), range_flag
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
                   seed: int = 0, carry: bool = True) -> UniqueBuild:
    """The unique build: with `carry`, an integer-keyed build whose
    non-key columns bit-pack carries them as one payload (the key
    columns are rebuilt from the probe key on a match); else, or when
    they do not pack, the row matrix."""
    from cockroach_tpu_torch.ops import bitpack

    kind = "int" if _int_key_col(build, build_on) is not None else "hash"
    noncore = [n for n in build.columns if n not in build_on]
    if carry and kind == "int" and bitpack.packable(build, noncore):
        pay_plan = bitpack.plan_pack(build, noncore)
        payv = bitpack.pack_lanes(build, pay_plan)
        narrow = build.capacity < (1 << 29)
        packed, range_flag = _pack_keys(build, build_on, 0, seed, kind,
                                        narrow=narrow)
        return UniqueBuild(build, packed, None, kind, range_flag,
                           tuple(build_on), None, seed, payv, pay_plan,
                           narrow)
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


def _broadcast_cummax(s_val, newrun, is_build):
    """(has_b, bpay) per sorted lane: the JAX package's broadcast of each
    run's build payload, two cummaxes over its 31-bit halves; runid rides
    the high 32 bits, so a later run always dominates. In a run with
    several build lanes (a duplicate key, flagged) each lane gets the
    halves' running maxima."""
    runid = torch.cumsum(newrun, 0, dtype=torch.int64)
    M31, M32 = 0x7FFFFFFF, 0xFFFFFFFF
    lo31 = s_val & M31
    hi31 = srl(s_val, 31)
    m1 = torch.cummax((runid << 32) | torch.where(is_build, lo31 + 1, 0),
                      0).values
    m2 = torch.cummax((runid << 32) | torch.where(is_build, hi31, 0),
                      0).values
    low1 = m1 & M32
    return low1 > 0, ((low1 - 1) & M31) | ((m2 & M32) << 31)


def _broadcast_heads(s_val, newrun, is_build):
    """(has_b, bpay) per sorted lane without a cummax: the build lane, if
    any, leads its run, so each lane reads its run head, found by one
    cumsum (the run id), one scatter of the heads' positions and a
    gather. Equal to _broadcast_cummax bit for bit in every run with at
    most one build lane (the 31-bit halves rejoin to the payload itself,
    and a run with no build lane gets M31); in a run with a duplicate
    build key, which raises the fallback flag, each lane gets the head's
    payload."""
    n = s_val.shape[0]
    runid = torch.cumsum(newrun, 0, dtype=torch.int32) - 1
    pos = torch.arange(n, dtype=torch.int32, device=s_val.device)
    heads = torch.zeros(n + 1, dtype=torch.int32, device=s_val.device)
    heads.scatter_(0, torch.where(newrun, runid, n).long(), pos)
    head = heads[runid.long()].long()
    has_b = is_build[head]
    return has_b, torch.where(has_b, s_val[head], 0x7FFFFFFF)


def _probe_carry(probe: Batch, ub: UniqueBuild, probe_on: Sequence[str],
                 how: str, p_packed: torch.Tensor, p_range: torch.Tensor,
                 broadcast=_broadcast_heads):
    """Payload-carry probe: the build columns ride the sort as one
    bit-packed 64-bit value; no row-matrix gather. For integer-keyed
    unique builds, inner/left/semi/anti, without matched-build tracking.
    `broadcast` spreads each run's build payload to its lanes:
    _broadcast_heads, or the JAX package's two cummaxes
    (_broadcast_cummax), which give the same output wherever the
    fallback flag is clear."""
    from cockroach_tpu_torch.ops import bitpack
    from cockroach_tpu_torch.ops.join import JoinResult

    build = ub.batch
    dev = probe.device
    lcap, rcap = probe.capacity, build.capacity
    n = lcap + rcap
    packed = torch.cat([ub.packed, p_packed])
    # build lanes carry the packed payload, probe lanes their own lane
    # index (the destination of their result)
    val = torch.cat([ub.payv, torch.arange(lcap, dtype=torch.int64,
                                           device=dev)])
    s_img, perm = torch.sort(_sort_image(packed, ub.narrow), stable=True)
    s_packed = _from_image(s_img, ub.narrow)
    s_val = val[perm]

    pos = torch.arange(n, device=dev)
    prev_packed = torch.cat([s_packed[:1], s_packed[:-1]])
    same_key = (s_packed >> 1) == (prev_packed >> 1)
    newrun = (pos == 0) | ~same_key
    is_build = (s_packed & 1) == 0
    dup = torch.any(is_build & ~newrun)
    pay_wide = ub.pay_plan.total_bits > 62
    fallback = dup | ub.range_flag | p_range | pay_wide

    has_b, bpay = broadcast(s_val, newrun, is_build)
    match_sorted = ~is_build & has_b

    # each probe lane's (payload << 1 | match) back to its probe position;
    # build lanes land in the drop slot lcap
    dest = torch.where(is_build, lcap, s_val)
    res = (bpay << 1) | match_sorted.to(torch.int64)
    o_res = torch.zeros(lcap + 1, dtype=torch.int64, device=dev)
    o_res[dest] = res
    o_res = o_res[:lcap]
    o_match = (o_res & 1) != 0
    o_bpay = srl(o_res, 1)

    match = o_match & _key_live(probe, probe_on)
    if how == "semi":
        return JoinResult(probe.with_sel(probe.sel & match), fallback, None)
    if how == "anti":
        return JoinResult(probe.with_sel(probe.sel & ~match), fallback, None)
    bcols = bitpack.unpack_lanes(o_bpay, ub.pay_plan, build, valid_and=match)
    for pn, bn in zip(probe_on, ub.build_on):
        # the build key equals the probe key on every matched lane
        bdt = build.col(bn).values.dtype
        v = torch.where(match, probe.col(pn).values.to(bdt),
                        torch.zeros((), dtype=bdt, device=dev))
        bcols[bn] = Column(v, match)
    cols = dict(probe.columns)
    cols.update(bcols)
    sel = probe.sel if how == "left" else (probe.sel & match)
    return JoinResult(Batch(cols, sel, sel.sum(dtype=torch.int32)),
                      fallback, None)


def probe_unique(probe: Batch, ub: UniqueBuild, probe_on: Sequence[str],
                 how: str = "inner", track_build: bool = False):
    """Join `probe` against a prepared unique build. Returns a JoinResult
    (ops/join.py) whose batch capacity == probe.capacity (right/outer:
    probe + build capacity). The overflow flag is the fallback signal
    (duplicate build keys, hash collision, int key out of range, a carry
    payload over 62 bits)."""
    from cockroach_tpu_torch.ops.join import JoinResult, _scatter_flags

    build = ub.batch
    dev = probe.device
    if (ub.pay_plan is not None
            and how in ("inner", "left", "semi", "anti")
            and not track_build
            and probe.capacity + build.capacity < (1 << 30)):
        p_packed, p_range = _pack_keys(probe, probe_on, 1, ub.seed,
                                       ub.key_kind, narrow=ub.narrow)
        return _probe_carry(probe, ub, probe_on, how, p_packed, p_range)
    if ub.mat is None:
        # a carry-prepared build on a path that needs the row matrix
        # (matched-build tracking, right/outer): build it here, with the
        # 64-bit keys this path sorts
        mat, plan = pack_rows(build)
        packed64, rflag = _pack_keys(build, ub.build_on, 0, ub.seed,
                                     ub.key_kind)
        ub = ub._replace(mat=mat, plan=plan, packed=packed64,
                         range_flag=rflag, narrow=False)
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
