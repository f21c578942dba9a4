"""Dynamic lane bit-packing: several narrow columns carried as ONE sort
operand.

Counterpart of cockroach_tpu/ops/bitpack.py (`plan_pack`, `pack_lanes`,
`unpack_lanes`, `overflow_flag`), bit for bit. The packing is dynamic:
each integer column rides biased by its live minimum in
ceil(log2(span + 1)) bits, a float32 column as its raw 32 bits, a bool
as one bit, and a nullable column adds a validity bit below its value.
The widths and offsets are 0-d device tensors, applied with variable
shifts; a payload wider than its budget raises a DEFERRED flag
(`overflow_flag`), never a host read.

The JAX package packs into uint64 lanes. PyTorch has no unsigned 64-bit
arithmetic, so the port carries the same 64 bits in int64 lanes: adds,
left shifts, ands and ors give the same bits, and a logical right shift
is an arithmetic one with the sign-filled bits masked off (`srl`). A
shift by 64 or more gives 0, as XLA's unsigned shifts do. Where the
bits are ordered, ops/hash.py `unsigned_order` gives the unsigned
order.

The MVCC timestamp helpers (`TsOverflow`, `ts_base`, `pack_ts`,
`pack_ts_read`, `pack_ts_arrays`) are the JAX module's, host-side numpy.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column

_BIG = (1 << 62) - 1


class DynPack(NamedTuple):
    """Packing plan for a fixed (static) column list; the numbers are
    device tensors."""

    names: Tuple[str, ...]       # static: packed column order
    kinds: Tuple[str, ...]       # static: "int" | "f32" | "bool"
    nullable: Tuple[bool, ...]   # static: carries a validity bit
    los: torch.Tensor            # (C,) int64 live minima (0 for f32/bool)
    widths: torch.Tensor         # (C,) int32 value bit widths
    offsets: torch.Tensor        # (C,) int32 exclusive bit offsets
    total_bits: torch.Tensor     # 0-d int32 (incl. validity bits)


def srl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits by a host
    int in [0, 64) or a 0-d device tensor `s` (0 for s >= 64)."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    s = s.to(torch.int64)
    sc = s.clamp(0, 63)
    mask = torch.where(sc == 0, -1, (1 << (64 - sc)) - 1)
    return torch.where(s >= 64, 0, (x >> sc) & mask)


def sll(x: torch.Tensor, s) -> torch.Tensor:
    """Left shift by a 0-d device tensor `s` (0 for s >= 64)."""
    s = s.to(torch.int64)
    return torch.where(s >= 64, 0, x << s.clamp(0, 63))


def width_mask(w: torch.Tensor) -> torch.Tensor:
    """The uint64 mask of the low `w` bits, as int64 (all ones for
    w >= 64)."""
    w = w.to(torch.int64)
    return torch.where(w >= 64, -1, (1 << w.clamp(0, 63)) - 1)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """64 - clz(x) of a 0-d int64 holding uint64 bits, as int32."""
    n = torch.zeros_like(x)
    v = x
    for s in (32, 16, 8, 4, 2, 1):
        hit = (v >> s) != 0
        n = n + torch.where(hit, s, 0)
        v = torch.where(hit, v >> s, v)
    n = n + (v != 0).to(torch.int64)
    return torch.where(x < 0, 64, n).to(torch.int32)


def _col_kind(c: Column) -> str:
    dt = c.values.dtype
    if dt == torch.bool:
        return "bool"
    if dt.is_floating_point:
        return "f32" if dt.itemsize <= 4 else "wide"
    if not dt.is_complex:
        return "int"
    return "wide"


def packable(batch: Batch, cols: Sequence[str]) -> bool:
    """Static check: every column's dtype can ride a packed lane."""
    return all(_col_kind(batch.col(n)) != "wide" for n in cols)


def plan_pack(batch: Batch, cols: Sequence[str]) -> DynPack:
    """The packing plan over `batch`'s LIVE lanes."""
    dev = batch.device
    names, kinds, nullable = [], [], []
    los, widths, wids = [], [], []
    live = batch.sel
    for n in cols:
        c = batch.col(n)
        kind = _col_kind(c)
        assert kind != "wide", f"column {n} not packable"
        names.append(n)
        kinds.append(kind)
        nb = c.validity is not None
        nullable.append(nb)
        if kind in ("bool", "f32"):
            lo = torch.zeros((), dtype=torch.int64, device=dev)
            w = torch.full((), 1 if kind == "bool" else 32,
                           dtype=torch.int32, device=dev)
        else:
            v = c.values.to(torch.int64)
            ok = live if c.validity is None else (live & c.validity)
            lo = torch.where(ok, v, _BIG).min()
            hi = torch.where(ok, v, -_BIG - 1).max()
            any_ok = ok.any()
            lo = torch.where(any_ok, lo, 0)
            hi = torch.where(any_ok, hi, 0)
            span = hi - lo  # uint64 bits
            w = torch.where(span == 0, 0, _bit_length(span)).to(torch.int32)
        los.append(lo)
        widths.append(w)
        # the validity bit joins here, as a host constant: no copy
        wids.append(w + 1 if nb else w)
    if not names:  # zero-column payload (COUNT(*)-only aggregates)
        z32 = torch.zeros((0,), dtype=torch.int32, device=dev)
        return DynPack((), (), (), torch.zeros((0,), dtype=torch.int64,
                                               device=dev), z32, z32,
                       torch.zeros((), dtype=torch.int32, device=dev))
    wid = torch.stack(wids)
    offsets = torch.cumsum(wid, 0, dtype=torch.int32) - wid
    return DynPack(tuple(names), tuple(kinds), tuple(nullable),
                   torch.stack(los), torch.stack(widths), offsets,
                   wid.sum(dtype=torch.int32))


def pack_lanes(batch: Batch, plan: DynPack) -> torch.Tensor:
    """(cap,) int64 lanes holding the uint64 packed payload of the planned
    columns. A NULL value packs 0 and a cleared validity bit; dead lanes
    pack garbage the consumer masks by its own liveness."""
    out = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    for i, (n, kind) in enumerate(zip(plan.names, plan.kinds)):
        c = batch.col(n)
        if kind == "bool":
            raw = c.values.to(torch.int64)
        elif kind == "f32":
            raw = c.values.to(torch.float32).view(torch.int32) \
                .to(torch.int64) & 0xFFFFFFFF
        else:
            # masked to the allotted width: values outside [lo, hi] occur
            # only on dead or NULL lanes
            raw = (c.values.to(torch.int64) - plan.los[i]) \
                & width_mask(plan.widths[i])
        if plan.nullable[i]:
            raw = (raw << 1) | c.validity.to(torch.int64)
        out = out | sll(raw, plan.offsets[i])
    return out


def unpack_lanes(packed: torch.Tensor, plan: DynPack, ref: Batch,
                 valid_and=None) -> Dict[str, Column]:
    """Columns back out of packed payloads. `ref` supplies the output
    dtypes. `valid_and` (bool mask) gates validity AND zeroes values on
    dead rows (the join NULL-padding contract)."""
    cols: Dict[str, Column] = {}
    for i, (n, kind) in enumerate(zip(plan.names, plan.kinds)):
        raw = srl(packed, plan.offsets[i])
        validity = None
        if plan.nullable[i]:
            validity = (raw & 1) != 0
            raw = srl(raw, 1)
        raw = raw & width_mask(plan.widths[i])
        dt = ref.col(n).values.dtype
        if kind == "bool":
            v = raw != 0
        elif kind == "f32":
            v = raw.to(torch.int32).view(torch.float32).to(dt)
        else:
            v = (raw + plan.los[i]).to(dt)
        if valid_and is not None:
            v = torch.where(valid_and, v, torch.zeros((), dtype=dt,
                                                      device=v.device))
            validity = (valid_and if validity is None
                        else (validity & valid_and))
        cols[n] = Column(v, validity)
    return cols


def overflow_flag(plan: DynPack, budget: int = 63) -> torch.Tensor:
    """Deferred flag: the packed payload does not fit `budget` bits."""
    return plan.total_bits > budget


# ------------------------------------------------------- HLC timestamps --
#
# The host-side Timestamp.pack() ((wall << 32) | logical) exceeds int64
# for real wall clocks (~2^60 ns shifted by 32), so device-resident MVCC
# version timestamps (storage/resident.py) ride a base-relative pack:
# wall biased by the table's base wall in the high bits, logical in the
# low TS_LOGICAL_BITS — the same bias-by-live-minimum trick DynPack uses
# for int lanes, statically sized so one int64 comparison is the full
# lexicographic (wall, logical) order.

TS_LOGICAL_BITS = 20
TS_WALL_BITS = 62 - TS_LOGICAL_BITS     # packed stays < 2^62 (int64-safe)
_TS_LOGICAL_MAX = (1 << TS_LOGICAL_BITS) - 1
_TS_WALL_SPAN = 1 << TS_WALL_BITS       # ~73 min of ns-resolution wall


class TsOverflow(Exception):
    """A version timestamp does not fit the base-relative pack (wall
    outside [base, base + 2^TS_WALL_BITS) or logical >= 2^TS_LOGICAL_BITS).
    The resident layer degrades to the host-walk tier on this."""


def ts_base(min_wall: int) -> int:
    """The pack base for a table whose smallest version wall is
    `min_wall`: biased low by half the representable span so moderately
    earlier explicit timestamps (tests, imports) still pack."""
    return max(0, int(min_wall) - (_TS_WALL_SPAN >> 1))


def pack_ts(wall: int, logical: int, base: int) -> int:
    """Exact int64 encoding of a VERSION timestamp relative to `base`;
    order-isomorphic to (wall, logical) for every in-range pair. Raises
    TsOverflow out of range."""
    delta = int(wall) - int(base)
    if not (0 <= delta < _TS_WALL_SPAN) or not (
            0 <= int(logical) <= _TS_LOGICAL_MAX):
        raise TsOverflow(
            f"timestamp ({wall},{logical}) outside base={base} pack range")
    return (delta << TS_LOGICAL_BITS) | int(logical)


def pack_ts_read(wall: int, logical: int, base: int) -> int:
    """Encode a READ timestamp for `<=` comparison against packed
    versions. Out-of-range reads clamp to sentinels that preserve the
    comparison outcome exactly, PROVIDED every version packed without
    overflow: a read below the base sees nothing (-1 < every packed
    version), a read past the span sees everything, and a clamped
    logical is >= every in-range logical at the same wall."""
    delta = int(wall) - int(base)
    if delta < 0:
        return -1
    if delta >= _TS_WALL_SPAN:
        return 1 << 62
    return (delta << TS_LOGICAL_BITS) | min(int(logical), _TS_LOGICAL_MAX)


def pack_ts_arrays(walls: np.ndarray, logicals: np.ndarray,
                   base: int) -> np.ndarray:
    """Vectorized pack_ts over version-timestamp arrays (delta ingest
    batches); raises TsOverflow when ANY element is out of range."""
    walls = np.asarray(walls, dtype=np.int64)
    logicals = np.asarray(logicals, dtype=np.int64)
    deltas = walls - np.int64(base)
    if len(walls) and (
            int(deltas.min()) < 0 or int(deltas.max()) >= _TS_WALL_SPAN
            or int(logicals.min()) < 0
            or int(logicals.max()) > _TS_LOGICAL_MAX):
        raise TsOverflow(f"timestamp batch outside base={base} pack range")
    return (deltas << np.int64(TS_LOGICAL_BITS)) | logicals
