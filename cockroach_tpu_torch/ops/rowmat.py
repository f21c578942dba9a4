"""Row-matrix packing: move whole rows through gathers as one (cap, W)
int64 matrix instead of per-column arrays.

Counterpart of cockroach_tpu/ops/rowmat.py. Every non-bool column rides
in one int64 lane: integers, dates and dictionary codes as themselves
(sign-extended), float32 as its raw bits (zero-extended), so every round
trip is bit-exact. The last lane packs the booleans: bit 0 is sel, then
bool column values and validities. Bit 63 is int64's sign bit; a bit is
read back as `(mask >> b) & 1`, which the arithmetic shift does not
disturb.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from cockroach_tpu_torch.coldata.batch import Batch, Column

# lane tag of a float column carried as its float32 bits
F32_BITS = "f32bits"


class RowPlan:
    """Host-side layout: which lane/bit each column landed in."""

    def __init__(self, lanes: List[Tuple[str, object]],
                 bool_bits: List[Tuple[str, str]]):
        self.lanes = lanes          # [(name, torch dtype or F32_BITS)]
        self.bool_bits = bool_bits  # [(name, "sel"|"val"|"valid")]

    def bit_index(self, name: str, kind: str) -> Optional[int]:
        for b, (n, k) in enumerate(self.bool_bits):
            if n == name and k == kind:
                return b
        return None


def pack_rows(batch: Batch) -> Tuple[torch.Tensor, RowPlan]:
    """(cap, W) int64 matrix carrying every column of `batch` plus sel.
    W = #non-bool columns + 1 (the packed-boolean lane, last)."""
    lanes: List[Tuple[str, object]] = []
    mats = []
    bool_bits: List[Tuple[str, str]] = [("", "sel")]
    for n, c in batch.columns.items():
        v = c.values
        if v.dtype == torch.bool:
            bool_bits.append((n, "val"))
        else:
            if v.dtype.is_floating_point:
                raw = v.to(torch.float32).view(torch.int32).to(
                    torch.int64) & 0xFFFFFFFF
                lanes.append((n, F32_BITS))
            else:
                raw = v.to(torch.int64)
                lanes.append((n, v.dtype))
            mats.append(raw)
        if c.validity is not None:
            bool_bits.append((n, "valid"))
    assert len(bool_bits) <= 64, "too many boolean bits for one lane"
    mask = torch.zeros(batch.capacity, dtype=torch.int64, device=batch.device)
    for bit, (n, kind) in enumerate(bool_bits):
        src = (batch.sel if kind == "sel" else
               batch.col(n).values if kind == "val" else
               batch.col(n).validity)
        mask = mask | (src.to(torch.int64) << bit)
    mat = torch.stack(mats + [mask], dim=1)
    return mat, RowPlan(lanes, bool_bits)


def unpack_rows(mat: torch.Tensor, plan: RowPlan,
                valid_and: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, Column], torch.Tensor]:
    """Columns + sel back out of (rows, W) matrix rows. `valid_and` (if
    given) is ANDed into sel and every validity, and values on dead rows
    are zeroed — the join's NULL-padding contract (ops/join.py
    _null_columns)."""
    mask = mat[:, -1]

    def bit(name, kind):
        b = plan.bit_index(name, kind)
        if b is None:
            return None
        return ((mask >> b) & 1).to(torch.bool)

    sel = bit("", "sel")
    if valid_and is not None:
        sel = sel & valid_and
    cols: Dict[str, Column] = {}
    for i, (n, dt) in enumerate(plan.lanes):
        v = mat[:, i]
        if dt == F32_BITS:
            v = v.to(torch.int32).view(torch.float32)
        else:
            v = v.to(dt)
        valid = bit(n, "valid")
        if valid_and is not None:
            valid = valid_and if valid is None else (valid & valid_and)
            v = torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
        cols[n] = Column(v, valid)
    for n, kind in plan.bool_bits:
        if kind != "val":
            continue
        v = bit(n, "val")
        valid = bit(n, "valid")
        if valid_and is not None:
            valid = valid_and if valid is None else (valid & valid_and)
            v = v & valid
        cols[n] = Column(v, valid)
    return cols, sel
